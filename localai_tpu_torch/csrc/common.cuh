// Helpers shared by the port's CUDA kernels (included by each .cu; the
// build hashes this header with every source, so an edit rebuilds all).
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace localai {

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The quantized matmuls stage MT rows of x [M, K] (rows ldx elements
// apart in device memory) in shared memory, KC columns at a time, as
// xs[m][k] with row stride KC.

// Start the async copy of x rows [m0, m0 + MT) x columns [kc, kc + kn)
// into xs, zero-filled for rows past M, as one committed cp.async group.
// kn is a multiple of 16 bytes' worth of elements (K % 128 == 0), and so
// is ldx.
template <int MT, int KC, typename T>
__device__ __forceinline__ void stage_x(T* xs, const T* x, int M, int ldx,
                                        int m0, int kc, int kn) {
  constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16-byte copy
  const int per_row = kn / kVec;
  for (int e = threadIdx.x; e < MT * per_row; e += blockDim.x) {
    const int m = e / per_row, c = e - m * per_row;
    const bool live = m0 + m < M;
    const T* src = live ? x + (size_t)(m0 + m) * ldx + kc + c * kVec : x;
    __pipeline_memcpy_async(xs + m * KC + c * kVec, src, 16, live ? 0 : 16);
  }
  __pipeline_commit();
}

// Walk K in chunks of KC with x double-buffered in shared memory (raw
// holds 2 * MT * KC elements of T): the copy of chunk c + 1 is in flight
// while body(xs, kc, kn) consumes chunk c = [kc, kc + kn). Every thread of
// the block must call it.
template <int MT, int KC, typename T, typename Body>
__device__ __forceinline__ void over_chunks(unsigned char* raw, const T* x,
                                            int M, int K, int ldx, int m0,
                                            Body body) {
  T* const xs0 = reinterpret_cast<T*>(raw);
  T* const xs1 = xs0 + MT * KC;
  const int nchunks = (K + KC - 1) / KC;
  stage_x<MT, KC>(xs0, x, M, ldx, m0, 0, min(KC, K));
  for (int ci = 0; ci < nchunks; ++ci) {
    const int kc = ci * KC;
    if (ci + 1 < nchunks) {
      stage_x<MT, KC>((ci & 1) ? xs0 : xs1, x, M, ldx, m0, kc + KC,
                      min(KC, K - kc - KC));
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    body((ci & 1) ? xs1 : xs0, kc, min(KC, K - kc));
    __syncthreads();  // the next stage_x overwrites this buffer
  }
}

}  // namespace localai
