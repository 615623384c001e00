// int8-weight matmul for Hopper (sm_90a): y = (x @ q) * scale.
//
// Replaces the Pallas TPU kernel localai_tpu/ops/qmatmul.py::w8_matmul
// (kernel _kernel). Same math: x [M, K] (bf16 or f32) times an int8
// weight, products accumulated in f32, the per-output-channel f32 scale
// applied to the f32 accumulator, then one cast to x's dtype.
//   * q [K, N] (a projection): out[m, n] = scale[n] * sum_k x[m,k] q[k,n]
//   * q [N, K] (transpose_w, the tied lm_head table): x @ q.T
//
// Bound: at decode sizes (M = 8 slots) each weight byte feeds 2*M flops,
// far below the card's ~295 flop/byte ridge — the kernel is bound by the
// weight bytes it streams from device memory: (K*N + 4N + x + out) /
// 3.35 TB/s. The design reads every weight byte from memory once:
//   * [K, N]: one CUDA block per 32 output columns and 8 rows of x; its
//     256 threads split K (128 thread rows, interleaved) and each thread
//     owns 16 columns, read as one 16-byte load per K row. x is staged in
//     shared memory 512 K rows at a time by cp.async, double-buffered, so
//     the next chunk's copy is in flight while this one is used and no
//     thread waits on x's loads. Partial sums are reduced over the K
//     split with warp shuffles and a shared-memory pass, then scaled and
//     cast. M > 8 takes more blocks along grid.x, the fastest grid axis,
//     so blocks that share a weight tile run together and re-read it from
//     L2.
//   * [N, K]: one warp per 4 output columns reads the 4 contiguous rows
//     with 4-byte loads along K (x staged the same way), a warp reduction
//     at the end.
// Not done yet (later work): tensor cores (mma/wgmma) for M >= 16, a split
// of K across blocks for narrow N (a 1024-column weight gives 32 blocks
// on 132 SMs), TMA.
//
// Plain C interface (bound with ctypes); launches on the caller's stream
// and returns cudaGetLastError() after the launch.

#include "common.cuh"

namespace {

using localai::from_f32;
using localai::over_chunks;
using localai::to_f32;

constexpr int kMT = 8;          // rows of x per CUDA block
constexpr int kThreads = 256;
constexpr int kCols = 16;       // output columns per thread (16-byte load)
constexpr int kTN = 2;          // threads along N
constexpr int kTK = kThreads / kTN;  // 128 threads along K
constexpr int kBN = kCols * kTN;     // 32 output columns per block
constexpr int kKC = 512;        // K rows of x staged per chunk
constexpr int kWarps = kThreads / 32;

constexpr int kThreadsT = 256;  // transposed kernel: 8 warps
constexpr int kColsT = 4;       // output columns per warp

// signed byte b (0..3) of a 32-bit word, as float
__device__ __forceinline__ float s8(uint32_t v, int b) {
  return static_cast<float>(static_cast<int>(v << (24 - 8 * b)) >> 24);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) w8_kn_kernel(
    const T* __restrict__ x,          // [M, K]
    const int8_t* __restrict__ q,     // [K, N]
    const float* __restrict__ scale,  // [N]
    T* __restrict__ out,              // [M, N]
    int M, int K, int N) {
  __shared__ __align__(16) unsigned char xs_raw[2 * kMT * kKC * sizeof(T)];
  __shared__ float red[kWarps][kMT][kBN];
  const int m0 = blockIdx.x * kMT;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int tn = tid % kTN;
  const int tk = tid / kTN;
  const int col = n0 + tn * kCols;

  float acc[kMT][kCols];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;

  over_chunks<kMT, kKC>(xs_raw, x, M, K, m0, [&](const T* xs, int kc, int kn) {
#pragma unroll 4
    for (int k = tk; k < kn; k += kTK) {
      const uint4 raw =
          __ldg(reinterpret_cast<const uint4*>(q + (size_t)(kc + k) * N + col));
      float xv[kMT];
#pragma unroll
      for (int m = 0; m < kMT; ++m) xv[m] = to_f32(xs[m * kKC + k]);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float w = s8(words[c / 4], c % 4);
#pragma unroll
        for (int m = 0; m < kMT; ++m) acc[m][c] = fmaf(xv[m], w, acc[m][c]);
      }
    }
  });

  // reduce over the K split: lanes of one warp that share tn (lane bits
  // above the tn bit), then the warps through shared memory
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float v = acc[m][c];
#pragma unroll
      for (int o = kTN; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      acc[m][c] = v;
    }
  if (lane < kTN) {
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int c = 0; c < kCols; ++c) red[warp][m][lane * kCols + c] = acc[m][c];
  }
  __syncthreads();
  for (int o = tid; o < kMT * kBN; o += kThreads) {
    const int m = o / kBN, c = o % kBN;
    if (m0 + m >= M) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][m][c];
    const int n = n0 + c;
    out[(size_t)(m0 + m) * N + n] = from_f32<T>(s * scale[n]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreadsT) w8_nk_kernel(
    const T* __restrict__ x,          // [M, K]
    const int8_t* __restrict__ q,     // [N, K]
    const float* __restrict__ scale,  // [N]
    T* __restrict__ out,              // [M, N]
    int M, int K, int N) {
  __shared__ __align__(16) unsigned char xs_raw[2 * kMT * kKC * sizeof(T)];
  const int m0 = blockIdx.x * kMT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = (blockIdx.y * (kThreadsT / 32) + warp) * kColsT;

  float acc[kColsT][kMT];
#pragma unroll
  for (int j = 0; j < kColsT; ++j)
#pragma unroll
    for (int m = 0; m < kMT; ++m) acc[j][m] = 0.f;

  over_chunks<kMT, kKC>(xs_raw, x, M, K, m0, [&](const T* xs, int kc, int kn) {
    if (n0 >= N) return;
    for (int k = 4 * lane; k < kn; k += 128) {
      float xv[kMT][4];
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[m][i] = to_f32(xs[m * kKC + k + i]);
#pragma unroll
      for (int j = 0; j < kColsT; ++j) {
        const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(
            q + (size_t)(n0 + j) * K + kc + k));
        const float w0 = s8(w, 0), w1 = s8(w, 1), w2 = s8(w, 2), w3 = s8(w, 3);
#pragma unroll
        for (int m = 0; m < kMT; ++m)
          acc[j][m] += xv[m][0] * w0 + xv[m][1] * w1 + xv[m][2] * w2 +
                       xv[m][3] * w3;
      }
    }
  });
  if (n0 >= N) return;
#pragma unroll
  for (int j = 0; j < kColsT; ++j)
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      float v = acc[j][m];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      acc[j][m] = v;
    }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kColsT; ++j)
#pragma unroll
      for (int m = 0; m < kMT; ++m)
        if (m0 + m < M)
          out[(size_t)(m0 + m) * N + n0 + j] =
              from_f32<T>(acc[j][m] * scale[n0 + j]);
  }
}

template <typename T>
int launch(const void* x, const void* q, const void* scale, void* out, int M,
           int K, int N, int transpose_w, cudaStream_t stream) {
  const int mb = (M + kMT - 1) / kMT;
  if (transpose_w) {
    const int cols = (kThreadsT / 32) * kColsT;
    dim3 grid(mb, (N + cols - 1) / cols);
    w8_nk_kernel<T><<<grid, kThreadsT, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<T*>(out), M, K, N);
  } else {
    dim3 grid(mb, N / kBN);
    w8_kn_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<T*>(out), M, K, N);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 on success, a cudaError_t after a failed launch, or -1 for a
// shape the kernel does not take (the wrapper gates K % 128 == 0 and
// N % 128 == 0).
extern "C" int w8_matmul(const void* x, const void* q, const void* scale,
                         void* out, int M, int K, int N, int transpose_w,
                         int is_bf16, void* stream) {
  if (M <= 0 || K % 128 || N % 128) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, q, scale, out, M, K, N, transpose_w, st);
  return launch<float>(x, q, scale, out, M, K, N, transpose_w, st);
}
