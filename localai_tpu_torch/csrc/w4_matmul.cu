// Group-wise int4-weight matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel localai_tpu/ops/qmatmul.py::w4_matmul
// (kernel _w4_kernel). Same math: x [M, K] (bf16 or f32) times an int4
// weight W [K, N] whose scale [K/g, N] holds one f32 per (group of g
// contraction rows, output column); each group's partial dot is taken in
// f32, multiplied by the group's scale, and added to the f32 accumulator;
// one cast to x's dtype at the end.
//
// Weight layout (localai_tpu_torch/ops/qmatmul.py::pack_w4): uint8
// [K/2, N], byte (i, n) holds W[2i, n] in its low nibble and W[2i+1, n]
// in its high nibble, each a signed 4-bit value.
//
// Bound: at decode sizes each weight byte feeds 4*M flops, far below the
// card's ~295 flop/byte ridge — bound by the bytes streamed from device
// memory: (K*N/2 + 4*(K/g)*N + x + out) / 3.35 TB/s. The design reads
// every weight byte once:
//   * one CUDA block per 32 output columns and 8 rows of x; 256 threads,
//     4 along N (8 columns each, one 8-byte load per packed row = 8
//     columns x 2 K rows) and 64 along K;
//   * the K rows go in row blocks of 128 (64 packed rows, one per thread
//     row). g is a multiple of 128, so a row block never straddles a
//     group: every thread keeps its group's partial sums in registers and
//     folds them into the accumulator, times its 8 scales, when the row
//     block that ends a group is done — a condition the whole block
//     shares;
//   * x is staged in shared memory 512 K rows at a time by cp.async,
//     double-buffered, and the nibbles are unpacked in registers with
//     shifts (sign extension by arithmetic right shift);
//   * partial sums are reduced over the K split with warp shuffles and a
//     shared-memory pass. M > 8 takes more blocks along grid.x, the
//     fastest grid axis, so blocks sharing a weight tile run together.
// Not done yet (later work): tensor cores, split-K across blocks, TMA.
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
constexpr int kCols = 8;        // output columns per thread (8-byte load)
constexpr int kTN = 4;          // threads along N
constexpr int kTK = kThreads / kTN;  // 64 threads along K
constexpr int kBN = kCols * kTN;     // 32 output columns per block
constexpr int kRB = 2 * kTK;    // K rows per row block (128)
constexpr int kKC = 512;        // K rows of x staged per chunk
constexpr int kWarps = kThreads / 32;

// signed low / high nibble of byte b (0..3) of a 32-bit word, as float
__device__ __forceinline__ float lo4(uint32_t v, int b) {
  return static_cast<float>(static_cast<int>(v << (28 - 8 * b)) >> 28);
}
__device__ __forceinline__ float hi4(uint32_t v, int b) {
  return static_cast<float>(static_cast<int>(v << (24 - 8 * b)) >> 28);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) w4_kernel(
    const T* __restrict__ x,          // [M, K]
    const uint8_t* __restrict__ q,    // [K/2, N] packed pairs of rows
    const float* __restrict__ scale,  // [K/g, N]
    T* __restrict__ out,              // [M, N]
    int M, int K, int N, int group) {
  __shared__ __align__(16) unsigned char xs_raw[2 * kMT * kKC * sizeof(T)];
  __shared__ float red[kWarps][kMT][kBN];
  const int m0 = blockIdx.x * kMT;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int tn = tid % kTN;
  const int tk = tid / kTN;
  const int col = n0 + tn * kCols;

  float acc[kMT][kCols], part[kMT][kCols];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = part[m][c] = 0.f;

  over_chunks<kMT, kKC>(xs_raw, x, M, K, m0, [&](const T* xs, int kc,
                                                   int kn) {
#pragma unroll 2
    for (int rb = 0; rb < kn; rb += kRB) {
      const int kl = rb + 2 * tk;  // this thread's even K row in the chunk
      const uint2 raw = __ldg(reinterpret_cast<const uint2*>(
          q + (size_t)((kc + kl) / 2) * N + col));
      float x0[kMT], x1[kMT];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        x0[m] = to_f32(xs[m * kKC + kl]);
        x1[m] = to_f32(xs[m * kKC + kl + 1]);
      }
      const uint32_t words[2] = {raw.x, raw.y};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float w0 = lo4(words[c / 4], c % 4);  // row kl
        const float w1 = hi4(words[c / 4], c % 4);  // row kl + 1
#pragma unroll
        for (int m = 0; m < kMT; ++m)
          part[m][c] = fmaf(x1[m], w1, fmaf(x0[m], w0, part[m][c]));
      }
      const int kend = kc + rb + kRB;  // K rows done after this row block
      if (kend % group == 0) {         // a group ends: fold its scale in
        const float* srow = scale + (size_t)(kend / group - 1) * N + col;
        const float4 s0 = __ldg(reinterpret_cast<const float4*>(srow));
        const float4 s1 = __ldg(reinterpret_cast<const float4*>(srow + 4));
        const float sv[kCols] = {s0.x, s0.y, s0.z, s0.w,
                                 s1.x, s1.y, s1.z, s1.w};
#pragma unroll
        for (int m = 0; m < kMT; ++m)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc[m][c] = fmaf(part[m][c], sv[c], acc[m][c]);
            part[m][c] = 0.f;
          }
      }
    }
  });

  // reduce over the K split: lanes of one warp that share tn, then warps
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
    out[(size_t)(m0 + m) * N + n0 + c] = from_f32<T>(s);
  }
}

template <typename T>
int launch(const void* x, const void* q, const void* scale, void* out, int M,
           int K, int N, int group, cudaStream_t stream) {
  dim3 grid((M + kMT - 1) / kMT, N / kBN);
  w4_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale), static_cast<T*>(out), M, K, N, group);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 on success, a cudaError_t after a failed launch, or -1 for a
// shape the kernel does not take (the wrapper gates K, N and the group at
// multiples of 128).
extern "C" int w4_matmul(const void* x, const void* q, const void* scale,
                         void* out, int M, int K, int N, int group,
                         int is_bf16, void* stream) {
  if (M <= 0 || K % 128 || N % 128 || group <= 0 || group % 128 ||
      K % group)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, q, scale, out, M, K, N, group, st);
  return launch<float>(x, q, scale, out, M, K, N, group, st);
}
