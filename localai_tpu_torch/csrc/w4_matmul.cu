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
// Bound: at decode sizes (M = 8) each weight byte feeds 4*M flops, far
// below the card's ~295 flop/byte ridge, so the kernel is bound by the
// bytes it streams: (K*N/2 + 4*(K/g)*N + x + out) / 3.35 TB/s; at M = 256
// it nears the tensor cores' rate.
//
// bf16 x: the tensor-core tile of qmm_mma.cuh (mma.sync m16n8k16, the
// weight on the 16-row side so M = 8 fills the 8-column side). One byte
// of pack_w4's layout is exactly the (2i, 2i+1) K pair of one A fragment
// register, so a thread's fragments come from two 8-byte shared-memory
// reads per k16 step and dequantize with the magic-exponent trick
// (i4x2_to_bf16x2), no I2F. Each group's k16 steps accumulate in a
// partial fragment that is folded into the accumulator times the group's
// scale row at the group's end, the Pallas kernel's order; splits of K
// fall on group edges (ops/qmatmul.py::qmm_split_plan) and are folded in
// split order by a second launch.
//
// f32 x (the parity dtype, held to 1e-4, which bf16 inputs would break)
// keeps the CUDA-core kernel below: one CUDA block per 32 output columns
// and 8 rows of x, 256 threads (4 along N, 8 columns each from one 8-byte
// load per packed row; 64 along K), x staged by double-buffered cp.async,
// nibbles unpacked with shifts, partial sums folded per group, then
// reduced over the K split with warp shuffles and shared memory.
//
// Plain C interface (bound with ctypes); launches on the caller's stream
// and returns cudaGetLastError() after each launch.

#include "common.cuh"
#include "qmm_mma.cuh"

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

  over_chunks<kMT, kKC>(xs_raw, x, M, K, K, m0, [&](const T* xs, int kc,
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

int launch_f32(const void* x, const void* q, const void* scale, void* out,
               int M, int K, int N, int group, cudaStream_t stream) {
  dim3 grid((M + kMT - 1) / kMT, N / kBN);
  w4_kernel<float><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale), static_cast<float*>(out), M, K, N,
      group);
  return (int)cudaGetLastError();
}

namespace qmm = localai::qmm;
using qmm::i4x2_to_bf16x2;

// K5's weight policy for the tile walk (qmm_mma.cuh)
struct W4 {
  static constexpr int kRows = qmm::kBK / 2;  // packed rows per stage
  // a warp reads packed rows tig = 0..3 together: 32 bytes apart in banks
  static constexpr int kStride = qmm::kBN + 32;
  static constexpr int kWBytes = kRows * kStride;
  static constexpr int kXStride = qmm::kXStrideLdm;
  static constexpr int kStages = 4;
  static constexpr bool kGrouped = true;
  __device__ static void stage_w(unsigned char* s, const uint8_t* q, int K,
                                 int N, int n0, int k0, int tid) {
    qmm::stage_kn<kRows, kStride>(s, q, N, n0, k0 / 2, tid);
  }
  // k16 step jj + H: K rows 2 tig, 2 tig + 1 are packed row 8 step + tig
  // (a0, a1), rows 2 tig + 8, + 9 packed row 8 step + tig + 4 (a2, a3);
  // byte 2t of the thread's 8 columns is A row g of tile t, 2t + 1 row
  // g + 8
  template <int H>
  __device__ static void load_a(const unsigned char* ws, int jj, int tig,
                                int col, uint32_t (&a)[4][4]) {
    const int r = 8 * (jj + H) + tig;
    const uint2 lo = *reinterpret_cast<const uint2*>(ws + r * kStride + col);
    const uint2 hi =
        *reinterpret_cast<const uint2*>(ws + (r + 4) * kStride + col);
    const uint32_t w[4] = {lo.x, lo.y, hi.x, hi.y};
    const uint32_t w4[4] = {lo.x >> 4, lo.y >> 4, hi.x >> 4, hi.y >> 4};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      // tile t's bytes 2t, 2t + 1 sit in word t / 2 at bytes 2(t % 2), + 1
      const int i = t / 2;
      if (t % 2 == 0) {
        a[t][0] = i4x2_to_bf16x2<0>(w[i], w4[i]);
        a[t][1] = i4x2_to_bf16x2<1>(w[i], w4[i]);
        a[t][2] = i4x2_to_bf16x2<0>(w[i + 2], w4[i + 2]);
        a[t][3] = i4x2_to_bf16x2<1>(w[i + 2], w4[i + 2]);
      } else {
        a[t][0] = i4x2_to_bf16x2<2>(w[i], w4[i]);
        a[t][1] = i4x2_to_bf16x2<3>(w[i], w4[i]);
        a[t][2] = i4x2_to_bf16x2<2>(w[i + 2], w4[i + 2]);
        a[t][3] = i4x2_to_bf16x2<3>(w[i + 2], w4[i + 2]);
      }
    }
  }
  template <int MI>
  __device__ static void frags(const unsigned char* ws,
                               const __nv_bfloat16* xs, int jj, int lane,
                               int col, uint32_t (&a)[2][4][4],
                               uint32_t (&b)[MI][4]) {
    qmm::ldmatrix_b<MI>(xs, jj, lane, b);
    load_a<0>(ws, jj, lane % 4, col, a[0]);
    load_a<1>(ws, jj, lane % 4, col, a[1]);
  }
};

}  // namespace

// Returns 0 on success, a cudaError_t after a failed launch, or -1 for a
// shape the kernels do not take (the wrapper gates K, N and the group at
// multiples of 128 and gives the bf16 path its plan: mi n8 tiles of x per
// CTA (1, 2 or 4), splits of split_k K rows, and an f32 scratch
// [splits, M, N] when splits > 1; the f32 path ignores the plan).
extern "C" int w4_matmul(const void* x, const void* q, const void* scale,
                         void* out, void* partial, int M, int K, int N,
                         int group, int is_bf16, int mi, int splits,
                         int split_k, void* stream) {
  if (M <= 0 || K % 128 || N % 128 || group <= 0 || group % 128 ||
      K % group)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return launch_f32(x, q, scale, out, M, K, N, group, st);
  if (!qmm::plan_ok(M, K, N, group, splits, split_k, partial)) return -1;
  const qmm::Batch b = qmm::dense(K, N);
  switch (mi) {
    case 1:
      return qmm::launch_tiles<W4, 1>(x, q, scale, out, partial, M, K, N,
                                      group, splits, split_k, b, st);
    case 2:
      return qmm::launch_tiles<W4, 2>(x, q, scale, out, partial, M, K, N,
                                      group, splits, split_k, b, st);
    case 4:
      return qmm::launch_tiles<W4, 4>(x, q, scale, out, partial, M, K, N,
                                      group, splits, split_k, b, st);
  }
  return -1;
}
