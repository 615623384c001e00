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
// 3.35 TB/s; at M = 256 it nears the tensor cores' rate.
//   * bf16 x, q [K, N]: the tensor-core tile of qmm_mma.cuh (mma.sync
//     m16n8k16, the weight on the 16-row side so M = 8 fills the 8-column
//     side), 128 K rows of weight and x per cp.async stage, 3 stages.
//     An A register holds K rows (2i, 2i + 1) of one column: two bytes
//     from two staged rows, dequantized exactly through the f32 mantissa
//     (i8x2_to_bf16x2, no I2F). The f32 accumulator takes scale[n] in the
//     epilogue; splits of K on 128-row edges (ops/qmatmul.py::
//     qmm_split_plan) are folded in split order, then scaled, by a second
//     launch.
//   * bf16 x, q [N, K]: the same tile; each output column is a table row,
//     contiguous in K, so a stage holds 128 rows x 128 K bytes (16-byte
//     chunks swizzled against bank conflicts) and K is ordered inside two
//     k16 steps so that one 8-byte read per row and one 16-byte read per
//     x row give both steps' fragments (policy W8T below).
//   * f32 x (the parity dtype: its 1e-4 tolerance rules out bf16 inputs)
//     keeps the CUDA-core kernels. q [K, N]: one CUDA block per 32 output
//     columns and 8 rows of x; 256 threads split K (128 thread rows) and
//     own 16 columns each, one 16-byte load per K row; x staged in shared
//     memory by double-buffered cp.async; warp-shuffle and shared-memory
//     reduction, then scaled and cast. q [N, K]: one warp per 4 output
//     columns reads the 4 contiguous rows with 4-byte loads along K (x
//     staged the same way), a warp reduction at the end.
//
// Experts (w8_matmul_experts): the expert products of a sparse-MoE layer,
// x [M, K] or [M, E, K] times an int8 stack q [E, K, N] with scale [E, N]
// -> out [M, E, N], in ONE launch: the expert is on the grid's z axis
// (qmm::Batch: per-expert offsets of x, q, scale and out, and row strides
// of x and out), so a layer's gate, up and down projections are three
// launches whatever E is. An up projection reads the same x rows for
// every expert (x offset 0); a down projection reads expert e's own rows
// x[:, e]. The JAX package computes these products as XLA einsums over
// the dequantized stack (localai_tpu/models/quant.py moe_up / moe_down);
// the bound is the same as K4's, the E * K * N weight bytes. At
// Mixtral-8x7B's widths (D 4096, F 14336, E 8) a decode layer streams
// 1.409 GB of experts.
//
// Plain C interface (bound with ctypes); launches on the caller's stream
// and returns cudaGetLastError() after each launch.

#include "common.cuh"
#include "qmm_mma.cuh"

namespace {

namespace qmm = localai::qmm;
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
    const T* __restrict__ x,          // [M, K], rows b.ldx apart
    const int8_t* __restrict__ q,     // [K, N]
    const float* __restrict__ scale,  // [N]
    T* __restrict__ out,              // [M, N], rows b.ldo apart
    int M, int K, int N, qmm::Batch b) {
  __shared__ __align__(16) unsigned char xs_raw[2 * kMT * kKC * sizeof(T)];
  __shared__ float red[kWarps][kMT][kBN];
  const int ex = blockIdx.z;  // the expert of a batch (0: a plain product)
  x += ex * b.sx, q += ex * b.sq, scale += ex * b.ss, out += ex * b.so;
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

  over_chunks<kMT, kKC>(xs_raw, x, M, K, b.ldx, m0,
                        [&](const T* xs, int kc, int kn) {
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
    out[(size_t)(m0 + m) * b.ldo + n] = from_f32<T>(s * scale[n]);
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

  over_chunks<kMT, kKC>(xs_raw, x, M, K, K, m0,
                        [&](const T* xs, int kc, int kn) {
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
           int K, int N, int transpose_w, const qmm::Batch& b,
           cudaStream_t stream) {
  const int mb = (M + kMT - 1) / kMT;
  if (transpose_w) {
    const int cols = (kThreadsT / 32) * kColsT;
    dim3 grid(mb, (N + cols - 1) / cols);
    w8_nk_kernel<T><<<grid, kThreadsT, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<T*>(out), M, K, N);
  } else {
    dim3 grid(mb, N / kBN, b.E);
    w8_kn_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<T*>(out), M, K, N, b);
  }
  return (int)cudaGetLastError();
}

using qmm::i8x2_to_bf16x2;

// K4's weight policy for the tile walk (qmm_mma.cuh)
struct W8 {
  static constexpr int kRows = qmm::kBK;  // int8 rows per stage
  // a warp reads rows 2 tig = 0, 2, 4, 6 together: 32 bytes apart in banks
  static constexpr int kStride = qmm::kBN + 16;
  static constexpr int kWBytes = kRows * kStride;
  static constexpr int kXStride = qmm::kXStrideLdm;
  static constexpr int kStages = 3;
  static constexpr bool kGrouped = false;
  __device__ static void stage_w(unsigned char* s, const uint8_t* q, int K,
                                 int N, int n0, int k0, int tid) {
    qmm::stage_kn<kRows, kStride>(s, q, N, n0, k0, tid);
  }
  // k16 step jj + H: a0/a1 hold K rows (2 tig, 2 tig + 1), a2/a3 rows
  // (2 tig + 8, + 9); byte 2t of the thread's 8 columns is A row g of
  // tile t, 2t + 1 row g + 8
  template <int H>
  __device__ static void load_a(const unsigned char* ws, int jj, int tig,
                                int col, uint32_t (&a)[4][4]) {
    const unsigned char* p = ws + (16 * (jj + H) + 2 * tig) * kStride + col;
    uint2 r[4];  // K rows +0, +1, +8, +9, as offset binary
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r[i] = *reinterpret_cast<const uint2*>(p + ((i & 1) + 8 * (i >> 1)) *
                                                     kStride);
      r[i].x ^= 0x80808080u, r[i].y ^= 0x80808080u;
    }
    a[0][0] = i8x2_to_bf16x2<0>(r[0].x, r[1].x);
    a[0][1] = i8x2_to_bf16x2<1>(r[0].x, r[1].x);
    a[0][2] = i8x2_to_bf16x2<0>(r[2].x, r[3].x);
    a[0][3] = i8x2_to_bf16x2<1>(r[2].x, r[3].x);
    a[1][0] = i8x2_to_bf16x2<2>(r[0].x, r[1].x);
    a[1][1] = i8x2_to_bf16x2<3>(r[0].x, r[1].x);
    a[1][2] = i8x2_to_bf16x2<2>(r[2].x, r[3].x);
    a[1][3] = i8x2_to_bf16x2<3>(r[2].x, r[3].x);
    a[2][0] = i8x2_to_bf16x2<0>(r[0].y, r[1].y);
    a[2][1] = i8x2_to_bf16x2<1>(r[0].y, r[1].y);
    a[2][2] = i8x2_to_bf16x2<0>(r[2].y, r[3].y);
    a[2][3] = i8x2_to_bf16x2<1>(r[2].y, r[3].y);
    a[3][0] = i8x2_to_bf16x2<2>(r[0].y, r[1].y);
    a[3][1] = i8x2_to_bf16x2<3>(r[0].y, r[1].y);
    a[3][2] = i8x2_to_bf16x2<2>(r[2].y, r[3].y);
    a[3][3] = i8x2_to_bf16x2<3>(r[2].y, r[3].y);
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

// K4's policy for the tied lm_head table q [N, K]: each output column is
// a table row, so A's rows are contiguous in K. A stage holds the CTA's
// 128 rows x 128 K bytes, 16-byte chunk c of row r stored at chunk
// c ^ ((2 (r / 8)) % 8), so the 4 row groups a half-warp reads together
// fall on distinct banks. Inside each 32-element span of two k16 steps
// thread tig takes K elements 8 tig .. 8 tig + 7 (step jj the first 4,
// jj + 1 the last 4) from both operands: one 8-byte read per table row
// and one 16-byte read of each x row give both steps' fragments. x rows
// are staged 32 elements wider, so the 16-byte reads of 8 lanes (two x
// rows) fall on distinct banks.
struct W8T {
  static constexpr int kWBytes = qmm::kBN * qmm::kBK;
  static constexpr int kXStride = qmm::kBK + 32;
  static constexpr int kStages = 3;
  static constexpr bool kGrouped = false;
  __device__ static int swz(int r) { return (2 * (r >> 3)) & 7; }
  __device__ static void stage_w(unsigned char* s, const uint8_t* q, int K,
                                 int N, int n0, int k0, int tid) {
    for (int e = tid; e < qmm::kBN * (qmm::kBK / 16); e += qmm::kThreads) {
      const int r = e / (qmm::kBK / 16), c = e % (qmm::kBK / 16);
      qmm::cp_async16(s + r * qmm::kBK + (c ^ swz(r)) * 16,
                      q + (size_t)(n0 + r) * K + k0 + c * 16, true);
    }
  }
  template <int MI>
  __device__ static void frags(const unsigned char* ws,
                               const __nv_bfloat16* xs, int jj, int lane,
                               int col, uint32_t (&a)[2][4][4],
                               uint32_t (&b)[MI][4]) {
    const int g = lane / 4, tig = lane % 4, span = jj / 2;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          xs + (mi * 8 + g) * kXStride + 32 * span + 8 * tig);
      b[mi][0] = v.x, b[mi][1] = v.y, b[mi][2] = v.z, b[mi][3] = v.w;
    }
    uint2 w[8];  // table rows col + j: A row g (j = 2t) or g + 8 (2t + 1)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = col + j;
      w[j] = *reinterpret_cast<const uint2*>(
          ws + r * qmm::kBK + (((2 * span + (tig >> 1)) ^ swz(r)) * 16) +
          8 * (tig & 1));
      w[j].x ^= 0x80808080u, w[j].y ^= 0x80808080u;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      // step jj: K elements 0, 1 (a0, a1) and 2, 3 (a2, a3); jj + 1: 4-7
      a[0][t][0] = i8x2_to_bf16x2<0, 1>(w[2 * t].x, w[2 * t].x);
      a[0][t][1] = i8x2_to_bf16x2<0, 1>(w[2 * t + 1].x, w[2 * t + 1].x);
      a[0][t][2] = i8x2_to_bf16x2<2, 3>(w[2 * t].x, w[2 * t].x);
      a[0][t][3] = i8x2_to_bf16x2<2, 3>(w[2 * t + 1].x, w[2 * t + 1].x);
      a[1][t][0] = i8x2_to_bf16x2<0, 1>(w[2 * t].y, w[2 * t].y);
      a[1][t][1] = i8x2_to_bf16x2<0, 1>(w[2 * t + 1].y, w[2 * t + 1].y);
      a[1][t][2] = i8x2_to_bf16x2<2, 3>(w[2 * t].y, w[2 * t].y);
      a[1][t][3] = i8x2_to_bf16x2<2, 3>(w[2 * t + 1].y, w[2 * t + 1].y);
    }
  }
};

template <class P>
int launch_tiles(const void* x, const void* q, const void* scale, void* out,
                 void* partial, int M, int K, int N, int mi, int splits,
                 int split_k, const qmm::Batch& b, cudaStream_t st) {
  const int group = qmm::kBK;  // no groups: splits on stage edges
  if (!qmm::plan_ok(M, K, N, group, splits, split_k, partial)) return -1;
  switch (mi) {
    case 1:
      return qmm::launch_tiles<P, 1>(x, q, scale, out, partial, M, K, N,
                                     group, splits, split_k, b, st);
    case 2:
      return qmm::launch_tiles<P, 2>(x, q, scale, out, partial, M, K, N,
                                     group, splits, split_k, b, st);
    case 4:
      return qmm::launch_tiles<P, 4>(x, q, scale, out, partial, M, K, N,
                                     group, splits, split_k, b, st);
  }
  return -1;
}

}  // namespace

// Returns 0 on success, a cudaError_t after a failed launch, or -1 for a
// shape the kernels do not take (the wrapper gates K % 128 == 0 and
// N % 128 == 0, and gives the bf16 paths their plan: mi n8 tiles of x per
// CTA (1, 2 or 4), splits of split_k K rows, and an f32 scratch
// [splits, M, N] when splits > 1; the f32 paths ignore the plan).
extern "C" int w8_matmul(const void* x, const void* q, const void* scale,
                         void* out, void* partial, int M, int K, int N,
                         int transpose_w, int is_bf16, int mi, int splits,
                         int split_k, void* stream) {
  if (M <= 0 || K % 128 || N % 128) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const qmm::Batch b = qmm::dense(K, N);
  if (is_bf16 && transpose_w)
    return launch_tiles<W8T>(x, q, scale, out, partial, M, K, N, mi, splits,
                             split_k, b, st);
  if (is_bf16)
    return launch_tiles<W8>(x, q, scale, out, partial, M, K, N, mi, splits,
                            split_k, b, st);
  return launch<float>(x, q, scale, out, M, K, N, transpose_w, b, st);
}

// The E expert products of one MoE projection in one launch:
// out[m, e, :] = (x_e[m, :] @ q[e]) * scale[e], x_e = x[m, :] when
// shared_x (every expert reads the same rows, x [M, K]) else x[m, e, :]
// (x [M, E, K]); q [E, K, N] int8, scale [E, N], out [M, E, N]. The plan
// (mi, splits, split_k) and the scratch [E, splits, M, N] are as for
// w8_matmul, the split plan counting E times the column tiles. Returns 0,
// a cudaError_t, or -1 for a shape the kernels do not take.
extern "C" int w8_matmul_experts(const void* x, const void* q,
                                 const void* scale, void* out, void* partial,
                                 int M, int K, int N, int E, int shared_x,
                                 int is_bf16, int mi, int splits,
                                 int split_k, void* stream) {
  if (M <= 0 || E <= 0 || K % 128 || N % 128) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const qmm::Batch b{E,
                     shared_x ? K : E * K,
                     E * N,
                     shared_x ? 0LL : (long long)K,
                     (long long)K * N,
                     (long long)N,
                     (long long)N};
  if (is_bf16)
    return launch_tiles<W8>(x, q, scale, out, partial, M, K, N, mi, splits,
                            split_k, b, st);
  return launch<float>(x, q, scale, out, M, K, N, 0, b, st);
}
