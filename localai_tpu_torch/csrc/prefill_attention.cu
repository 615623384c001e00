// Causal GQA prefill attention for Hopper (sm_90a), one sequence.
//
// Replaces the Pallas TPU kernel localai_tpu/ops/attention.py::
// prefill_attention (kernel _prefill_kernel, loop _flash_loop) for bf16
// and f32. q is [T, Hq, hd], k and v head-major [Hkv, T, hd]; the output is
// [T, Hq, hd]. Same math: q pre-scaled by hd^-0.5 in f32; the rows of a
// CUDA block are (query position x GQA group) pairs, as in the Pallas
// kernel; key kj is kept for the row at position t when kj <= t,
// kj < length and kj > t - window, with a -1e30 fill and an f32 online
// softmax; the result is acc / max(l, 1e-30). A block walks key tiles
// from the window's first tile to min(causal frontier, length), and at
// least one tile, as the Pallas kernel does. Rows t >= length attend to
// every real key <= t (the JAX prefill_mask's rows).
//
// Bound: operations. A causal T-token prompt does ~2 * 2 * hd * T^2 / 2
// flops per query head (about 137 GFLOP a layer at T=4096 and Llama-3-8B
// widths) over O(T * hd) bytes, far above the card's flop/byte ridge.
//
// Design: one CUDA block per (kv head, tile of rows/G query positions), so
// all the block's rows share every K/V tile they read; 64-key K and V
// tiles are staged by double-buffered cp.async (the copy of tile i+1 is in
// flight while tile i is folded), rows padded by 16 bytes against bank
// conflicts and zero-filled past T.
//   * bf16: tensor cores, mma.sync.m16n8k16 (bf16 in, f32 accumulate).
//     Four warps a block, each of 32 rows (128 rows a block), or of 16
//     (64 rows) where a shape-only host plan finds too few 128-row blocks
//     to keep two on every SM (short prompts, embedding inputs). A warp
//     computes its 32x64 (16x64) score tile, runs the online softmax on
//     the accumulator fragments (row max and sum across the four threads
//     of a quad) in the log2 domain (one FFMA and one ex2 per score), and
//     multiplies the probabilities, rounded to bf16 as the A operand, by
//     V with the same instruction; the denominator takes the f32
//     probabilities. What feeds the tensor cores:
//       - every fragment comes from one ldmatrix.x4 (q and K as staged, V
//         through .trans), bank-conflict free on the padded rows;
//       - at 32 rows a warp each K/V fragment feeds four mma, so a
//         128-row tile reads 160 KB of shared memory where 16 rows a warp
//         read 256 KB, which on the card set the pace;
//       - K and V of a tile are separate commit groups, so the scores
//         start when K has landed, with V in flight;
//       - the per-element mask runs only on tiles that cross the causal
//         diagonal, the window's edge or length;
//       - the blocks with the longest causal walks launch first, so they
//         do not form the tail of the grid.
//   * f32: CUDA cores (no tensor-core type keeps f32 products exact). 256
//     threads, 64 rows a block; the block's q rows sit in shared memory in
//     f32; each thread owns a 4x4 block of the 64x64 score tile and a
//     4 x hd/16 block of the output accumulator, both in registers; one
//     warp per 8 rows keeps the running max and denominator.
// Not done yet: wgmma/TMA, and a split of long rows over several blocks.
//
// GQA groups: the group G = Hq / Hkv (1..16) is a run-time argument, not
// a template parameter. A block of R rows (64 f32; 64 or 128 bf16) takes
// BQ = R / G positions, rows r < BQ * G mapping to (q0 + r / G, head
// r % G). When G does not divide R (G = 3, 5, 6, 7, ...), the R % G rows
// left over would map to the next block's first position and write its
// output twice (or read past T): they take position T instead (row_pos),
// so they load no q and write no output, and cost R % G rows of
// tensor-core work (2 of 128 at G = 3, 6 and 7, 3 at G = 5; 12 at most).
// Only the row map reads G, so one instantiation serves every group.
//
// Plain C interface (bound with ctypes); launches on the caller's stream
// and returns cudaGetLastError() after the launch.

#include "common.cuh"

namespace {

using localai::from_f32;
using localai::to_f32;

constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;  // H100 opt-in shared memory per block
constexpr int kRows = 64;         // f32 query rows (position x group) a block
constexpr int kBK = 64;           // keys per tile
constexpr int kThreads = 256;
constexpr int kPS = kBK + 4;      // f32 row stride of the score tile
constexpr int kMaxGroup = 16;     // the wrappers' gate (KERNEL_GROUPS)

// The query position of row r of a block of rows whose first position is
// q0, at group g with bq = rows / g positions a block: q0 + r / g for the
// bq * g mapped rows; a row left over (r >= bq * g) takes Tn, so it loads
// no q and writes no output.
__device__ __forceinline__ int row_pos(int r, int q0, int g, int bq, int Tn) {
  return r < bq * g ? q0 + r / g : Tn;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// four consecutive f32 elements of a staged row (16-byte aligned)
// aligned)
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  o[0] = f.x; o[1] = f.y; o[2] = f.z; o[3] = f.w;
}

template <typename T, int HD>
struct Layout {
  static constexpr int kRowBytes = HD * (int)sizeof(T);
  static constexpr int kPad = kRowBytes + 16;  // smem row stride of K/V
  static constexpr int kQS = HD + 4;           // f32 row stride of q
  static constexpr size_t kQBytes = (size_t)kRows * kQS * 4;
  static constexpr size_t kPBytes = (size_t)kRows * kPS * 4;
  static constexpr size_t kStatBytes = 3 * (size_t)kRows * 4;
  static constexpr size_t kTileBytes = (size_t)kBK * kPad;
  // q, scores, row stats, then two stages of K and two of V
  static constexpr size_t kSmem =
      kQBytes + kPBytes + kStatBytes + 4 * kTileBytes;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) prefill_kernel(
    const T* __restrict__ q,    // [T, Hq, HD]
    const T* __restrict__ k,    // [Hkv, T, HD]
    const T* __restrict__ v,    // [Hkv, T, HD]
    T* __restrict__ out,        // [T, Hq, HD]
    int Tn, int G, int length, int window, float sm_scale) {
  using L = Layout<T, HD>;
  const int BQ = kRows / G;         // query positions per block
  constexpr int DC = HD / 16;       // output columns per thread
  constexpr int kChunks = L::kRowBytes / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);       // [kRows][kQS]
  float* ps = qs + kRows * L::kQS;                       // [kRows][kPS]
  float* row_m = ps + kRows * kPS;                       // [kRows]
  float* row_l = row_m + kRows;                          // [kRows]
  float* row_alpha = row_l + kRows;                      // [kRows]
  unsigned char* kbuf = smem_raw + L::kQBytes + L::kPBytes + L::kStatBytes;
  unsigned char* vbuf = kbuf + 2 * L::kTileBytes;

  const int h = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int Hq = gridDim.x * G;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // score columns tx + 16c; output columns tx*DC..

  for (int e = tid; e < kRows * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int t = row_pos(r, q0, G, BQ, Tn);
    qs[r * L::kQS + d] =
        t < Tn ? to_f32(q[((size_t)t * Hq + h * G + r % G) * HD + d]) * sm_scale
               : 0.f;
  }
  if (tid < kRows) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }

  // trip range: causal frontier and real length, minus sub-window tiles;
  // never empty (rows past length keep a well-formed walk)
  int nb = min(min((q0 + BQ + kBK - 1) / kBK, (length + kBK - 1) / kBK),
               (Tn + kBK - 1) / kBK);
  int lo = 0;
  if (window > 0) {
    const int first = q0 - window + 1;
    lo = first > 0 ? first / kBK : 0;
  }
  nb = max(nb, lo + 1);

  const char* kh = reinterpret_cast<const char*>(k + (size_t)h * Tn * HD);
  const char* vh = reinterpret_cast<const char*>(v + (size_t)h * Tn * HD);
  auto issue = [&](int i, int stage) {
    const int k0 = i * kBK;
    unsigned char* kd = kbuf + stage * L::kTileBytes;
    unsigned char* vd = vbuf + stage * L::kTileBytes;
    for (int e = tid; e < kBK * kChunks; e += kThreads) {
      const int j = e / kChunks, c = e % kChunks;
      const bool live = k0 + j < Tn;
      // constant zero-fill counts: a runtime one makes the intrinsic
      // switch over every count per copy
      if (live) {
        const size_t off = (size_t)(k0 + j) * L::kRowBytes + 16 * c;
        __pipeline_memcpy_async(kd + j * L::kPad + 16 * c, kh + off, 16);
        __pipeline_memcpy_async(vd + j * L::kPad + 16 * c, vh + off, 16);
      } else {  // rows past T: 16 zero bytes
        __pipeline_memcpy_async(kd + j * L::kPad + 16 * c, kh, 16, 16);
        __pipeline_memcpy_async(vd + j * L::kPad + 16 * c, vh, 16, 16);
      }
    }
    __pipeline_commit();
  };

  float acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int x = 0; x < DC; ++x) acc[a][x] = 0.f;

  issue(lo, 0);
  for (int i = lo; i < nb; ++i) {
    const int stage = (i - lo) & 1;
    if (i + 1 < nb) {
      issue(i + 1, stage ^ 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const unsigned char* kt = kbuf + stage * L::kTileBytes;
    const unsigned char* vt = vbuf + stage * L::kTileBytes;

    // scores of rows ty*4+a against keys tx+16c
    float sc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float qv[4][4], kv[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) load4(qs + (ty * 4 + a) * L::kQS + d, qv[a]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        load4(reinterpret_cast<const T*>(kt + (tx + 16 * c) * L::kPad) + d,
              kv[c]);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int x = 0; x < 4; ++x) sc[a][c] += qv[a][x] * kv[c][x];
    }
    const int k0 = i * kBK;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty * 4 + a;
      const int qpos = row_pos(r, q0, G, BQ, Tn);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        const int kj = k0 + j;
        const bool keep = kj <= qpos && kj < length &&
                          (window <= 0 || kj > qpos - window);
        ps[r * kPS + j] = keep ? sc[a][c] : kNegInf;
      }
    }
    __syncthreads();

    // online-softmax statistics: warp w takes rows 8w .. 8w+7
    for (int r = warp * (kRows / 8); r < (warp + 1) * (kRows / 8); ++r) {
      const float s0 = ps[r * kPS + lane];
      const float s1 = ps[r * kPS + lane + 32];
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      ps[r * kPS + lane] = p0;
      ps[r * kPS + lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        row_alpha[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float alpha = row_alpha[ty * 4 + a];
#pragma unroll
      for (int x = 0; x < DC; ++x) acc[a][x] *= alpha;
    }
    for (int j = 0; j < kBK; ++j) {
      const T* vrow = reinterpret_cast<const T*>(vt + j * L::kPad) + tx * DC;
      float vv[DC];
#pragma unroll
      for (int x = 0; x < DC; ++x) vv[x] = to_f32(vrow[x]);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = ps[(ty * 4 + a) * kPS + j];
#pragma unroll
        for (int x = 0; x < DC; ++x) acc[a][x] += p * vv[x];
      }
    }
    __syncthreads();  // the next issue() overwrites this stage's tiles
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty * 4 + a;
    const int t = row_pos(r, q0, G, BQ, Tn);
    if (t >= Tn) continue;
    const float l = fmaxf(row_l[r], 1e-30f);
    T* orow = out + ((size_t)t * Hq + h * G + r % G) * HD + tx * DC;
#pragma unroll
    for (int x = 0; x < DC; ++x) orow[x] = from_f32<T>(acc[a][x] / l);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync.m16n8k16, f32 accumulate)
// ---------------------------------------------------------------------------

// smem row stride (bytes) of the q, K and V tiles: 16 bytes of padding make
// it 17 chunks of 16 bytes at hd=128 (9 at 64, 5 at 32), so the 8 rows an
// ldmatrix reads fall on 8 different groups of four banks
template <int HD>
__host__ __device__ constexpr int mma_pad() {
  return HD * 2 + 16;
}

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;

// q rows (64 per m16 tile a warp), then two stages of K and two of V
template <int HD, int MT>
__host__ __device__ constexpr size_t mma_smem() {
  return (size_t)(16 * MT * kMmaWarps + 4 * kBK) * mma_pad<HD>();
}

// not volatile: a register-only instruction the compiler may schedule
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory; lanes 8m .. 8m+7 give the row
// addresses of matrix m, and lane l receives row l/4, columns 2(l%4) and
// 2(l%4)+1 of each (.trans: of each matrix's transpose)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 2^x, flushing results below the smallest normal to 0 (a probability
// that small adds nothing to a sum of terms of which the largest is 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two floats as a bf16 pair, the first in the low half (fragment order)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4): A register i
// holds rows g (+8 for i = 1, 3) and columns 2t, 2t+1 (+8 for i = 2, 3);
// B register j holds rows 2t, 2t+1 (+8 for j = 1) of column g; C holds
// rows g (c0, c1) and g+8 (c2, c3), columns 2t, 2t+1. So one ldmatrix.x4
// gives a warp's A fragment of 16 q rows at one k16 step (matrices: rows
// 0-7 / 8-15 x columns 0-7 / 8-15), the B fragments of two n8 tiles of K
// at one k16 step (K rows are the B columns: matrices of keys 0-7 / 8-15
// x hd columns 0-7 / 8-15), and with .trans the B fragments of two n8
// tiles of V at one k16 step (matrices: keys 0-7 / 8-15 x hd columns 0-7
// / 8-15).
//
// kWarps warps of MT m16 tiles (16 * MT rows) each; the block's
// 64 * MT rows are (query position x GQA group) pairs, so every K/V tile
// it stages serves the whole group. Every K/V fragment a warp reads from
// shared memory feeds MT mma: at MT = 2 a 128-row block reads each staged
// tile once per 32 rows, and the tensor cores, not shared memory, set
// the pace.
template <int HD, int MT>
__global__ void __launch_bounds__(kMmaThreads) prefill_mma_kernel(
    const __nv_bfloat16* __restrict__ q,  // [T, Hq, HD]
    const __nv_bfloat16* __restrict__ k,  // [Hkv, T, HD]
    const __nv_bfloat16* __restrict__ v,  // [Hkv, T, HD]
    __nv_bfloat16* __restrict__ out,      // [T, Hq, HD]
    int Tn, int G, int length, int window, float sm_scale) {
  constexpr int kWarpRows = 16 * MT;
  constexpr int kBlockRows = kWarpRows * kMmaWarps;
  const int BQ = kBlockRows / G;      // query positions per block
  constexpr int kPad = mma_pad<HD>();
  constexpr int kChunks = HD * 2 / 16;
  constexpr int kTileBytes = kBK * kPad;
  constexpr int NT = kBK / 8;         // score n-tiles per key tile
  constexpr int DT = HD / 8;          // output n-tiles
  constexpr int KS = HD / 16;         // k16 steps over hd
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qsm = smem_raw;                         // [rows][kPad]
  unsigned char* kbuf = qsm + kBlockRows * kPad;         // [2][kBK][kPad]
  unsigned char* vbuf = kbuf + 2 * kTileBytes;           // [2][kBK][kPad]

  const int h = blockIdx.x;
  // the longest causal walks (the last query tiles) launch first, so they
  // do not form the tail of the grid
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int Hq = gridDim.x * G;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  // the softmax runs in the log2 domain: with m the row's running max of
  // s * scale2, exp2(s * scale2 - m) is exp(s * sm_scale - m / log2 e),
  // one FFMA and one ex2 per score
  const float scale2 = sm_scale * kLog2e;

  // q rows (position x group) into shared memory, zero past T and in the
  // rows left over
  for (int e = tid; e < kBlockRows * kChunks; e += kMmaThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const int pos = row_pos(r, q0, G, BQ, Tn);
    unsigned char* dst = qsm + r * kPad + 16 * c;
    if (pos < Tn) {
      __pipeline_memcpy_async(
          dst, q + ((size_t)pos * Hq + h * G + r % G) * HD + 8 * c, 16);
    } else {
      __pipeline_memcpy_async(dst, q, 16, 16);
    }
  }
  __pipeline_commit();

  // trip range: causal frontier and real length, minus sub-window tiles;
  // never empty (rows past length keep a well-formed walk)
  int nb = min(min((q0 + BQ + kBK - 1) / kBK, (length + kBK - 1) / kBK),
               (Tn + kBK - 1) / kBK);
  int lo = 0;
  if (window > 0) {
    const int first = q0 - window + 1;
    lo = first > 0 ? first / kBK : 0;
  }
  nb = max(nb, lo + 1);

  // one [kBK, HD] tile of K or V into a stage, as its own commit group
  auto issue = [&](unsigned char* buf, const __nv_bfloat16* src, int i,
                   int stage) {
    const int k0 = i * kBK;
    const char* head = reinterpret_cast<const char*>(src + (size_t)h * Tn * HD);
    unsigned char* dst = buf + stage * kTileBytes;
    for (int e = tid; e < kBK * kChunks; e += kMmaThreads) {
      const int j = e / kChunks, c = e % kChunks;
      // constant zero-fill counts: a runtime one makes the intrinsic
      // switch over every count per copy
      if (k0 + j < Tn) {
        __pipeline_memcpy_async(dst + j * kPad + 16 * c,
                                head + (size_t)(k0 + j) * HD * 2 + 16 * c, 16);
      } else {  // rows past T: 16 zero bytes
        __pipeline_memcpy_async(dst + j * kPad + 16 * c, head, 16, 16);
      }
    }
    __pipeline_commit();
  };
  // commit groups in order: q, then K and V of each tile apart, so the
  // scores of a tile start when its K has landed, with its V in flight
  issue(kbuf, k, lo, 0);
  issue(vbuf, v, lo, 0);

  // this thread's rows: g and g+8 of each of the warp's m16 tiles
  int qpos[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      qpos[mt][half] =
          row_pos(warp * kWarpRows + 16 * mt + g + 8 * half, q0, G, BQ, Tn);
  // this lane's ldmatrix row addresses: in q (m16 tile 0, k16 step 0), in
  // a K tile (n8 pair 0, k16 step 0) and in a V tile (k16 step 0, n8 pair
  // 0)
  const uint32_t q_lane = smem_addr(
      qsm + (warp * kWarpRows + (lane % 8) + 8 * ((lane / 8) % 2)) * kPad +
      16 * (lane / 16));
  const int k_lane = ((lane % 8) + 8 * (lane / 16)) * kPad +
                     16 * ((lane / 8) % 2);
  const int v_lane = ((lane % 8) + 8 * ((lane / 8) % 2)) * kPad +
                     16 * (lane / 16);

  float acc[MT][DT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int dn = 0; dn < DT; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][dn][e] = 0.f;
  float row_m[MT][2], row_l[MT][2];  // row_m: running max of s * scale2
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    row_m[mt][0] = row_m[mt][1] = -INFINITY;
    row_l[mt][0] = row_l[mt][1] = 0.f;
  }

  for (int i = lo; i < nb; ++i) {
    const int stage = (i - lo) & 1;
    const bool more = i + 1 < nb;
    // K of tile i (and q, before the first tile) has landed; its V may
    // not have
    __pipeline_wait_prior(1);
    // every thread is past tile i-1, so its stage can take tile i+1
    __syncthreads();
    if (more) {
      issue(kbuf, k, i + 1, stage ^ 1);
      issue(vbuf, v, i + 1, stage ^ 1);
    }

    // scores: s[mt][nt] covers keys nt*8 .. nt*8+7 of the tile
    const uint32_t kt = smem_addr(kbuf + stage * kTileBytes + k_lane);
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(a[mt], q_lane + mt * 16 * kPad + 32 * ks);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, kt + np * 16 * kPad + 32 * ks);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(s[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }

    // the mask runs only on a tile that crosses the causal diagonal, the
    // window's edge or length for some row of the block (the same for
    // every warp); a masked score is -inf, so its probability is exactly 0
    // (a finite fill scaled inside the FFMA would not cancel exactly
    // against the max, which is scaled apart, and could overflow ex2)
    const int k0 = i * kBK;
    const bool edge = k0 + kBK - 1 > q0 || k0 + kBK > length ||
                      (window > 0 && k0 <= q0 + BQ - 1 - window);
    // the probabilities as bf16 pairs, the A fragments of p @ v: p[mt][kk]
    // covers keys kk*16 .. kk*16+15 (n-tiles 2kk and 2kk+1)
    uint32_t p[MT][kBK / 16][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
      if (edge) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int pos = qpos[mt][e / 2];
            const int kj = k0 + nt * 8 + 2 * t + (e & 1);
            const bool keep = kj <= pos && kj < length &&
                              (window <= 0 || kj > pos - window);
            if (!keep) s[mt][nt][e] = -INFINITY;
            mx[e / 2] = fmaxf(mx[e / 2], s[mt][nt][e]);
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[mt][nt][e]);
      }
      float alpha[2], m_use[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
        // scale2 > 0, so the max of the scaled scores is the scaled max
        const float m_new = fmaxf(row_m[mt][half], mx[half] * scale2);
        // a row with no kept key yet (m_new = -inf) takes 0 as its offset:
        // its probabilities and alpha are then exactly 0, never NaN
        m_use[half] = m_new == -INFINITY ? 0.f : m_new;
        alpha[half] = exp2_ftz(row_m[mt][half] - m_use[half]);
        row_m[mt][half] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][nt][e] =
              exp2_ftz(fmaf(s[mt][nt][e], scale2, -m_use[e / 2]));
          sum[e / 2] += s[mt][nt][e];
        }
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        p[mt][kk][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        p[mt][kk][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        p[mt][kk][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        p[mt][kk][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
        sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
        row_l[mt][half] = row_l[mt][half] * alpha[half] + sum[half];
      }
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        acc[mt][dn][0] *= alpha[0];
        acc[mt][dn][1] *= alpha[0];
        acc[mt][dn][2] *= alpha[1];
        acc[mt][dn][3] *= alpha[1];
      }
    }

    // V of tile i: the groups after it are tile i+1's K and V, if issued
    if (more) {
      __pipeline_wait_prior(2);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();

    // acc += p @ v, 16 keys per step
    const uint32_t vt = smem_addr(vbuf + stage * kTileBytes + v_lane);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, vt + kk * 16 * kPad + 32 * dp);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * dp], p[mt][kk], b[0], b[1]);
          mma_bf16(acc[mt][2 * dp + 1], p[mt][kk], b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * kWarpRows + 16 * mt + g + 8 * half;
      const int pos = qpos[mt][half];
      if (pos >= Tn) continue;
      const float l = fmaxf(row_l[mt][half], 1e-30f);
      __nv_bfloat16* orow = out + ((size_t)pos * Hq + h * G + r % G) * HD;
#pragma unroll
      for (int dn = 0; dn < DT; ++dn)
        *reinterpret_cast<uint32_t*>(orow + dn * 8 + 2 * t) = pack_bf16(
            acc[mt][dn][2 * half] / l, acc[mt][dn][2 * half + 1] / l);
    }
}

struct Args {
  const void *q, *k, *v;
  void* out;
  int Tn, Hkv, G, length, window, rows;
  float sm_scale;
  cudaStream_t stream;
};

// the f32 kernel on the CUDA cores
template <int HD>
int launch_f32(const Args& a) {
  constexpr size_t smem = Layout<float, HD>::kSmem;
  static_assert(smem <= (size_t)kMaxSmem, "tiles exceed shared memory");
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        prefill_kernel<float, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int BQ = kRows / a.G;  // positions a block; the rest masked
  dim3 grid(a.Hkv, (a.Tn + BQ - 1) / BQ);
  prefill_kernel<float, HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.Tn,
      a.G, a.length, a.window, a.sm_scale);
  return (int)cudaGetLastError();
}

// the bf16 kernel on the tensor cores, MT m16 tiles a warp
template <int HD, int MT>
int launch_mma(const Args& a) {
  constexpr size_t smem = mma_smem<HD, MT>();
  static_assert(smem <= (size_t)kMaxSmem, "tiles exceed shared memory");
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        prefill_mma_kernel<HD, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int BQ = 16 * MT * kMmaWarps / a.G;  // positions a block
  dim3 grid(a.Hkv, (a.Tn + BQ - 1) / BQ);
  prefill_mma_kernel<HD, MT><<<grid, kMmaThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<__nv_bfloat16*>(a.out), a.Tn, a.G, a.length, a.window,
      a.sm_scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(bool bf16, const Args& a) {
  if (!bf16) return launch_f32<HD>(a);
  switch (a.rows) {
    case 64: return launch_mma<HD, 1>(a);
    case 128: return launch_mma<HD, 2>(a);
    default: return -1;
  }
}

}  // namespace

// rows: query rows (position x group) a bf16 CUDA block takes, 64 or 128
// (the f32 kernel always takes kRows). Returns 0 on success, a
// cudaError_t after a failed launch, or -1 for a head dim or rows that
// were not compiled, or a group outside 1..16.
extern "C" int prefill_attention(const void* q, const void* k, const void* v,
                                 void* out, int T, int Hq, int Hkv, int hd,
                                 int length, int window, int rows,
                                 int is_bf16, float sm_scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || T <= 0) return -1;
  const int G = Hq / Hkv;
  if (G > kMaxGroup) return -1;
  const Args a{q, k, v, out, T, Hkv, G, length, window, rows, sm_scale,
               static_cast<cudaStream_t>(stream)};
  switch (hd) {
    case 32: return launch<32>(is_bf16 != 0, a);
    case 64: return launch<64>(is_bf16 != 0, a);
    case 128: return launch<128>(is_bf16 != 0, a);
    default: return -1;
  }
}
