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
// Design: one CUDA block per (kv head, tile of 64/G query positions), so
// kRows = 64 rows share every K/V tile they read; 64-key K and V tiles are
// staged by double-buffered cp.async (the copy of tile i+1 is in flight
// while tile i is folded), rows padded by 16 bytes against bank conflicts
// and zero-filled past T.
//   * bf16: tensor cores. Four warps of 16 rows each; a warp keeps its q
//     fragments in registers, computes its 16x64 score tile with
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate), runs the online
//     softmax on the accumulator fragments (row max and sum across the
//     four threads of a quad), and multiplies the probabilities, rounded
//     to bf16 as the A operand, by V with the same instruction. The
//     denominator takes the f32 probabilities.
//   * f32: CUDA cores (no tensor-core type keeps f32 products exact). 256
//     threads; the block's q rows sit in shared memory in f32; each thread
//     owns a 4x4 block of the 64x64 score tile and a 4 x hd/16 block of the
//     output accumulator, both in registers; one warp per 8 rows keeps the
//     running max and denominator.
// Not done yet: wgmma/TMA, ldmatrix for the V fragments, and a split of
// long rows over several blocks.
//
// Plain C interface (bound with ctypes); launches on the caller's stream
// and returns cudaGetLastError() after the launch.

#include <type_traits>

#include "common.cuh"

namespace {

using localai::from_f32;
using localai::to_f32;

constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;  // H100 opt-in shared memory per block
constexpr int kRows = 64;         // query rows (position x group) per block
constexpr int kBK = 64;           // keys per tile
constexpr int kThreads = 256;
constexpr int kPS = kBK + 4;      // f32 row stride of the score tile

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

// four consecutive elements of a staged row as f32 (16-byte or 8-byte
// aligned)
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  o[0] = f.x; o[1] = f.y; o[2] = f.z; o[3] = f.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
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

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads) prefill_kernel(
    const T* __restrict__ q,    // [T, Hq, HD]
    const T* __restrict__ k,    // [Hkv, T, HD]
    const T* __restrict__ v,    // [Hkv, T, HD]
    T* __restrict__ out,        // [T, Hq, HD]
    int Tn, int length, int window, float sm_scale) {
  using L = Layout<T, HD>;
  constexpr int BQ = kRows / G;     // query positions per block
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
    const int t = q0 + r / G;
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
      const int qpos = q0 + r / G;
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
    const int t = q0 + r / G;
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

constexpr int kMmaThreads = 128;  // four warps of 16 rows

template <int HD>
struct MmaLayout {
  static constexpr int kPad = HD * 2 + 16;  // smem row stride (bytes)
  static constexpr size_t kQBytes = (size_t)kRows * kPad;
  static constexpr size_t kTileBytes = (size_t)kBK * kPad;
  // q, then two stages of K and two of V
  static constexpr size_t kSmem = kQBytes + 4 * kTileBytes;
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16 pair, the first in the low half (fragment order)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t lds16(const unsigned char* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4): A register i
// holds rows g (+8 for i = 1, 3) and columns 2t, 2t+1 (+8 for i = 2, 3);
// B register j holds rows 2t, 2t+1 (+8 for j = 1) of column g; C holds
// rows g (c0, c1) and g+8 (c2, c3), columns 2t, 2t+1.
template <int HD, int G>
__global__ void __launch_bounds__(kMmaThreads) prefill_mma_kernel(
    const __nv_bfloat16* __restrict__ q,  // [T, Hq, HD]
    const __nv_bfloat16* __restrict__ k,  // [Hkv, T, HD]
    const __nv_bfloat16* __restrict__ v,  // [Hkv, T, HD]
    __nv_bfloat16* __restrict__ out,      // [T, Hq, HD]
    int Tn, int length, int window, float sm_scale) {
  using L = MmaLayout<HD>;
  constexpr int BQ = kRows / G;     // query positions per block
  constexpr int kChunks = HD * 2 / 16;
  constexpr int NT = kBK / 8;       // score n-tiles per key tile
  constexpr int DT = HD / 8;        // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qsm = smem_raw;                         // [kRows][kPad]
  unsigned char* kbuf = smem_raw + L::kQBytes;           // [2][kBK][kPad]
  unsigned char* vbuf = kbuf + 2 * L::kTileBytes;

  const int h = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int Hq = gridDim.x * G;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  // q rows (position x group) into shared memory, zero past T
  for (int e = tid; e < kRows * kChunks; e += kMmaThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const int pos = q0 + r / G;
    unsigned char* dst = qsm + r * L::kPad + 16 * c;
    if (pos < Tn) {
      __pipeline_memcpy_async(
          dst, q + ((size_t)pos * Hq + h * G + r % G) * HD + 8 * c, 16);
    } else {
      __pipeline_memcpy_async(dst, q, 16, 16);
    }
  }
  __pipeline_commit();

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
    for (int e = tid; e < kBK * kChunks; e += kMmaThreads) {
      const int j = e / kChunks, c = e % kChunks;
      if (k0 + j < Tn) {
        const size_t off = (size_t)(k0 + j) * HD * 2 + 16 * c;
        __pipeline_memcpy_async(kd + j * L::kPad + 16 * c, kh + off, 16);
        __pipeline_memcpy_async(vd + j * L::kPad + 16 * c, vh + off, 16);
      } else {  // rows past T: 16 zero bytes
        __pipeline_memcpy_async(kd + j * L::kPad + 16 * c, kh, 16, 16);
        __pipeline_memcpy_async(vd + j * L::kPad + 16 * c, vh, 16, 16);
      }
    }
    __pipeline_commit();
  };
  issue(lo, 0);

  // this thread's two rows of the warp's 16 and their positions
  const int r0 = warp * 16 + g;
  const int qpos[2] = {q0 + r0 / G, q0 + (r0 + 8) / G};

  __pipeline_wait_prior(1);  // q has landed (the first tile may not have)
  __syncthreads();
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const unsigned char* base = qsm + r0 * L::kPad + (ks * 16 + 2 * t) * 2;
    qa[ks][0] = lds32(base);
    qa[ks][1] = lds32(base + 8 * L::kPad);
    qa[ks][2] = lds32(base + 16);
    qa[ks][3] = lds32(base + 8 * L::kPad + 16);
  }

  float acc[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  float row_m[2] = {kNegInf, kNegInf};
  float row_l[2] = {0.f, 0.f};

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

    // scores: s[nt] covers keys nt*8 .. nt*8+7 of the tile
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const unsigned char* krow = kt + (nt * 8 + g) * L::kPad + 4 * t;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        mma_bf16(s[nt], qa[ks], lds32(krow + ks * 32),
                 lds32(krow + ks * 32 + 16));
    }

    // scale, mask, online-softmax statistics for rows g and g+8
    const int k0 = i * kBK;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e / 2;
        const int kj = k0 + nt * 8 + 2 * t + (e & 1);
        const bool keep = kj <= qpos[row] && kj < length &&
                          (window <= 0 || kj > qpos[row] - window);
        s[nt][e] = keep ? s[nt][e] * sm_scale : kNegInf;
        mx[row] = fmaxf(mx[row], s[nt][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 1));
      mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 2));
      const float m_new = fmaxf(row_m[row], mx[row]);
      alpha[row] = expf(row_m[row] - m_new);
      row_m[row] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - row_m[e / 2]);
        sum[e / 2] += s[nt][e];
      }
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      sum[row] += __shfl_xor_sync(0xffffffffu, sum[row], 1);
      sum[row] += __shfl_xor_sync(0xffffffffu, sum[row], 2);
      row_l[row] = row_l[row] * alpha[row] + sum[row];
    }
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }

    // acc += p @ v, 16 keys per step: the score C fragments of n-tiles
    // 2kk and 2kk+1 are the A fragment of the step
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const unsigned char* v0 = vt + (kk * 16 + 2 * t) * L::kPad + 2 * g;
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        const unsigned char* vp = v0 + dn * 16;
        const uint32_t b0 = lds16(vp) | (lds16(vp + L::kPad) << 16);
        const uint32_t b1 =
            lds16(vp + 8 * L::kPad) | (lds16(vp + 9 * L::kPad) << 16);
        mma_bf16(acc[dn], pa, b0, b1);
      }
    }
    __syncthreads();  // the next issue() overwrites this stage's tiles
  }

#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int r = r0 + 8 * row;
    const int pos = qpos[row];
    if (pos >= Tn) continue;
    const float l = fmaxf(row_l[row], 1e-30f);
    __nv_bfloat16* orow = out + ((size_t)pos * Hq + h * G + r % G) * HD;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn)
      *reinterpret_cast<uint32_t*>(orow + dn * 8 + 2 * t) =
          pack_bf16(acc[dn][2 * row] / l, acc[dn][2 * row + 1] / l);
  }
}

struct Args {
  const void *q, *k, *v;
  void* out;
  int Tn, Hkv, length, window;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, int HD, int G>
int launch(const Args& a) {
  // bf16 runs the tensor-core kernel, f32 the CUDA-core one
  constexpr bool kMma = std::is_same_v<T, __nv_bfloat16>;
  constexpr size_t smem =
      kMma ? MmaLayout<HD>::kSmem : Layout<T, HD>::kSmem;
  static_assert(smem <= (size_t)kMaxSmem, "tiles exceed shared memory");
  const auto kernel = [] {
    if constexpr (kMma) {
      return prefill_mma_kernel<HD, G>;
    } else {
      return prefill_kernel<T, HD, G>;
    }
  }();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  constexpr int BQ = kRows / G;
  dim3 grid(a.Hkv, (a.Tn + BQ - 1) / BQ);
  kernel<<<grid, kMma ? kMmaThreads : kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.Tn, a.length,
      a.window, a.sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_g(int G, const Args& a) {
  switch (G) {
    case 1: return launch<T, HD, 1>(a);
    case 2: return launch<T, HD, 2>(a);
    case 4: return launch<T, HD, 4>(a);
    case 8: return launch<T, HD, 8>(a);
    default: return -1;
  }
}

template <typename T>
int launch_hd(int hd, int G, const Args& a) {
  switch (hd) {
    case 32: return launch_g<T, 32>(G, a);
    case 64: return launch_g<T, 64>(G, a);
    case 128: return launch_g<T, 128>(G, a);
    default: return -1;
  }
}

}  // namespace

// Returns 0 on success, a cudaError_t after a failed launch, or -1 for a
// (head_dim, group, dtype) combination that was not compiled.
extern "C" int prefill_attention(const void* q, const void* k, const void* v,
                                 void* out, int T, int Hq, int Hkv, int hd,
                                 int length, int window, int is_bf16,
                                 float sm_scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || T <= 0) return -1;
  const int G = Hq / Hkv;
  const Args a{q, k, v, out, T, Hkv, length, window, sm_scale,
               static_cast<cudaStream_t>(stream)};
  if (is_bf16) return launch_hd<__nv_bfloat16>(hd, G, a);
  return launch_hd<float>(hd, G, a);
}
