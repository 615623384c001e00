// Tensor-core tile shared by the quantized matmuls K4 (w8_matmul.cu) and
// K5 (w4_matmul.cu) on their bf16 paths; no other source includes it.
//
// The product out[M, N] = x[M, K] @ W[K, N] runs on
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 with the weight on
// the 16-row side (A: rows = 16 output columns, cols = 16 K rows) and x on
// the 8-column side (B: cols = 8 rows of x). At decode (M = 8 slots) one
// n8 tile is exactly the batch, so no half of the tensor core multiplies
// padding; M up to 256 takes more n8 tiles (MI of them) per CTA, each
// reusing the dequantized weight fragments.
//
// A CTA is 4 warps over kBN = 128 output columns and 8 * MI rows of x,
// walking one split of K (split edges on kBK = 128 rows; for K5 also on
// group edges) in kBK-row stages: two warps per 64 columns, each taking
// every other pair of k16 steps of a stage, so an SM holds twice the warps
// to hide the dequantize-then-mma chain; their sums are added in a fixed
// order at the end. Both tiles of a stage (the quantized
// weight rows of the CTA's columns and the x rows) stream into shared
// memory with cp.async in a W::kStages ring, so the next stages' bytes are
// in flight while this one is multiplied. The weight is dequantized to
// bf16 in registers, never in memory.
//
// A-row to column mapping: the 64 columns of a warp are 4 m16 tiles, and
// the thread with groupID g (lane / 4) owns A rows g and g + 8 of every
// tile. Row g of tile t is column 8g + 2t and row g + 8 is 8g + 2t + 1, so
// each thread reads its weight bytes as one 8-byte run per K row, its D
// fragments cover 8 adjacent columns (one 16-byte store of bf16 out), and
// its scales are two float4 loads. For a [K, N] weight the K order inside
// a k16 step is the natural one, so x's B fragments come straight from
// ldmatrix; K4's [N, K] table orders K inside two steps its own way (its
// policy in w8_matmul.cu).
//
// Split K: blockIdx.z is e * splits + the split. With one split the CTA
// writes out in x's dtype; with more it writes f32 partials
// [E, splits, M, N] (a scratch from the caller), and qmm_reduce_kernel
// folds them in split order 0, 1, ... — the same sum every run (no
// atomics).
//
// Experts (K4's MoE path, Batch below): one launch computes E products of
// one shape, expert e on blockIdx.z / splits, each at its own offsets of
// x, the weight, the scale and out. A batch of one is a plain product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace localai {
namespace qmm {

constexpr int kBN = 128;                // output columns per CTA
constexpr int kWarpN = 64;              // output columns per warp
constexpr int kWarpsN = kBN / kWarpN;   // warps along N
constexpr int kWarpsK = 2;              // warps sharing a column block
constexpr int kThreads = 32 * kWarpsN * kWarpsK;
constexpr int kBK = 128;                // K rows per stage; split edges

// E products of one shape in one launch: expert e reads x + e * sx (rows
// ldx elements apart), the weight at q + e * sq bytes, scale + e * ss, and
// writes out + e * so (rows ldo elements apart). sx = 0 when every expert
// reads the same rows (an MoE up projection). A plain product is
// dense(K, N).
struct Batch {
  int E, ldx, ldo;
  long long sx, sq, ss, so;
};
inline Batch dense(int K, int N) { return Batch{1, K, N, 0, 0, 0, 0}; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; zero-fills when !live
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte J of w holds two signed nibbles (K rows 2i in the low one, 2i + 1
// in the high one, pack_w4's layout); w4 = w >> 4 (shared by the word's 4
// bytes): -> bf16x2 {low, high}, exact, in 3 instructions and no I2F. A
// byte permute puts the low nibble in bits 0-3 and the high one in bits
// 16-19; one lop3 masks them and makes each half a bf16 whose exponent
// encodes 128 (0x4300) with bit 3 flipped, so it reads 128 + (n + 8);
// one bf16x2 fma subtracts 136.
template <int J>
__device__ __forceinline__ uint32_t i4x2_to_bf16x2(uint32_t w, uint32_t w4) {
  constexpr uint32_t sel = J | (J << 4) | ((4 + J) << 8) | ((4 + J) << 12);
  const uint32_t t = (__byte_perm(w, w4, sel) & 0x000F000Fu) ^ 0x43084308u;
  uint32_t r;
  // t * 1.0 + (-136.0), both halves: exact for these integers
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(t), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// Byte JA of wa and byte JB of wb (two int8 K values of one column,
// already XORed with 0x80 to offset binary) -> bf16x2 {wa's, wb's},
// exact: each byte lands in the mantissa of 2^23 (a byte permute), one
// f32 subtract takes 2^23 + 128 off, and a byte permute packs the two
// floats' upper halves, which are their bf16 values exactly (a small
// integer's low 16 float bits are 0; a bf16 magic number cannot hold
// -128..127, its mantissa is 7 bits).
template <int JA, int JB = JA>
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t wa, uint32_t wb) {
  // [byte J, 0, 0, 0x4B] is the float 2^23 + byte
  const float fa =
      __uint_as_float(__byte_perm(wa, 0x4B000000u, 0x7650u | JA)) -
      8388736.0f;
  const float fb =
      __uint_as_float(__byte_perm(wb, 0x4B000000u, 0x7650u | JB)) -
      8388736.0f;
  return __byte_perm(__float_as_uint(fa), __float_as_uint(fb), 0x7632u);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// A weight stored [K, N] (K5's packed rows, K4's projections): stage kRows
// rows of kBN bytes, stride kStride, from weight row r0.
template <int kRows, int kStride>
__device__ __forceinline__ void stage_kn(unsigned char* s, const uint8_t* q,
                                         int N, int n0, int r0, int tid) {
  const uint8_t* src = q + (size_t)r0 * N + n0;
  for (int e = tid; e < kRows * (kBN / 16); e += kThreads) {
    const int r = e / (kBN / 16), c = e % (kBN / 16);
    cp_async16(s + r * kStride + c * 16, src + (size_t)r * N + c * 16, true);
  }
}

// x staged [8 MI][kBK] with a row stride of kBK + 8 elements (the 16-byte
// pad puts ldmatrix's 8 rows on distinct banks): the B fragments of k16
// steps jj and jj + 1 for each n8 tile, in the natural K order.
constexpr int kXStrideLdm = kBK + 8;
template <int MI>
__device__ __forceinline__ void ldmatrix_b(const __nv_bfloat16* xs, int jj,
                                           int lane, uint32_t (&b)[MI][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
    ldmatrix_x4(b[mi], xs + (mi * 8 + (lane & 7)) * kXStrideLdm + jj * 16 +
                           8 * (lane >> 3));
}

// The tile walk. W is the weight policy of the source that launches it:
//   kStages, kWBytes  depth of the cp.async ring, weight bytes a stage;
//   kXStride          staged x row stride, bf16 elements;
//   kGrouped          K5: per-group partial sums folded with the group's
//                     scale row at each group end (the Pallas kernel's
//                     order); K4: one scale[N] applied in the epilogue;
//   stage_w(s, q, K, N, n0, k0, tid)   the weight's cp.async for the
//                     stage of K rows [k0, k0 + kBK);
//   frags<MI>(ws, xs, jj, lane, col, a, b)   the A fragments of the 4 m16
//                     tiles (dequantized) and the B fragments of the MI n8
//                     tiles for k16 steps jj and jj + 1. A and B may order
//                     K inside the two steps in any way they both follow.
template <class W, int MI>
__global__ void __launch_bounds__(kThreads)
    qmm_kernel(const __nv_bfloat16* __restrict__ x,  // [M, K]
               const uint8_t* __restrict__ q,        // W's layout
               const float* __restrict__ scale,      // [K/g, N] or [N]
               __nv_bfloat16* __restrict__ out,      // [M, N]
               float* __restrict__ partial,          // [E, splits, M, N]
               int M, int K, int N, int group, int splits, int split_k,
               Batch b) {
  constexpr int MT = 8 * MI;
  constexpr int S = W::kStages;
  constexpr int kWBytes = W::kWBytes;
  constexpr int kXStride = W::kXStride;
  constexpr int kStage = kWBytes + MT * kXStride * 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * MT;
  const int ex = blockIdx.z / splits;  // the expert; then the split
  const int kb = (blockIdx.z - ex * splits) * split_k;
  x += ex * b.sx, q += ex * b.sq, scale += ex * b.ss, out += ex * b.so;
  const int nst = min(K - kb, split_k) / kBK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wn = warp % kWarpsN, kw = warp / kWarpsN;
  const int g = lane / 4, tig = lane % 4;
  const int col = wn * kWarpN + 8 * g;  // this thread's 8 columns

  auto load_stage = [&](int st) {
    unsigned char* s = smem + (st % S) * kStage;
    const int k0 = kb + st * kBK;
    W::stage_w(s, q, K, N, n0, k0, tid);
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(s + kWBytes);
    for (int e = tid; e < MT * (kBK / 8); e += kThreads) {
      const int r = e / (kBK / 8), c = e % (kBK / 8);
      const bool live = m0 + r < M;
      cp_async16(xs + r * kXStride + c * 8,
                 live ? x + (size_t)(m0 + r) * b.ldx + k0 + c * 8 : x, live);
    }
  };

  float acc[MI][4][4], prt[MI][4][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][t][r] = prt[mi][t][r] = 0.f;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nst) load_stage(s);
    cp_async_commit();
  }
  float sv[8];
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<S - 2>();
    __syncthreads();  // stage st landed; every warp is done with st - 1
    if (st + S - 1 < nst) load_stage(st + S - 1);
    cp_async_commit();
    const unsigned char* ws = smem + (st % S) * kStage;
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(ws + kWBytes);
    const int kabs = kb + st * kBK;
    if (W::kGrouped && kabs % group == 0) {  // a group starts: its scales
      const float* srow = scale + (size_t)(kabs / group) * N + n0 + col;
      const float4 s0 = __ldg(reinterpret_cast<const float4*>(srow));
      const float4 s1 = __ldg(reinterpret_cast<const float4*>(srow + 4));
      sv[0] = s0.x, sv[1] = s0.y, sv[2] = s0.z, sv[3] = s0.w;
      sv[4] = s1.x, sv[5] = s1.y, sv[6] = s1.z, sv[7] = s1.w;
    }
#pragma unroll
    for (int i = 0; i < kBK / 16 / (2 * kWarpsK); ++i) {
      const int jj = 2 * (kw + kWarpsK * i);  // this warp's pairs of steps
      uint32_t a[2][4][4], b[MI][4];          // k16 steps jj and jj + 1
      W::template frags<MI>(ws, xs, jj, lane, col, a, b);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            if constexpr (W::kGrouped)  // the group's partial sum
              mma_bf16(prt[mi][t], a[h][t], b[mi][2 * h], b[mi][2 * h + 1]);
            else
              mma_bf16(acc[mi][t], a[h][t], b[mi][2 * h], b[mi][2 * h + 1]);
          }
    }
    if (W::kGrouped && (kabs + kBK) % group == 0) {  // a group ends
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            // regs 0, 1: A row g (column 8g + 2t); 2, 3: row g + 8
            acc[mi][t][r] = fmaf(prt[mi][t][r], sv[2 * t + r / 2],
                                 acc[mi][t][r]);
            prt[mi][t][r] = 0.f;
          }
    }
  }

  // the warps with kw = 1 hand their sums to kw = 0 through the idle ring,
  // laid out [register][thread] so the stores hit distinct banks
  static_assert(kWarpsK == 2, "one hand-over");
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  const int slot = wn * 32 + lane;
  if (kw == 1) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          red[((mi * 4 + t) * 4 + r) * (kWarpsN * 32) + slot] = acc[mi][t][r];
  }
  __syncthreads();
  if (kw == 1) return;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        acc[mi][t][r] += red[((mi * 4 + t) * 4 + r) * (kWarpsN * 32) + slot];

  // D fragment: tile t, regs (h, 2 + h) are x row 2 tig + h at columns
  // 8g + 2t and 8g + 2t + 1
  float cs[8];
  if (!W::kGrouped && partial == nullptr) {
    const float4 s0 = __ldg(reinterpret_cast<const float4*>(scale + n0 + col));
    const float4 s1 =
        __ldg(reinterpret_cast<const float4*>(scale + n0 + col + 4));
    cs[0] = s0.x, cs[1] = s0.y, cs[2] = s0.z, cs[3] = s0.w;
    cs[4] = s1.x, cs[5] = s1.y, cs[6] = s1.z, cs[7] = s1.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) cs[i] = 1.f;
  }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + mi * 8 + 2 * tig + h;
      if (m >= M) continue;
      float v[8];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        v[2 * t] = acc[mi][t][h] * cs[2 * t];
        v[2 * t + 1] = acc[mi][t][2 + h] * cs[2 * t + 1];
      }
      if (partial == nullptr) {
        uint4 o;
        o.x = pack_bf16x2(v[0], v[1]);
        o.y = pack_bf16x2(v[2], v[3]);
        o.z = pack_bf16x2(v[4], v[5]);
        o.w = pack_bf16x2(v[6], v[7]);
        *reinterpret_cast<uint4*>(out + (size_t)m * b.ldo + n0 + col) = o;
      } else {
        float4* p = reinterpret_cast<float4*>(
            partial + ((size_t)blockIdx.z * M + m) * N + n0 + col);
        p[0] = make_float4(v[0], v[1], v[2], v[3]);
        p[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
}

// out = (sum over splits, in split order, of partial) [* scale[n]], four
// columns a thread; expert blockIdx.y of the batch
template <bool kScaled>
__global__ void qmm_reduce_kernel(const float* __restrict__ partial,
                                  const float* __restrict__ scale,
                                  __nv_bfloat16* __restrict__ out, int M,
                                  int N, int splits, Batch b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n4 = M * N / 4;
  if (i >= n4) return;
  const int ex = blockIdx.y;
  const float4* p =
      reinterpret_cast<const float4*>(partial) + (size_t)ex * splits * n4;
  float4 s = p[i];
  for (int k = 1; k < splits; ++k) {
    const float4 v = p[(size_t)k * n4 + i];
    s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
  }
  const int m = 4 * i / N, n = 4 * i - m * N;  // N % 4 == 0: one row
  if (kScaled) {
    const float4 c =
        __ldg(reinterpret_cast<const float4*>(scale + ex * b.ss + n));
    s.x *= c.x, s.y *= c.y, s.z *= c.z, s.w *= c.w;
  }
  uint2 o;
  o.x = pack_bf16x2(s.x, s.y);
  o.y = pack_bf16x2(s.z, s.w);
  *reinterpret_cast<uint2*>(out + ex * b.so + (size_t)m * b.ldo + n) = o;
}

template <class W, int MI>
constexpr int smem_bytes() {
  return W::kStages * (W::kWBytes + 8 * MI * W::kXStride * 2);
}

// Launch the tile walk over the batch b (and, with splits > 1, the fold)
// on stream st; returns the first cudaError_t, 0 on success.
template <class W, int MI>
int launch_tiles(const void* x, const void* q, const void* scale, void* out,
                 void* partial, int M, int K, int N, int group, int splits,
                 int split_k, const Batch& b, cudaStream_t st) {
  constexpr int bytes = smem_bytes<W, MI>();
  // above 48 KB a block takes dynamic shared memory only after this
  // opt-in; setting it twice from two threads is harmless
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmm_kernel<W, MI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  dim3 grid(N / kBN, (M + 8 * MI - 1) / (8 * MI), b.E * splits);
  qmm_kernel<W, MI><<<grid, kThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
      splits > 1 ? static_cast<float*>(partial) : nullptr, M, K, N, group,
      splits, split_k, b);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const int n4 = M * N / 4;
  qmm_reduce_kernel<!W::kGrouped>
      <<<dim3((n4 + 255) / 256, b.E), 256, 0, st>>>(
          static_cast<const float*>(partial),
          static_cast<const float*>(scale),
          static_cast<__nv_bfloat16*>(out), M, N, splits, b);
  return (int)cudaGetLastError();
}

// Shapes the tile walk takes (the wrapper's plan gives them): N a multiple
// of kBN, split_k a multiple of kBK (and of the group for K5), and the
// splits covering K exactly.
inline bool plan_ok(int M, int K, int N, int group, int splits,
                    int split_k, const void* partial) {
  return M > 0 && N % kBN == 0 && K % kBK == 0 && splits >= 1 &&
         split_k > 0 && split_k % kBK == 0 && split_k % group == 0 &&
         (long long)splits * split_k >= K &&
         (long long)(splits - 1) * split_k < K &&
         (splits == 1 || partial != nullptr);
}

}  // namespace qmm
}  // namespace localai
