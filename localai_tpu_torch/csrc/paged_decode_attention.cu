// Paged GQA decode attention for Hopper (sm_90a), one query token per slot.
//
// Replaces the Pallas TPU kernel localai_tpu/ops/attention.py::
// paged_decode_attention (kernel _paged_decode_kernel, loop _flash_loop)
// for bf16 and f32 block pools and for scaled int8 and int4 pools. Same
// math: q is pre-scaled by hd^-0.5 in f32; slot s walks its block table
// from lo to nb = min(pos/bt + 1, MB) (lo skips blocks wholly below a
// sliding window); each physical block is one online-softmax step over bt
// positions masked by idx <= pos and idx > pos - window with a -1e30
// fill; the result is acc / max(l, 1e-30).
//
// Quantized pools (q and out stay bf16/f32): int8 [N, Hkv, bt, hd], or
// int4 nibble-packed [N, Hkv, bt, hd/2] in the halves layout (byte i of a
// row holds element i in its low nibble and element i + hd/2 in its high
// nibble), each with f32 scales [N, Hkv, bt] for K and for V. The scales
// are applied the way _flash_loop applies them, not by dequantizing the
// tiles: the K scale multiplies the score columns (q.(k*s) = (q.k)*s),
// the V scale multiplies the probability columns after the denominator
// took the raw probabilities (p@(v*s) = (p*s)@v). The block's [bt] scale
// rows ride the same cp.async stage as its K/V tile; int4 nibbles are
// unpacked in registers as the tile is read.
//
// Bound: decode attention moves each live K/V row once and does ~4*g
// flops per element it reads (g = Hq/Hkv query rows share a KV head), far
// below the card's ~295 flop/byte ridge — it is bound by device-memory
// bytes: (live K/V blocks and their scales + q + out) / 3.35 TB/s. An
// int8 pool halves the bf16 bytes, an int4 pool quarters them.
//
// A walk of one CUDA block per (slot, kv head) is far from that bound: at
// 8 slots and 8 kv heads it puts 64 blocks on 132 SMs, and the slot with
// the longest context folds its tiles one after another (four barriers
// and one cp.async stage of look-ahead per tile), so the kernel takes the
// time of its longest serial walk. So the walk is split (flash-decoding),
// in two passes launched back to back on the caller's stream:
//   1. paged_decode_kernel, grid (splits, Hkv, S): split k of slot s
//      folds table entries [k*bps, (k+1)*bps) clamped to [lo, nb) —
//      bps, the blocks per split, comes from a host-side plan that reads
//      only shapes, never positions — and writes its unnormalised
//      (m[g], l[g], acc[g][hd]) in f32 to scratch the wrapper allocated.
//      A split with no live block loads nothing and writes (-1e30, 0, 0),
//      the merge's identity: the merge skips it, but every split's scratch
//      then holds a defined state.
//      Clamping to [lo, nb) keeps every folded tile holding a kept row (a
//      wholly masked tile would give p = exp(-1e30 + 1e30) = 1 and corrupt
//      l). Inside a split the walk is the single walk's:
//        * the g query rows of a GQA group share every K/V tile (K/V is
//          read exactly once over all splits);
//        * each [bt, hd] K and V tile is staged in shared memory with
//          16-byte cp.async copies, double-buffered: the copy of entry
//          i+1 is in flight while entry i is folded into the softmax;
//        * scores, the running max/denominator and the accumulator stay
//          in f32 (one output column per thread).
//   2. paged_decode_kernel_merge, one block per (slot, q head), folds the
//      splits that hold a live block of the slot — it reads the slot's
//      position on the device, as pass 1 does, so the host never needs
//      it: with M = max_k m_k and w_k = exp(m_k - M),
//      out = sum_k w_k acc_k / max(sum_k w_k l_k, 1e-30). An empty split
//      would add w_k * 0 to both sums, so leaving it out changes nothing
//      but the merge's serial loop, which a positions-blind plan sized for
//      full tables would otherwise run over every split of a short slot.
//      The V scale is already inside acc_k and not in l_k, so every pool
//      merges alike.
// The scratch costs 4*(hd + 2) bytes per (split, q head), written once and
// read at most once: 4.3 MB at the serving shape's 32 splits of 8 slots x
// 32 q heads, against 134 MB of bf16 K/V in full tables. One split
// (bps = MB) computes what the single walk did. Not done yet: wgmma/TMA.
//
// GQA groups: the group is the template parameter G of pass 1 (the
// length of the per-thread acc[G] and dot[G] registers and of the q and
// score rows in shared memory), compiled for G = 1, 2, 4, 8 and 16. A
// group g of 1..16 runs on the smallest compiled G >= g with rows r >= g
// masked: such a row loads no q (its q row is zero, so its scores and
// statistics stay finite) and writes no partial, and the partials and the
// merge's grid are laid out by g, not G. Masking, not one instantiation a
// group: the kernel is bound by the K/V bytes, which every row shares, so
// a masked row costs only its FMAs, while sixteen groups would quadruple
// this source's instantiations (3 head dims x 3 pools x 2 dtypes each) and
// its nvcc time, which every run on a fresh machine pays at first use.
//
// Plain C interface (bound with ctypes); launches both passes on the
// caller's stream and returns cudaGetLastError() after each launch.

#include "common.cuh"

namespace {

using localai::from_f32;
using localai::to_f32;

constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;  // H100 opt-in shared memory per block

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

// The walk of a slot at position pos: table entries [lo, nb), with
// nb = min(pos/bt + 1, MB) and lo the first entry that holds a row inside
// the sliding window (0 without one).
__device__ __forceinline__ int2 walk_range(int pos, int bt, int MB,
                                           int window) {
  const int nb = min(pos / bt + 1, MB);
  int lo = 0;
  if (window > 0) {
    const int first = pos - window + 1;  // floor-divide, clamped at 0
    lo = first > 0 ? first / bt : 0;
  }
  return make_int2(lo, nb);
}

// Pool storage: P = 0 holds T (the compute dtype), P = 1 scaled int8,
// P = 2 scaled int4 (halves layout).
template <typename T, int P, int HD>
struct Pool {
  static constexpr int kRowBytes =
      P == 0 ? HD * (int)sizeof(T) : (P == 1 ? HD : HD / 2);

  // element d of row j of a staged tile, as f32 (unscaled)
  __device__ static __forceinline__ float load(const unsigned char* tile,
                                               int j, int d) {
    if constexpr (P == 0) {
      return to_f32(reinterpret_cast<const T*>(tile)[j * HD + d]);
    } else if constexpr (P == 1) {
      return static_cast<float>(
          reinterpret_cast<const int8_t*>(tile)[j * HD + d]);
    } else {
      constexpr int kHalf = HD / 2;
      const bool hi = d >= kHalf;
      const int b = reinterpret_cast<const int8_t*>(
          tile)[j * kHalf + (hi ? d - kHalf : d)];
      return static_cast<float>(
          hi ? b >> 4 : static_cast<int>(static_cast<unsigned>(b) << 28) >> 28);
    }
  }
};

// Shared-memory bytes for one block: two stages of K and V tiles (and of
// their scale rows for a quantized pool), the pre-scaled q rows, the
// score/probability tile and per-row statistics.
template <typename T, int P, int HD, int G>
__host__ __device__ constexpr size_t smem_bytes(int bt) {
  return 4 * (size_t)bt * Pool<T, P, HD>::kRowBytes +
         (P ? 4 * (size_t)bt * 4 : 0) + (size_t)G * HD * 4 +
         (size_t)G * bt * 4 + 3 * (size_t)G * 4;
}

template <typename T, int P, int HD, int G>
__global__ void __launch_bounds__(HD) paged_decode_kernel(
    const T* __restrict__ q,             // [S, Hq, HD]
    const void* __restrict__ k_pool,     // [N, Hkv, bt, row] (row: Pool)
    const void* __restrict__ v_pool,     // [N, Hkv, bt, row]
    const float* __restrict__ k_scale,   // [N, Hkv, bt] (P != 0)
    const float* __restrict__ v_scale,   // [N, Hkv, bt] (P != 0)
    const int* __restrict__ tables,      // [S, MB]
    const int* __restrict__ positions,   // [S]
    float* __restrict__ part_m,          // [S, Hkv, splits, g]
    float* __restrict__ part_l,          // [S, Hkv, splits, g]
    float* __restrict__ part_acc,        // [S, Hkv, splits, g, HD]
    int Hkv, int g, int bt, int MB, int window, int bps, float sm_scale) {
  using Tile = Pool<T, P, HD>;
  constexpr int kWarps = HD / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile = bt * Tile::kRowBytes;                // bytes
  unsigned char* kbuf = smem_raw;                       // [2][tile]
  unsigned char* vbuf = kbuf + 2 * tile;                // [2][tile]
  float* ksb = reinterpret_cast<float*>(vbuf + 2 * tile);  // [2][bt]
  float* vsb = ksb + (P ? 2 * bt : 0);                  // [2][bt]
  float* qs = vsb + (P ? 2 * bt : 0);                   // [G][HD]
  float* ps = qs + G * HD;                              // [G][bt]
  float* row_m = ps + G * bt;                           // [G]
  float* row_l = row_m + G;                             // [G]
  float* row_alpha = row_l + G;                         // [G]

  const int k = blockIdx.x;  // split
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int Hq = Hkv * g;
  const int pos = positions[s];
  const int2 walk = walk_range(pos, bt, MB, window);
  // this split's share of the walk [lo, nb)
  const int b0 = max(walk.x, k * bps);
  const int b1 = min(walk.y, k * bps + bps);
  const size_t slot_part = ((size_t)s * Hkv + h) * gridDim.x + k;  // (s,h,k)
  float* acc_out = part_acc + slot_part * g * HD;
  if (b0 >= b1) {  // no live block: the merge's identity, no tile load
#pragma unroll
    for (int r = 0; r < G; ++r)
      if (r < g) acc_out[r * HD + tid] = 0.f;
    if (tid < g) {
      part_m[slot_part * g + tid] = kNegInf;
      part_l[slot_part * g + tid] = 0.f;
    }
    return;
  }

  // rows r >= g (a group run on a larger compiled G) load no q
  const T* qrow = q + ((size_t)s * Hq + (size_t)h * g) * HD;
#pragma unroll
  for (int r = 0; r < G; ++r)
    qs[r * HD + tid] = r < g ? to_f32(qrow[r * HD + tid]) * sm_scale : 0.f;
  if (tid < G) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }

  const int vec16 = tile / 16;                                // 16B chunks
  auto issue = [&](int i, int stage) {
    const int blk = tables[(size_t)s * MB + i];
    const size_t row = (size_t)blk * Hkv + h;                 // (blk, h)
    const char* ksrc = static_cast<const char*>(k_pool) + row * tile;
    const char* vsrc = static_cast<const char*>(v_pool) + row * tile;
    unsigned char* kdst = kbuf + stage * tile;
    unsigned char* vdst = vbuf + stage * tile;
    for (int e = tid; e < vec16; e += HD) {
      __pipeline_memcpy_async(kdst + 16 * e, ksrc + 16 * e, 16);
      __pipeline_memcpy_async(vdst + 16 * e, vsrc + 16 * e, 16);
    }
    if constexpr (P != 0) {
      for (int e = tid; e < bt / 4; e += HD) {  // bt floats, 16B chunks
        __pipeline_memcpy_async(ksb + stage * bt + 4 * e,
                                k_scale + row * bt + 4 * e, 16);
        __pipeline_memcpy_async(vsb + stage * bt + 4 * e,
                                v_scale + row * bt + 4 * e, 16);
      }
    }
    __pipeline_commit();
  };

  float acc[G];
#pragma unroll
  for (int r = 0; r < G; ++r) acc[r] = 0.f;

  issue(b0, 0);
  for (int i = b0; i < b1; ++i) {
    const int stage = (i - b0) & 1;
    if (i + 1 < b1) {
      issue(i + 1, stage ^ 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const unsigned char* kt = kbuf + stage * tile;
    const unsigned char* vt = vbuf + stage * tile;
    const float* ks = ksb + stage * bt;
    const float* vs = vsb + stage * bt;

    // scores: warp w takes positions j = w, w + kWarps, ...; lanes split hd
    for (int j = warp; j < bt; j += kWarps) {
      float dot[G];
#pragma unroll
      for (int r = 0; r < G; ++r) dot[r] = 0.f;
#pragma unroll
      for (int d = lane; d < HD; d += 32) {
        const float kv = Tile::load(kt, j, d);
#pragma unroll
        for (int r = 0; r < G; ++r) dot[r] += qs[r * HD + d] * kv;
      }
      const int idx = i * bt + j;
      const bool keep = idx <= pos && (window <= 0 || idx > pos - window);
#pragma unroll
      for (int r = 0; r < G; ++r) {
        float sc = warp_sum(dot[r]);
        if constexpr (P != 0) sc *= ks[j];  // K scale on the score column
        if (lane == 0) ps[r * bt + j] = keep ? sc : kNegInf;
      }
    }
    __syncthreads();

    // online-softmax statistics: warp w takes rows r = w, w + kWarps, ...
    for (int r = warp; r < G; r += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < bt; j += 32) mx = fmaxf(mx, ps[r * bt + j]);
      mx = warp_max(mx);
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < bt; j += 32) {
        const float p = expf(ps[r * bt + j] - m_new);
        // the denominator takes the raw probability, the weighted values
        // the V-scaled one
        if constexpr (P != 0) {
          ps[r * bt + j] = p * vs[j];
        } else {
          ps[r * bt + j] = p;
        }
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        row_alpha[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc[r] (column tid) = acc * alpha + p @ v
#pragma unroll
    for (int r = 0; r < G; ++r) acc[r] *= row_alpha[r];
    for (int j = 0; j < bt; ++j) {
      const float vv = Tile::load(vt, j, tid);
#pragma unroll
      for (int r = 0; r < G; ++r) acc[r] += ps[r * bt + j] * vv;
    }
    __syncthreads();  // the next issue() overwrites this stage's tiles
  }

#pragma unroll
  for (int r = 0; r < G; ++r)
    if (r < g) acc_out[r * HD + tid] = acc[r];
  if (tid < g) {
    part_m[slot_part * g + tid] = row_m[tid];
    part_l[slot_part * g + tid] = row_l[tid];
  }
}

// Pass 2: one block per (q head, slot), one output column per thread;
// folds splits [lo/bps, (nb-1)/bps], the ones pass 1 found live.
template <typename T, int HD>
__global__ void __launch_bounds__(HD) paged_decode_kernel_merge(
    const float* __restrict__ part_m,    // [S, Hkv, splits, g]
    const float* __restrict__ part_l,    // [S, Hkv, splits, g]
    const float* __restrict__ part_acc,  // [S, Hkv, splits, g, HD]
    const int* __restrict__ positions,   // [S]
    T* __restrict__ out,                 // [S, Hq, HD]
    int g, int splits, int bt, int MB, int window, int bps) {
  const int hq = blockIdx.x;  // q head = kv head * g + r
  const int s = blockIdx.y;
  const int Hq = gridDim.x;
  const int h = hq / g;
  const int r = hq - h * g;
  const int2 walk = walk_range(positions[s], bt, MB, window);
  const int k0 = walk.x / bps;
  const int k1 = walk.x < walk.y ? (walk.y - 1) / bps + 1 : k0;
  const size_t first = ((size_t)s * (Hq / g) + h) * splits;  // part (s, h, 0)
  float mx = kNegInf;
  for (int k = k0; k < k1; ++k)
    mx = fmaxf(mx, part_m[(first + k) * g + r]);
  float num = 0.f, den = 0.f;
  for (int k = k0; k < k1; ++k) {
    const size_t i = (first + k) * g + r;
    const float w = expf(part_m[i] - mx);
    num += w * part_acc[i * HD + threadIdx.x];
    den += w * part_l[i];
  }
  out[((size_t)s * Hq + hq) * HD + threadIdx.x] =
      from_f32<T>(num / fmaxf(den, 1e-30f));
}

// everything a launch needs besides the compile-time choices
struct Args {
  const void *q, *k, *v, *ks, *vs, *tables, *positions;
  float *part_m, *part_l, *part_acc;
  void* out;
  int S, Hkv, g, bt, MB, window, bps, splits;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, int P, int HD, int G>
int launch(const Args& a) {
  const size_t smem = smem_bytes<T, P, HD, G>(a.bt);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, P, HD, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(a.splits, a.Hkv, a.S);
  paged_decode_kernel<T, P, HD, G><<<grid, HD, smem, a.stream>>>(
      static_cast<const T*>(a.q), a.k, a.v, static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.positions), a.part_m, a.part_l, a.part_acc,
      a.Hkv, a.g, a.bt, a.MB, a.window, a.bps, a.sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // one block per (q head, slot): Hq = Hkv * g, the partials' layout
  paged_decode_kernel_merge<T, HD><<<dim3(a.Hkv * a.g, a.S), HD, 0,
                                     a.stream>>>(
      a.part_m, a.part_l, a.part_acc, static_cast<const int*>(a.positions),
      static_cast<T*>(a.out), a.g, a.splits, a.bt, a.MB, a.window, a.bps);
  return (int)cudaGetLastError();
}

// group a.g on the smallest compiled G >= a.g (rows r >= a.g masked)
template <typename T, int P, int HD>
int launch_g(const Args& a) {
  if (a.g <= 1) return launch<T, P, HD, 1>(a);
  if (a.g <= 2) return launch<T, P, HD, 2>(a);
  if (a.g <= 4) return launch<T, P, HD, 4>(a);
  if (a.g <= 8) return launch<T, P, HD, 8>(a);
  if (a.g <= 16) return launch<T, P, HD, 16>(a);
  return -1;
}

template <typename T, int P>
int launch_hd(int hd, const Args& a) {
  switch (hd) {
    case 32: return launch_g<T, P, 32>(a);
    case 64: return launch_g<T, P, 64>(a);
    case 128: return launch_g<T, P, 128>(a);
    default: return -1;
  }
}

template <typename T>
int launch_pool(int pool, int hd, const Args& a) {
  switch (pool) {
    case 0: return launch_hd<T, 0>(hd, a);
    case 1: return launch_hd<T, 1>(hd, a);
    case 2: return launch_hd<T, 2>(hd, a);
    default: return -1;
  }
}

}  // namespace

// pool: 0 = the pool holds q's dtype (k_scale/v_scale unused), 1 = scaled
// int8, 2 = scaled int4 (halves layout, last dim hd/2).
// part is f32 scratch of S*Hq*splits*(hd + 2) floats: m and l
// [S, Hkv, splits, g] each, then acc [S, Hkv, splits, g, hd], with
// g = Hq / Hkv, 1..16. The splits
// of blocks_per_split table entries must cover [0, MB) exactly:
// (splits - 1) * blocks_per_split < MB <= splits * blocks_per_split.
// Returns 0 on success, a cudaError_t after a failed launch, or -1 for a
// (pool, head_dim, group, dtype) combination that was not compiled or a
// split plan or grid the kernels cannot take.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* positions, void* part, void* out, int S, int Hq, int Hkv,
    int hd, int bt, int MB, int window, int blocks_per_split, int splits,
    int is_bf16, int pool, float sm_scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv) return -1;
  if (pool != 0 && bt % 4) return -1;  // scale rows move in 16B chunks
  if (S < 1 || S > 65535 || Hkv > 65535 || MB < 1 || blocks_per_split < 1 ||
      splits < 1 || (long long)(splits - 1) * blocks_per_split >= MB ||
      (long long)splits * blocks_per_split < MB)
    return -1;
  const int g = Hq / Hkv;
  float* part_m = static_cast<float*>(part);
  const size_t n = (size_t)S * Hq * splits;  // (slot, kv head, split, row)
  const Args a{q, k_pool, v_pool, k_scale, v_scale, tables, positions,
               part_m, part_m + n, part_m + 2 * n, out, S, Hkv, g, bt, MB,
               window, blocks_per_split, splits, sm_scale,
               static_cast<cudaStream_t>(stream)};
  if (is_bf16) return launch_pool<__nv_bfloat16>(pool, hd, a);
  return launch_pool<float>(pool, hd, a);
}
