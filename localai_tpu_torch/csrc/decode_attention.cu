// Contiguous-cache GQA decode attention for Hopper (sm_90a), one query
// token per slot.
//
// Replaces the Pallas TPU kernel localai_tpu/ops/attention.py::
// decode_attention (kernel _decode_kernel, loop _flash_loop) for bf16 and
// f32 slot caches and for scaled int8 caches. The cache is head-major
// [S, Hkv, C, hd] (int8 with f32 scales [S, Hkv, C] for K and for V); slot
// s attends over rows lo .. pos of its own [C, hd] row with the Pallas
// kernel's math: q pre-scaled by hd^-0.5 in f32, positions masked by
// idx <= pos and idx > pos - window with a -1e30 fill, result
// acc / max(l, 1e-30). The K scale multiplies score columns and the V
// scale probability columns after the denominator, as _flash_loop does.
// There is no int4 contiguous cache (the JAX runner refuses it).
//
// Bound: like the paged kernel, each live K/V row is read once for ~4*g
// flops per element, so it is bound by device-memory bytes:
// (live K/V rows and their scales + q + out) / 3.35 TB/s.
//
// One CUDA block per (slot, kv head) walking its rows alone was far from
// that bound: at 8 slots and 8 kv heads it put 64 blocks on 132 SMs, and
// the slot with the longest context folded its tiles one after another,
// so the kernel took the time of its longest serial walk. So the walk is
// split (flash-decoding), as the paged kernel's is, in two passes
// launched back to back on the caller's stream:
//   1. decode_kernel, grid (splits, Hkv, S): the cache row is cut into
//      kTile-row tiles, which play the part of the paged kernel's table
//      entries. Split k of slot s folds tiles [k*tps, (k+1)*tps) clamped
//      to the slot's walk [lo, nb) — tps, the tiles per split, comes from
//      a host-side plan that reads only shapes, never positions — and
//      writes its unnormalised (m[g], l[g], acc[g][hd]) in f32 to scratch
//      the wrapper allocated. A split with no live tile loads nothing and
//      writes (-1e30, 0, 0), the merge's identity. Clamping to [lo, nb)
//      keeps every folded tile holding a kept row (a wholly masked tile
//      would give p = exp(-1e30 + 1e30) = 1 and corrupt l). Inside a split
//      the walk is the single walk's: the g query rows of a GQA group
//      share every K/V tile; kTile-row K/V tiles are staged in shared
//      memory by double-buffered cp.async (the copy of tile i+1 is in
//      flight while tile i is folded); scores, running max, denominator
//      and accumulator stay in f32 (one output column per thread). A tile
//      that runs past C (C need not be a multiple of kTile) is
//      zero-filled; its rows are masked.
//   2. decode_kernel_merge, one block per (q head, slot), folds the splits
//      that hold a live tile of the slot (it reads the slot's position on
//      the device, as pass 1 does): with M = max_k m_k and
//      w_k = exp(m_k - M), out = sum_k w_k acc_k / max(sum_k w_k l_k,
//      1e-30). The V scale is already inside acc_k and not in l_k, so
//      both cache kinds merge alike.
// One split (tps = all tiles) computes what the single walk did. The walk
// and the merge are copies of the paged kernel's, not a shared header:
// moving that kernel onto a shared walk slowed it by 15-30% on the card
// with no change to its memory instructions. Not done yet: wgmma/TMA.
//
// GQA groups as in the paged kernel: pass 1 is compiled for G = 1, 2, 4,
// 8 and 16, and a group g of 1..16 runs on the smallest G >= g with rows
// r >= g masked (no q load, no partial written; partials and the merge's
// grid laid out by g). Masked rows cost FMAs under a bytes-bound walk;
// one instantiation a group would quadruple this source's nvcc time.
//
// Plain C interface (bound with ctypes); launches both passes on the
// caller's stream and returns cudaGetLastError() after each launch.

#include "common.cuh"

namespace {

using localai::from_f32;
using localai::to_f32;

constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;  // H100 opt-in shared memory per block
constexpr int kTile = 64;         // cache rows per online-softmax step

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

// Cache storage: Q = 0 holds T (the compute dtype), Q = 1 scaled int8.
template <typename T, int Q, int HD>
struct Rows {
  static constexpr int kRowBytes = Q == 0 ? HD * (int)sizeof(T) : HD;

  // element d of row j of a staged tile, as f32 (unscaled)
  __device__ static __forceinline__ float load(const unsigned char* tile,
                                               int j, int d) {
    if constexpr (Q == 0) {
      return to_f32(reinterpret_cast<const T*>(tile)[j * HD + d]);
    } else {
      return static_cast<float>(
          reinterpret_cast<const int8_t*>(tile)[j * HD + d]);
    }
  }
};

// Shared-memory bytes for one block: two stages of K and V tiles (and of
// their scale rows for an int8 cache), the pre-scaled q rows, the
// score/probability tile and per-row statistics.
template <typename T, int Q, int HD, int G>
constexpr size_t smem_bytes() {
  return 4 * (size_t)kTile * Rows<T, Q, HD>::kRowBytes +
         (Q ? 4 * (size_t)kTile * 4 : 0) + (size_t)G * HD * 4 +
         (size_t)G * kTile * 4 + 3 * (size_t)G * 4;
}

// 16 bytes from src to dst, or 16 zero bytes (a chunk past the cache's
// last row). Each call passes a constant zero-fill count: a runtime one
// makes the intrinsic switch over every count per copy.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool live) {
  if (live) {
    __pipeline_memcpy_async(dst, src, 16);
  } else {
    __pipeline_memcpy_async(dst, src, 16, 16);
  }
}

// The walk of a slot at position pos: tiles [lo, nb), with
// nb = min(pos/kTile + 1, ntiles) and lo the first tile that holds a row
// inside the sliding window (0 without one).
__device__ __forceinline__ int2 walk_range(int pos, int ntiles, int window) {
  const int nb = min(pos / kTile + 1, ntiles);
  int lo = 0;
  if (window > 0) {
    const int first = pos - window + 1;  // floor-divide, clamped at 0
    lo = first > 0 ? first / kTile : 0;
  }
  return make_int2(lo, nb);
}

template <typename T, int Q, int HD, int G>
__global__ void __launch_bounds__(HD) decode_kernel(
    const T* __restrict__ q,             // [S, Hq, HD]
    const void* __restrict__ k_cache,    // [S, Hkv, C, row] (row: Rows)
    const void* __restrict__ v_cache,    // [S, Hkv, C, row]
    const float* __restrict__ k_scale,   // [S, Hkv, C] (Q != 0)
    const float* __restrict__ v_scale,   // [S, Hkv, C] (Q != 0)
    const int* __restrict__ positions,   // [S]
    float* __restrict__ part_m,          // [S, Hkv, splits, g]
    float* __restrict__ part_l,          // [S, Hkv, splits, g]
    float* __restrict__ part_acc,        // [S, Hkv, splits, g, HD]
    int Hkv, int g, int C, int window, int tps, float sm_scale) {
  using Tile = Rows<T, Q, HD>;
  constexpr int kWarps = HD / 32;
  constexpr int tile = kTile * Tile::kRowBytes;         // bytes
  constexpr int vec16 = tile / 16;                      // 16B chunks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* kbuf = smem_raw;                       // [2][tile]
  unsigned char* vbuf = kbuf + 2 * tile;                // [2][tile]
  float* ksb = reinterpret_cast<float*>(vbuf + 2 * tile);  // [2][kTile]
  float* vsb = ksb + (Q ? 2 * kTile : 0);               // [2][kTile]
  float* qs = vsb + (Q ? 2 * kTile : 0);                // [G][HD]
  float* ps = qs + G * HD;                              // [G][kTile]
  float* row_m = ps + G * kTile;                        // [G]
  float* row_l = row_m + G;                             // [G]
  float* row_alpha = row_l + G;                         // [G]

  const int k = blockIdx.x;  // split
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int pos = positions[s];
  const int2 walk = walk_range(pos, (C + kTile - 1) / kTile, window);
  // this split's share of the walk [lo, nb)
  const int b0 = max(walk.x, k * tps);
  const int b1 = min(walk.y, k * tps + tps);
  const size_t row = (size_t)s * Hkv + h;  // this (slot, head)'s C rows
  const size_t slot_part = row * gridDim.x + k;  // (s, h, k)
  float* acc_out = part_acc + slot_part * g * HD;
  if (b0 >= b1) {  // no live tile: the merge's identity, no tile load
#pragma unroll
    for (int r = 0; r < G; ++r)
      if (r < g) acc_out[r * HD + tid] = 0.f;
    if (tid < g) {
      part_m[slot_part * g + tid] = kNegInf;
      part_l[slot_part * g + tid] = 0.f;
    }
    return;
  }
  const char* kb = static_cast<const char*>(k_cache) + row * C * Tile::kRowBytes;
  const char* vb = static_cast<const char*>(v_cache) + row * C * Tile::kRowBytes;

  // rows r >= g (a group run on a larger compiled G) load no q
  const T* qrow = q + row * g * HD;
#pragma unroll
  for (int r = 0; r < G; ++r)
    qs[r * HD + tid] = r < g ? to_f32(qrow[r * HD + tid]) * sm_scale : 0.f;
  if (tid < G) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }

  auto issue = [&](int i, int stage) {
    const int first = i * kTile;
    const int live16 = min(kTile, C - first) * Tile::kRowBytes / 16;
    const char* ksrc = kb + (size_t)first * Tile::kRowBytes;
    const char* vsrc = vb + (size_t)first * Tile::kRowBytes;
    unsigned char* kdst = kbuf + stage * tile;
    unsigned char* vdst = vbuf + stage * tile;
    if (live16 == vec16) {  // every tile but a ragged last one
      for (int e = tid; e < vec16; e += HD) {
        __pipeline_memcpy_async(kdst + 16 * e, ksrc + 16 * e, 16);
        __pipeline_memcpy_async(vdst + 16 * e, vsrc + 16 * e, 16);
      }
    } else {
      for (int e = tid; e < vec16; e += HD) {
        const bool live = e < live16;
        copy16(kdst + 16 * e, ksrc + (live ? 16 * e : 0), live);
        copy16(vdst + 16 * e, vsrc + (live ? 16 * e : 0), live);
      }
    }
    if constexpr (Q != 0) {
      // kTile floats in 16B chunks; C % 4 == 0, so a chunk is all live
      const float* kss = k_scale + row * C + first;
      const float* vss = v_scale + row * C + first;
      for (int e = tid; e < kTile / 4; e += HD) {
        const bool live = first + 4 * e < C;
        copy16(ksb + stage * kTile + 4 * e, kss + (live ? 4 * e : 0), live);
        copy16(vsb + stage * kTile + 4 * e, vss + (live ? 4 * e : 0), live);
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
    const float* ks = ksb + stage * kTile;
    const float* vs = vsb + stage * kTile;

    // scores: warp w takes positions j = w, w + kWarps, ...; lanes split hd
    for (int j = warp; j < kTile; j += kWarps) {
      float dot[G];
#pragma unroll
      for (int r = 0; r < G; ++r) dot[r] = 0.f;
#pragma unroll
      for (int d = lane; d < HD; d += 32) {
        const float kv = Tile::load(kt, j, d);
#pragma unroll
        for (int r = 0; r < G; ++r) dot[r] += qs[r * HD + d] * kv;
      }
      const int idx = i * kTile + j;
      const bool keep = idx <= pos && idx < C &&
                        (window <= 0 || idx > pos - window);
#pragma unroll
      for (int r = 0; r < G; ++r) {
        float sc = warp_sum(dot[r]);
        if constexpr (Q != 0) sc *= ks[j];  // K scale on the score column
        if (lane == 0) ps[r * kTile + j] = keep ? sc : kNegInf;
      }
    }
    __syncthreads();

    // online-softmax statistics: warp w takes rows r = w, w + kWarps, ...
    for (int r = warp; r < G; r += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < kTile; j += 32) mx = fmaxf(mx, ps[r * kTile + j]);
      mx = warp_max(mx);
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < kTile; j += 32) {
        const float p = expf(ps[r * kTile + j] - m_new);
        // the denominator takes the raw probability, the weighted values
        // the V-scaled one
        if constexpr (Q != 0) {
          ps[r * kTile + j] = p * vs[j];
        } else {
          ps[r * kTile + j] = p;
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
    for (int j = 0; j < kTile; ++j) {
      const float vv = Tile::load(vt, j, tid);
#pragma unroll
      for (int r = 0; r < G; ++r) acc[r] += ps[r * kTile + j] * vv;
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
// folds splits [lo/tps, (nb-1)/tps], the ones pass 1 found live.
template <typename T, int HD>
__global__ void __launch_bounds__(HD) decode_kernel_merge(
    const float* __restrict__ part_m,    // [S, Hkv, splits, g]
    const float* __restrict__ part_l,    // [S, Hkv, splits, g]
    const float* __restrict__ part_acc,  // [S, Hkv, splits, g, HD]
    const int* __restrict__ positions,   // [S]
    T* __restrict__ out,                 // [S, Hq, HD]
    int g, int splits, int C, int window, int tps) {
  const int hq = blockIdx.x;  // q head = kv head * g + r
  const int s = blockIdx.y;
  const int Hq = gridDim.x;
  const int h = hq / g;
  const int r = hq - h * g;
  const int2 walk =
      walk_range(positions[s], (C + kTile - 1) / kTile, window);
  const int k0 = walk.x / tps;
  const int k1 = walk.x < walk.y ? (walk.y - 1) / tps + 1 : k0;
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
  const void *q, *k, *v, *ks, *vs, *positions;
  float *part_m, *part_l, *part_acc;
  void* out;
  int S, Hkv, g, C, window, tps, splits;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, int Q, int HD, int G>
int launch(const Args& a) {
  constexpr size_t smem = smem_bytes<T, Q, HD, G>();
  static_assert(smem <= (size_t)kMaxSmem, "tiles exceed shared memory");
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, Q, HD, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(a.splits, a.Hkv, a.S);
  decode_kernel<T, Q, HD, G><<<grid, HD, smem, a.stream>>>(
      static_cast<const T*>(a.q), a.k, a.v, static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.positions),
      a.part_m, a.part_l, a.part_acc, a.Hkv, a.g, a.C, a.window, a.tps,
      a.sm_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // one block per (q head, slot): Hq = Hkv * g, the partials' layout
  decode_kernel_merge<T, HD><<<dim3(a.Hkv * a.g, a.S), HD, 0, a.stream>>>(
      a.part_m, a.part_l, a.part_acc, static_cast<const int*>(a.positions),
      static_cast<T*>(a.out), a.g, a.splits, a.C, a.window, a.tps);
  return (int)cudaGetLastError();
}

// group a.g on the smallest compiled G >= a.g (rows r >= a.g masked)
template <typename T, int Q, int HD>
int launch_g(const Args& a) {
  if (a.g <= 1) return launch<T, Q, HD, 1>(a);
  if (a.g <= 2) return launch<T, Q, HD, 2>(a);
  if (a.g <= 4) return launch<T, Q, HD, 4>(a);
  if (a.g <= 8) return launch<T, Q, HD, 8>(a);
  if (a.g <= 16) return launch<T, Q, HD, 16>(a);
  return -1;
}

template <typename T, int Q>
int launch_hd(int hd, const Args& a) {
  switch (hd) {
    case 32: return launch_g<T, Q, 32>(a);
    case 64: return launch_g<T, Q, 64>(a);
    case 128: return launch_g<T, Q, 128>(a);
    default: return -1;
  }
}

}  // namespace

// quantized: 0 = the cache holds q's dtype (k_scale/v_scale unused),
// 1 = scaled int8 (C must be a multiple of 4: scale rows move in 16-byte
// chunks). part is f32 scratch of S*Hq*splits*(hd + 2) floats: m and l
// [S, Hkv, splits, g] each, then acc [S, Hkv, splits, g, hd], with
// g = Hq / Hkv, 1..16. The splits
// of tiles_per_split kTile-row tiles must cover the ceil(C / kTile) tiles
// exactly. Returns 0 on success, a cudaError_t after a failed launch, or
// -1 for a (head_dim, group, dtype) combination that was not compiled or
// a split plan or grid the kernels cannot take.
extern "C" int decode_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* positions,
    void* part, void* out, int S, int Hq, int Hkv, int hd, int C,
    int window, int tiles_per_split, int splits, int is_bf16, int quantized,
    float sm_scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || C <= 0) return -1;
  if (quantized && C % 4) return -1;
  const int ntiles = (C + kTile - 1) / kTile;
  if (S < 1 || S > 65535 || Hkv > 65535 || tiles_per_split < 1 ||
      splits < 1 || (long long)(splits - 1) * tiles_per_split >= ntiles ||
      (long long)splits * tiles_per_split < ntiles)
    return -1;
  const int g = Hq / Hkv;
  float* part_m = static_cast<float*>(part);
  const size_t n = (size_t)S * Hq * splits;  // (slot, kv head, split, row)
  const Args a{q, k_cache, v_cache, k_scale, v_scale, positions,
               part_m, part_m + n, part_m + 2 * n, out, S, Hkv, g, C, window,
               tiles_per_split, splits, sm_scale,
               static_cast<cudaStream_t>(stream)};
  if (is_bf16) {
    return quantized ? launch_hd<__nv_bfloat16, 1>(hd, a)
                     : launch_hd<__nv_bfloat16, 0>(hd, a);
  }
  return quantized ? launch_hd<float, 1>(hd, a)
                   : launch_hd<float, 0>(hd, a);
}
