// Paged GQA decode attention for Hopper (sm_90a), one query token per slot.
//
// Replaces the Pallas TPU kernel localai_tpu/ops/attention.py::
// paged_decode_attention (kernel _paged_decode_kernel, loop _flash_loop)
// for bf16 and f32 block pools. Same math: q is pre-scaled by hd^-0.5 in
// f32; slot s walks its block table from lo to nb = min(pos/bt + 1, MB)
// (lo skips blocks wholly below a sliding window); each physical block is
// one online-softmax step over bt positions masked by idx <= pos and
// idx > pos - window with a -1e30 fill; the result is acc / max(l, 1e-30).
//
// Bound: decode attention moves each live K/V row once and does ~4*g
// flops per element it reads (g = Hq/Hkv query rows share a KV head), far
// below the card's ~295 flop/byte ridge — it is bound by device-memory
// bytes: (live K/V blocks + q + out) / 3.35 TB/s.
//
// Design for that bound, kept simple for a first version:
//   * one CUDA block per (slot, kv-head), so the g query rows of a GQA
//     group share every K/V tile they read (K/V is read exactly once);
//   * each [bt, hd] K and V tile is staged in shared memory with 16-byte
//     cp.async copies, double-buffered: the copy of table entry i+1 is in
//     flight while entry i is folded into the softmax;
//   * scores, the running max/denominator and the accumulator stay in
//     f32 (one output column per thread), nothing else touches memory.
// Not done yet (later work): wgmma/TMA, and a split of the block walk
// over several CUDA blocks with a log-sum-exp merge — S*Hkv blocks
// underfill the 132 SMs at small batch.
//
// Plain C interface (bound with ctypes); launches on the caller's stream
// and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;  // H100 opt-in shared memory per block

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

// Shared-memory bytes for one block: two stages of K and V tiles, the
// pre-scaled q rows, the score/probability tile and per-row statistics.
template <typename T, int HD, int G>
__host__ __device__ constexpr size_t smem_bytes(int bt) {
  return 4 * (size_t)bt * HD * sizeof(T) + (size_t)G * HD * 4 +
         (size_t)G * bt * 4 + 3 * (size_t)G * 4;
}

template <typename T, int HD, int G>
__global__ void __launch_bounds__(HD) paged_decode_kernel(
    const T* __restrict__ q,             // [S, Hq, HD]
    const T* __restrict__ k_pool,        // [N, Hkv, bt, HD]
    const T* __restrict__ v_pool,        // [N, Hkv, bt, HD]
    const int* __restrict__ tables,      // [S, MB]
    const int* __restrict__ positions,   // [S]
    T* __restrict__ out,                 // [S, Hq, HD]
    int Hkv, int bt, int MB, int window, float sm_scale) {
  constexpr int kWarps = HD / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kbuf = reinterpret_cast<T*>(smem_raw);             // [2][bt][HD]
  T* vbuf = kbuf + 2 * bt * HD;                         // [2][bt][HD]
  float* qs = reinterpret_cast<float*>(vbuf + 2 * bt * HD);  // [G][HD]
  float* ps = qs + G * HD;                              // [G][bt]
  float* row_m = ps + G * bt;                           // [G]
  float* row_l = row_m + G;                             // [G]
  float* row_alpha = row_l + G;                         // [G]

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int Hq = Hkv * G;
  const int pos = positions[s];
  const int nb = min(pos / bt + 1, MB);
  int lo = 0;
  if (window > 0) {
    const int first = pos - window + 1;  // floor-divide, clamped at 0
    lo = first > 0 ? first / bt : 0;
  }

  const T* qrow = q + ((size_t)s * Hq + (size_t)h * G) * HD;
#pragma unroll
  for (int r = 0; r < G; ++r) qs[r * HD + tid] = to_f32(qrow[r * HD + tid]) * sm_scale;
  if (tid < G) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }

  const int tile = bt * HD;                                   // elements
  const int vec16 = tile * (int)sizeof(T) / 16;               // 16B chunks
  auto issue = [&](int i, int stage) {
    const int blk = tables[(size_t)s * MB + i];
    const size_t base = ((size_t)blk * Hkv + h) * (size_t)tile;
    const char* ksrc = reinterpret_cast<const char*>(k_pool + base);
    const char* vsrc = reinterpret_cast<const char*>(v_pool + base);
    char* kdst = reinterpret_cast<char*>(kbuf + stage * tile);
    char* vdst = reinterpret_cast<char*>(vbuf + stage * tile);
    for (int e = tid; e < vec16; e += HD) {
      __pipeline_memcpy_async(kdst + 16 * e, ksrc + 16 * e, 16);
      __pipeline_memcpy_async(vdst + 16 * e, vsrc + 16 * e, 16);
    }
    __pipeline_commit();
  };

  float acc[G];
#pragma unroll
  for (int r = 0; r < G; ++r) acc[r] = 0.f;

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
    const T* kt = kbuf + stage * tile;
    const T* vt = vbuf + stage * tile;

    // scores: warp w takes positions j = w, w + kWarps, ...; lanes split hd
    for (int j = warp; j < bt; j += kWarps) {
      float part[G];
#pragma unroll
      for (int r = 0; r < G; ++r) part[r] = 0.f;
#pragma unroll
      for (int d = lane; d < HD; d += 32) {
        const float kv = to_f32(kt[j * HD + d]);
#pragma unroll
        for (int r = 0; r < G; ++r) part[r] += qs[r * HD + d] * kv;
      }
      const int idx = i * bt + j;
      const bool keep = idx <= pos && (window <= 0 || idx > pos - window);
#pragma unroll
      for (int r = 0; r < G; ++r) {
        const float sc = warp_sum(part[r]);
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
        ps[r * bt + j] = p;
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
      const float vv = to_f32(vt[j * HD + tid]);
#pragma unroll
      for (int r = 0; r < G; ++r) acc[r] += ps[r * bt + j] * vv;
    }
    __syncthreads();  // the next issue() overwrites this stage's tiles
  }

  T* orow = out + ((size_t)s * Hq + (size_t)h * G) * HD;
#pragma unroll
  for (int r = 0; r < G; ++r)
    orow[r * HD + tid] = from_f32<T>(acc[r] / fmaxf(row_l[r], 1e-30f));
}

template <typename T, int HD, int G>
int launch(const void* q, const void* k, const void* v, const void* tables,
           const void* positions, void* out, int S, int Hkv, int bt, int MB,
           int window, float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD, G>(bt);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, HD, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(S, Hkv);
  paged_decode_kernel<T, HD, G><<<grid, HD, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<T*>(out), Hkv, bt, MB,
      window, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_g(int G, const void* q, const void* k, const void* v,
             const void* tables, const void* positions, void* out, int S,
             int Hkv, int bt, int MB, int window, float sm_scale,
             cudaStream_t stream) {
  switch (G) {
    case 1: return launch<T, HD, 1>(q, k, v, tables, positions, out, S, Hkv, bt, MB, window, sm_scale, stream);
    case 2: return launch<T, HD, 2>(q, k, v, tables, positions, out, S, Hkv, bt, MB, window, sm_scale, stream);
    case 4: return launch<T, HD, 4>(q, k, v, tables, positions, out, S, Hkv, bt, MB, window, sm_scale, stream);
    case 8: return launch<T, HD, 8>(q, k, v, tables, positions, out, S, Hkv, bt, MB, window, sm_scale, stream);
    default: return -1;
  }
}

template <typename T>
int launch_hd(int hd, int G, const void* q, const void* k, const void* v,
              const void* tables, const void* positions, void* out, int S,
              int Hkv, int bt, int MB, int window, float sm_scale,
              cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_g<T, 32>(G, q, k, v, tables, positions, out, S, Hkv, bt, MB, window, sm_scale, stream);
    case 64: return launch_g<T, 64>(G, q, k, v, tables, positions, out, S, Hkv, bt, MB, window, sm_scale, stream);
    case 128: return launch_g<T, 128>(G, q, k, v, tables, positions, out, S, Hkv, bt, MB, window, sm_scale, stream);
    default: return -1;
  }
}

}  // namespace

// Returns 0 on success, a cudaError_t after a failed launch, or -1 for a
// (head_dim, group, dtype) combination that was not compiled.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* positions, void* out, int S, int Hq, int Hkv, int hd, int bt,
    int MB, int window, int is_bf16, float sm_scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv) return -1;
  const int G = Hq / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_hd<__nv_bfloat16>(hd, G, q, k_pool, v_pool, tables,
                                    positions, out, S, Hkv, bt, MB, window,
                                    sm_scale, st);
  return launch_hd<float>(hd, G, q, k_pool, v_pool, tables, positions, out,
                          S, Hkv, bt, MB, window, sm_scale, st);
}
