// VP quantizers: f32 -> packed VP words (two bodies, and a mode that
// takes each row's pow2 scale first), and f32 -> (significand, index)
// planes.
//
// Replace repro/kernels/vp_quant.py:vp_quant_packed_pallas (the Fig. 3
// cascade plus the (m << E) | i word assembly) and vp_quant_pallas (the
// same cascade into an int8/int16 significand plane and a uint8 index
// plane).
//
// Packed words (kernels/vp_quant.py: packed_body picks the body from
// the format, plan_packed the grid).  Bound: bytes, 4 read and 1-4
// written per element, once the cascade costs a few instructions: the
// select chain of vp_common.cuh:vp_quantize_raw runs all VP_CHAIN_K = 16
// steps for every element (~160 integer instructions; a format of E 5-7
// continues it over its table in device memory), which made the
// first design (one element per thread) issue-bound at 4.3x its byte
// bound.  The table body takes the index in O(1)
// (vp_common.cuh:vp_quantize_raw_tab, one shared-memory load; ~15
// instructions an element) and reads 2.4x its byte bound on the H100
// (chip_smoke.py, PERF.md: about what a streaming pass reaches behind
// the timer's dirty L2); the chain body keeps vp_quantize_raw for the
// formats the table does not serve (kernels/vp_quant.py:table_ok).  Both
// move 8 elements per thread and step in two 16-byte loads and one
// 8-32-byte store, with a scalar tail for a ragged or unaligned tensor.
//
// KV mode (vp_quant_packed_kv_kernel): x (rows, g) in f32 or bf16 ->
// words and one f32 scale per row, s = exp2f(ceilf(log2f(fmaxf(amax|x|,
// 1e-30f)))), the words of f32(x) / s: what repro/models/attention.py:
// _kv_scale and quantize_kv do before the Pallas kernel, in one launch
// instead of ~10.  One warp per row, held in registers: the amax by a
// shuffle tree, then the words.  An all-zero row gets 2^-99, as the plain
// version does.
//
// Planes (vp_quant_planes_{table,chain}_kernel): the packed bodies'
// loop with two outputs, an int8/int16/int32 significand plane and a
// uint8 index plane.  Bound: bytes, 4 read and 2-5 written per element.
// The first design (vp_quant_planes_kernel, one element per thread, the
// select chain, 1-byte stores) was issue-bound at 3.1x its byte bound
// (PERF.md row 5); it stays reachable only through the launcher's body
// code 2, so chip_smoke.py can time it beside the redesign.  Each thread
// step takes 8 elements in two 16-byte loads, the index from the table
// in shared memory (the chain for formats without one), and stores 8
// significands in one 8-32-byte store and 8 indices in one 8-byte store,
// with a scalar tail for a ragged or unaligned tensor.
#include "vp_common.cuh"

namespace {

constexpr int QP_VEC = 8;   // elements of one thread step

template <bool TABLE>
__device__ __forceinline__ int quant_word(float v, const QuantFmt& q,
                                          const int* tab) {
  if constexpr (TABLE) {
    int m, i;
    vp_quantize_raw_tab(vp_fxp_raw(v, q), tab, q.vp.m_lo, q.vp.m_hi, m, i);
    return (int)(((unsigned)m << q.vp.E) | (unsigned)i);
  } else {
    return vp_quantize_pack(v, q);
  }
}

// Eight consecutive values as f32 from 16-byte aligned memory.
__device__ __forceinline__ void load8(const float* p, float (&v)[QP_VEC]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[QP_VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
  }
}

// x: n f32; w: n words.  vec: x 16-byte aligned (w is a fresh tensor).
template <bool TABLE, typename OutT>
__device__ __forceinline__ void quant_packed(const float* __restrict__ x,
                                             OutT* __restrict__ w,
                                             long long n, int vec,
                                             const QuantFmt& q) {
  __shared__ int tab[VP_IDX_TAB];
  if constexpr (TABLE) {
    vp_index_table(tab, q);
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nv = vec ? n / QP_VEC : 0;
  for (long long g = t0; g < nv; g += stride) {
    float v[QP_VEC];
    int o[QP_VEC];
    load8(x + g * QP_VEC, v);
#pragma unroll
    for (int k = 0; k < QP_VEC; ++k) o[k] = quant_word<TABLE>(v[k], q, tab);
    vp_store8(w + g * QP_VEC, o);
  }
  for (long long e = nv * QP_VEC + t0; e < n; e += stride)   // the tail
    w[e] = (OutT)quant_word<TABLE>(x[e], q, tab);
}

template <typename OutT>
__global__ void vp_quant_packed_table_kernel(const float* __restrict__ x,
                                             OutT* __restrict__ w,
                                             long long n, int vec,
                                             const QuantFmt q) {
  quant_packed<true>(x, w, n, vec, q);
}

template <typename OutT>
__global__ void vp_quant_packed_chain_kernel(const float* __restrict__ x,
                                             OutT* __restrict__ w,
                                             long long n, int vec,
                                             const QuantFmt q) {
  quant_packed<false>(x, w, n, vec, q);
}

// KV mode: one warp per row of g elements.  vec: g % 8 == 0 and x, w
// 16-byte aligned.  A row of at most KV_REG elements (the path's 512) is
// loaded once into registers, its loads issued before the index table is
// built; a longer or unaligned one is read twice (cache-hot).  A
// power-of-two s divides as the exact multiplication by 1 / s.
constexpr int KV_V = 4;                       // 8-element steps of a lane
constexpr int KV_REG = 32 * QP_VEC * KV_V;

// The words of a held row over s (POW2: times the exact 1 / s).
template <bool TABLE, bool POW2, typename OutT>
__device__ __forceinline__ void kv_words(const float (&v)[KV_V][QP_VEC],
                                         float s, int lane, int g, OutT* wr,
                                         const QuantFmt& q, const int* tab) {
  const float inv = 1.f / s;
#pragma unroll
  for (int j = 0; j < KV_V; ++j) {
    const int c = (lane + 32 * j) * QP_VEC;
    if (c < g) {
      int o[QP_VEC];
#pragma unroll
      for (int k = 0; k < QP_VEC; ++k)
        o[k] = quant_word<TABLE>(POW2 ? v[j][k] * inv : v[j][k] / s, q, tab);
      vp_store8(wr + c, o);
    }
  }
}

template <bool TABLE, typename XT, typename OutT>
__global__ void vp_quant_packed_kv_kernel(const XT* __restrict__ x,
                                          OutT* __restrict__ w,
                                          float* __restrict__ scale,
                                          int rows, int g, int vec,
                                          const QuantFmt q) {
  __shared__ int tab[VP_IDX_TAB];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const XT* xr = x + (long long)row * g;
  OutT* wr = w + (long long)row * g;
  const bool held = vec && g <= KV_REG;
  float v[KV_V][QP_VEC];
#pragma unroll
  for (int j = 0; j < KV_V; ++j) {
    const int c = (lane + 32 * j) * QP_VEC;
    if (held && row < rows && c < g) {
      load8(xr + c, v[j]);
    } else {
#pragma unroll
      for (int k = 0; k < QP_VEC; ++k) v[j][k] = 0.f;
    }
  }
  if constexpr (TABLE) vp_index_table(tab, q);
  __syncthreads();
  if (row >= rows) return;
  float a = 0.f;
  if (held) {
#pragma unroll
    for (int j = 0; j < KV_V; ++j)
#pragma unroll
      for (int k = 0; k < QP_VEC; ++k) a = fmaxf(a, fabsf(v[j][k]));
  } else {
    const int gv = vec ? g / QP_VEC * QP_VEC : 0;
    for (int c = lane * QP_VEC; c < gv; c += 32 * QP_VEC) {
      float u[QP_VEC];
      load8(xr + c, u);
#pragma unroll
      for (int k = 0; k < QP_VEC; ++k) a = fmaxf(a, fabsf(u[k]));
    }
    for (int c = gv + lane; c < g; c += 32)
      a = fmaxf(a, fabsf(vp_to_float(xr[c])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
  const float s = exp2f(ceilf(log2f(fmaxf(a, 1e-30f))));
  if (lane == 0) scale[row] = s;
  const unsigned su = __float_as_uint(s);
  if (held && (su & 0x007FFFFFu) == 0 && (su & 0x7F800000u) != 0) {
    kv_words<TABLE, true>(v, s, lane, g, wr, q, tab);
    return;
  }
  if (held) {
    kv_words<TABLE, false>(v, s, lane, g, wr, q, tab);
    return;
  }
  const int gv = vec ? g / QP_VEC * QP_VEC : 0;
  for (int c = lane * QP_VEC; c < gv; c += 32 * QP_VEC) {
    float u[QP_VEC];
    int o[QP_VEC];
    load8(xr + c, u);
#pragma unroll
    for (int k = 0; k < QP_VEC; ++k) o[k] = quant_word<TABLE>(u[k] / s, q, tab);
    vp_store8(wr + c, o);
  }
  for (int c = gv + lane; c < g; c += 32)
    wr[c] = (OutT)quant_word<TABLE>(vp_to_float(xr[c]) / s, q, tab);
}

template <typename OutT>
int packed_launch(const float* x, void* w, long long n, int vec,
                  const QuantFmt& q, int table, int blocks, int threads,
                  cudaStream_t s) {
  OutT* wo = static_cast<OutT*>(w);
  if (table)
    vp_quant_packed_table_kernel<OutT><<<blocks, threads, 0, s>>>(x, wo, n,
                                                                  vec, q);
  else
    vp_quant_packed_chain_kernel<OutT><<<blocks, threads, 0, s>>>(x, wo, n,
                                                                  vec, q);
  return (int)cudaGetLastError();
}

template <typename XT, typename OutT>
int kv_launch(const void* x, void* w, float* scale, int rows, int g, int vec,
              const QuantFmt& q, int table, int blocks, int threads,
              cudaStream_t s) {
  const XT* xt = static_cast<const XT*>(x);
  OutT* wo = static_cast<OutT*>(w);
  if (table)
    vp_quant_packed_kv_kernel<true, XT, OutT><<<blocks, threads, 0, s>>>(
        xt, wo, scale, rows, g, vec, q);
  else
    vp_quant_packed_kv_kernel<false, XT, OutT><<<blocks, threads, 0, s>>>(
        xt, wo, scale, rows, g, vec, q);
  return (int)cudaGetLastError();
}

template <typename XT>
int kv_launch_words(const void* x, void* w, float* scale, int rows, int g,
                    int vec, int out_bytes, const QuantFmt& q, int table,
                    int blocks, int threads, cudaStream_t s) {
  switch (out_bytes) {
    case 1:
      return kv_launch<XT, int8_t>(x, w, scale, rows, g, vec, q, table,
                                   blocks, threads, s);
    case 2:
      return kv_launch<XT, int16_t>(x, w, scale, rows, g, vec, q, table,
                                    blocks, threads, s);
    case 4:
      return kv_launch<XT, int32_t>(x, w, scale, rows, g, vec, q, table,
                                    blocks, threads, s);
  }
  return (int)cudaErrorInvalidValue;
}

bool valid_launch(int blocks, int threads) {
  return blocks >= 1 && threads >= 32 && threads <= 1024 && threads % 32 == 0;
}

}  // namespace

// x: n contiguous f32; w: n contiguous words of `out_bytes` bytes each.
// table: the table body (q->idx_tab filled), else the select chain.
// Returns the CUDA error of the launch (0 on success).
extern "C" int vp_quant_packed_launch(const void* x, void* w, long long n,
                                      int out_bytes, const QuantFmt* q,
                                      int table, int blocks, int threads,
                                      void* stream) {
  if (!valid_launch(blocks, threads)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const int vec = (uintptr_t)x % 16 == 0 && (uintptr_t)w % 16 == 0;
  switch (out_bytes) {
    case 1:
      return packed_launch<int8_t>(xf, w, n, vec, *q, table, blocks,
                                   threads, s);
    case 2:
      return packed_launch<int16_t>(xf, w, n, vec, *q, table, blocks,
                                    threads, s);
    case 4:
      return packed_launch<int32_t>(xf, w, n, vec, *q, table, blocks,
                                    threads, s);
  }
  return (int)cudaErrorInvalidValue;
}

// x: (rows, g) contiguous of x_dtype; w: (rows, g) words of `out_bytes`
// bytes; scale: rows f32.  One warp per row, threads / 32 rows a block.
extern "C" int vp_quant_packed_kv_launch(const void* x, void* w, void* scale,
                                         int rows, int g, int x_dtype,
                                         int out_bytes, const QuantFmt* q,
                                         int table, int blocks, int threads,
                                         void* stream) {
  if (!valid_launch(blocks, threads) || rows < 1 || g < 1 ||
      (long long)blocks * (threads / 32) < rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int esz = x_dtype == VP_BF16 ? 2 : 4;
  const int vec = g % QP_VEC == 0 && (uintptr_t)x % 16 == 0 &&
                  (uintptr_t)w % 16 == 0 && (long long)g * esz % 16 == 0;
  float* sc = static_cast<float*>(scale);
  if (x_dtype == VP_F32)
    return kv_launch_words<float>(x, w, sc, rows, g, vec, out_bytes, *q,
                                  table, blocks, threads, s);
  if (x_dtype == VP_BF16)
    return kv_launch_words<__nv_bfloat16>(x, w, sc, rows, g, vec, out_bytes,
                                          *q, table, blocks, threads, s);
  return (int)cudaErrorInvalidValue;
}

template <bool TABLE>
__device__ __forceinline__ void quant_mi(float v, const QuantFmt& q,
                                         const int* tab, int& m, int& i) {
  if constexpr (TABLE)
    vp_quantize_raw_tab(vp_fxp_raw(v, q), tab, q.vp.m_lo, q.vp.m_hi, m, i);
  else
    vp_quantize(v, q, m, i);
}

// x: n f32; m: n significands; i: n indices.  vec: x 16-byte aligned, m
// and i aligned to their 8-element stores.
template <bool TABLE, typename MT>
__device__ __forceinline__ void quant_planes(const float* __restrict__ x,
                                             MT* __restrict__ m,
                                             uint8_t* __restrict__ i,
                                             long long n, int vec,
                                             const QuantFmt& q) {
  __shared__ int tab[VP_IDX_TAB];
  if constexpr (TABLE) {
    vp_index_table(tab, q);
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nv = vec ? n / QP_VEC : 0;
  for (long long g = t0; g < nv; g += stride) {
    float v[QP_VEC];
    int mv[QP_VEC], iv[QP_VEC];
    load8(x + g * QP_VEC, v);
#pragma unroll
    for (int k = 0; k < QP_VEC; ++k)
      quant_mi<TABLE>(v[k], q, tab, mv[k], iv[k]);
    vp_store8(m + g * QP_VEC, mv);
    vp_store8(reinterpret_cast<int8_t*>(i + g * QP_VEC), iv);
  }
  for (long long e = nv * QP_VEC + t0; e < n; e += stride) {   // the tail
    int mv, iv;
    quant_mi<TABLE>(x[e], q, tab, mv, iv);
    m[e] = (MT)mv;
    i[e] = (uint8_t)iv;
  }
}

template <typename MT>
__global__ void vp_quant_planes_table_kernel(const float* __restrict__ x,
                                             MT* __restrict__ m,
                                             uint8_t* __restrict__ i,
                                             long long n, int vec,
                                             const QuantFmt q) {
  quant_planes<true>(x, m, i, n, vec, q);
}

template <typename MT>
__global__ void vp_quant_planes_chain_kernel(const float* __restrict__ x,
                                             MT* __restrict__ m,
                                             uint8_t* __restrict__ i,
                                             long long n, int vec,
                                             const QuantFmt q) {
  quant_planes<false>(x, m, i, n, vec, q);
}

// The first design, one element per thread (kept for comparison only).
template <typename MT>
__global__ void vp_quant_planes_kernel(const float* __restrict__ x,
                                       MT* __restrict__ m,
                                       uint8_t* __restrict__ i, long long n,
                                       QuantFmt q) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += stride) {
    int mv, iv;
    vp_quantize(x[idx], q, mv, iv);
    m[idx] = (MT)mv;
    i[idx] = (uint8_t)iv;
  }
}

template <typename MT>
int planes_launch(const float* x, void* m, uint8_t* i, long long n,
                  const QuantFmt& q, int body, int blocks, int threads,
                  cudaStream_t s) {
  MT* mo = static_cast<MT*>(m);
  const int vec = (uintptr_t)x % 16 == 0 &&
                  (uintptr_t)m % (QP_VEC * sizeof(MT)) == 0 &&
                  (uintptr_t)i % QP_VEC == 0;
  if (body == 0) {
    vp_quant_planes_table_kernel<MT><<<blocks, threads, 0, s>>>(x, mo, i, n,
                                                                vec, q);
  } else if (body == 1) {
    vp_quant_planes_chain_kernel<MT><<<blocks, threads, 0, s>>>(x, mo, i, n,
                                                                vec, q);
  } else {   // the first design's own grid
    long long b = (n + 255) / 256;
    b = b > 132 * 16 ? 132 * 16 : b;
    vp_quant_planes_kernel<MT><<<(int)b, 256, 0, s>>>(x, mo, i, n, q);
  }
  return (int)cudaGetLastError();
}

// x: n contiguous f32; m: n significands of `m_bytes` bytes each; i: n
// uint8 indices.  body: 0 the table body (q->idx_tab filled), 1 the
// select chain, both on blocks x threads; 2 the first design (its own
// grid; comparisons only).  Returns the CUDA error of the launch.
extern "C" int vp_quant_planes_launch(const void* x, void* m, int m_bytes,
                                      void* i, long long n,
                                      const QuantFmt* q, int body,
                                      int blocks, int threads,
                                      void* stream) {
  if (!valid_launch(blocks, threads) || body < 0 || body > 2)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  uint8_t* iu = (uint8_t*)i;
  switch (m_bytes) {
    case 1:
      return planes_launch<int8_t>(xf, m, iu, n, *q, body, blocks, threads, s);
    case 2:
      return planes_launch<int16_t>(xf, m, iu, n, *q, body, blocks, threads,
                                    s);
    case 4:
      return planes_launch<int32_t>(xf, m, iu, n, *q, body, blocks, threads,
                                    s);
  }
  return (int)cudaErrorInvalidValue;
}
