// VP dequantizers: (significand, index) planes -> reals, and packed VP
// words -> reals.
//
// Replace repro/kernels/vp_dequant.py:vp_dequant_pallas (the Fig. 5
// shift mux, substrate.dequant_cascade) and vp_dequant_packed_pallas
// (unpack by shift and mask, then scale; substrate.dequant_packed).  The
// value is the significand cast to the output type times the pow2 scale
// in that type, the reference's order; the scale is a power of two, so
// the product is exact in f32 and its one rounding back to the output
// type is that type's own multiply.  Exact for VP(7, ...) in f32 and
// bf16, so both kernels are bit-identical to their plain versions.
//
// Storage: int8 or int16 significand planes (VP(M <= 8) and VP(9..16);
// core/vp_tensor.py:significand_dtype) with uint8 indices, and packed
// words of 1, 2 or 4 bytes (M + E > 16: int32): what the port's formats
// produce.
//
// Bound: bytes.  Each element reads 1 or 2 bytes (plus the 1-byte index of
// the planes layout) and writes 2 or 4, with a handful of integer
// operations.  Both kernels' first designs ran one element per thread and
// grid-stride step, with 1- or 2-byte loads and the select chain for the
// scale (the planes kernel at 21 % of its bf16 byte bound at a weight
// panel, the packed one at 31 % / 19 % in f32 / bf16; PERF.md rows 6-7).
// Both now read whole vectors a thread step: the packed kernel 16 bytes
// of words (4 int32, 8 int16 or 16 int8); the planes kernel 16 bytes of
// significands (8 int16, or 16 int8 to bf16) or 8 (8 int8 to f32, so that
// a step writes at most 32 bytes), with the step's indices in one 8- or
// 16-byte load.  Each scale comes from a K-entry table in shared memory,
// and the values go out in 16-byte stores.  A scalar head runs up to the
// first boundary of a step's load and a scalar tail covers the rest past
// the last whole step; where the index plane or the output is not aligned
// at the head's end (planes sliced at different offsets), the steps read
// the indices or store the values one by one.  The packed kernel's grid
// (kernels/vp_dequant.py:plan_packed) is at most one wave of resident
// blocks, two steps a thread in flight; the planes kernel's
// (plan_planes) gives each thread one step, as many blocks as that takes:
// on the card that ran faster than a one-wave grid at the MIMO planes and
// at a weight panel (chip_smoke.py times the grids side by side).
#include "vp_common.cuh"

namespace {

template <typename OT>
__device__ __forceinline__ OT vp_scaled(int m, float scale) {
  const float mo = vp_to_float(vp_from_float<OT>((float)m));
  return vp_from_float<OT>(mo * scale);
}

// N (4, 8 or 16) values in 16-byte stores to 16-byte aligned p.
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N; q += 4)
    *reinterpret_cast<float4*>(p + q) =
        make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
}

// N (4, 8 or 16) bf16 values to 16-byte aligned p (8-byte for N = 4:
// the 4 int32 words of one load).
template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const __nv_bfloat16 (&v)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(
        (uint32_t)__bfloat16_as_ushort(v[0]) |
            (uint32_t)__bfloat16_as_ushort(v[1]) << 16,
        (uint32_t)__bfloat16_as_ushort(v[2]) |
            (uint32_t)__bfloat16_as_ushort(v[3]) << 16);
  } else {
#pragma unroll
    for (int q = 0; q < N; q += 8) {
      uint32_t u[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        u[k] = (uint32_t)__bfloat16_as_ushort(v[q + 2 * k]) |
               (uint32_t)__bfloat16_as_ushort(v[q + 2 * k + 1]) << 16;
      *reinterpret_cast<uint4*>(p + q) = make_uint4(u[0], u[1], u[2], u[3]);
    }
  }
}

constexpr int DQ_UNROLL = 2;   // steps in flight a packed-kernel thread

// NB (8 or 16) bytes as 32-bit words, read by one vector load.
template <int NB>
struct Bytes {
  uint32_t x[NB / 4];
};

template <int NB>
__device__ __forceinline__ Bytes<NB> load_bytes(const void* p) {
  Bytes<NB> r;
  if constexpr (NB == 16) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
    r.x[0] = u.x, r.x[1] = u.y, r.x[2] = u.z, r.x[3] = u.w;
  } else {
    const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
    r.x[0] = u.x, r.x[1] = u.y;
  }
  return r;
}

// Significands a vector step of the planes kernel takes: 16 bytes of
// them, or fewer where their values would pass 32 bytes (int8 to f32: 8
// significands, 32 bytes out).  A warp's store then spans 32-byte
// strides, not 64 (at 64 the MIMO planes ran at 43 % of their bound
// against 70 % at 32; PERF.md row 6).
template <typename MT, typename OT>
__host__ __device__ constexpr int planes_vec() {
  return 16 / sizeof(MT) < 32 / sizeof(OT) ? 16 / sizeof(MT)
                                           : 32 / sizeof(OT);
}

// m, i: n significands and their indices, the first `head` before m's
// first boundary of a step's load (V significands: m + head aligned to
// V * sizeof(MT) bytes); ivec: i + head is aligned to V bytes for the
// step's index load, else the steps read the indices one by one; ovec:
// out + head is 16-byte aligned, else the steps store their values one
// by one.  A grid-stride loop of one step an iteration: any grid covers
// every step.
template <typename MT, typename OT>
__global__ void vp_dequant_planes_kernel(const MT* __restrict__ m,
                                         const uint8_t* __restrict__ i,
                                         OT* __restrict__ out, long long n,
                                         int head, int ivec, int ovec,
                                         VPFmt f) {
  constexpr int V = planes_vec<MT, OT>();
  constexpr int MB = V * (int)sizeof(MT);   // bytes of significands a step
  constexpr int PW = 4 / (int)sizeof(MT);   // significands a 32-bit word
  constexpr int B = 8 * (int)sizeof(MT), SH = 32 - B;
  __shared__ float stab[VP_MAX_K];
  vp_scale_table(stab, f);
  __syncthreads();
  const auto value = [&](int sig, int idx) {
    return vp_scaled<OT>(sig, vp_scale_lookup(idx, stab));
  };
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t0 < head) out[t0] = value((int)m[t0], (int)i[t0]);   // head < V
  const long long nv = (n - head) / V;
  const MT* mh = m + head;
  const uint8_t* ih = i + head;
  OT* oh = out + head;
  for (long long s = t0; s < nv; s += stride) {
    const Bytes<MB> u = load_bytes<MB>(mh + s * V);
    Bytes<V> x = {};
    if (ivec) x = load_bytes<V>(ih + s * V);
    OT o[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int sig = (int)(u.x[k / PW] << (SH - B * (k % PW))) >> SH;
      const int idx = ivec ? (int)((x.x[k >> 2] >> (8 * (k & 3))) & 0xffu)
                           : (int)ih[s * V + k];
      o[k] = value(sig, idx);
    }
    OT* dst = oh + s * V;
    if (ovec) {
      store_vec(dst, o);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) dst[k] = o[k];
    }
  }
  for (long long e = head + nv * V + t0; e < n; e += stride)   // the tail
    out[e] = value((int)m[e], (int)i[e]);
}

// w: n words, the first `head` of them before the first 16-byte boundary
// (w + head aligned); ovec: out + head is 16-byte aligned too (else the
// vector steps store their values one by one).
template <typename WT, typename OT>
__global__ void vp_dequant_packed_kernel(const WT* __restrict__ w,
                                         OT* __restrict__ out, long long n,
                                         int head, int ovec, VPFmt f) {
  constexpr int V = 16 / (int)sizeof(WT);   // words of one 16-byte load
  constexpr int B = 8 * (int)sizeof(WT), SH = 32 - B;
  __shared__ float stab[VP_MAX_K];
  vp_scale_table(stab, f);
  __syncthreads();
  const int mask = f.K - 1;
  const auto value = [&](int v) {
    return vp_scaled<OT>(v >> f.E, stab[v & mask]);
  };
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t0 < head) out[t0] = value((int)w[t0]);   // head < V <= stride
  const long long nv = (n - head) / V;
  const uint4* wv = reinterpret_cast<const uint4*>(w + head);
  OT* ov = out + head;
  for (long long s = t0; s < nv; s += DQ_UNROLL * stride) {
    uint4 u[DQ_UNROLL];
#pragma unroll
    for (int r = 0; r < DQ_UNROLL; ++r)
      u[r] = s + r * stride < nv ? __ldcs(wv + s + r * stride)
                                 : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int r = 0; r < DQ_UNROLL; ++r) {
      const long long sr = s + r * stride;
      if (sr >= nv) break;
      const uint32_t x[4] = {u[r].x, u[r].y, u[r].z, u[r].w};
      OT o[V];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int t = 0; t < V / 4; ++t)
          o[q * (V / 4) + t] = value((int)(x[q] << (SH - B * t)) >> SH);
      OT* dst = ov + sr * V;
      if (ovec) {
        store_vec(dst, o);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) dst[k] = o[k];
      }
    }
  }
  for (long long e = head + nv * V + t0; e < n; e += stride)   // the tail
    out[e] = value((int)w[e]);
}

template <typename MT, typename OT>
int planes_launch(const MT* m, const uint8_t* i, OT* o, long long n,
                  const VPFmt& f, int head, int blocks, int threads,
                  cudaStream_t s) {
  constexpr int V = planes_vec<MT, OT>();
  if (head < 0 || head >= V || blocks < 1 || threads < V ||
      threads > 1024 || threads % 32 ||
      (n > head && (uintptr_t)(m + head) % (V * sizeof(MT))))
    return (int)cudaErrorInvalidValue;
  vp_dequant_planes_kernel<MT, OT><<<blocks, threads, 0, s>>>(
      m, i, o, n, head, (uintptr_t)(i + head) % V == 0,
      (uintptr_t)(o + head) % 16 == 0, f);
  return (int)cudaGetLastError();
}

template <typename MT>
int planes_out(const void* m, const void* i, void* out, long long n,
               int out_dtype, const VPFmt& f, int head, int blocks,
               int threads, cudaStream_t s) {
  const MT* mt = (const MT*)m;
  const uint8_t* iu = (const uint8_t*)i;
  switch (out_dtype) {
    case VP_F32:
      return planes_launch(mt, iu, (float*)out, n, f, head, blocks, threads,
                           s);
    case VP_BF16:
      return planes_launch(mt, iu, (__nv_bfloat16*)out, n, f, head, blocks,
                           threads, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename WT>
int packed_out(const void* w, void* out, long long n, int out_dtype,
               const VPFmt& f, int head, int blocks, int threads,
               cudaStream_t s) {
  constexpr int V = 16 / (int)sizeof(WT);
  const WT* wt = (const WT*)w;
  if (head < 0 || head >= V || blocks < 1 || threads < V ||
      threads > 1024 || threads % 32 ||
      (n > head && (uintptr_t)(wt + head) % 16))
    return (int)cudaErrorInvalidValue;
  switch (out_dtype) {
    case VP_F32: {
      float* o = (float*)out;
      vp_dequant_packed_kernel<WT, float><<<blocks, threads, 0, s>>>(
          wt, o, n, head, (uintptr_t)(o + head) % 16 == 0, f);
      break;
    }
    case VP_BF16: {
      __nv_bfloat16* o = (__nv_bfloat16*)out;
      vp_dequant_packed_kernel<WT, __nv_bfloat16><<<blocks, threads, 0, s>>>(
          wt, o, n, head, (uintptr_t)(o + head) % 16 == 0, f);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// m: n significands of `m_bytes` (1: int8, 2: int16) bytes each, the
// first `head` of them before m's first boundary of a step's load (16
// bytes, 8 for int8 to f32: kernels/vp_dequant.py:planes_vec); i: n uint8
// indices; out: n values of out_dtype; the grid from
// kernels/vp_dequant.py:plan_planes.  Returns the CUDA error of the launch
// (cudaErrorInvalidValue for another width, a head that does not reach
// the boundary, or a grid the kernel does not take).
extern "C" int vp_dequant_planes_launch(const void* m, int m_bytes,
                                        const void* i, void* out, long long n,
                                        int out_dtype, const VPFmt* f,
                                        int head, int blocks, int threads,
                                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (m_bytes) {
    case 1:
      return planes_out<int8_t>(m, i, out, n, out_dtype, *f, head, blocks,
                                threads, s);
    case 2:
      return planes_out<int16_t>(m, i, out, n, out_dtype, *f, head, blocks,
                                 threads, s);
  }
  return (int)cudaErrorInvalidValue;
}

// w: n packed words of `w_bytes` (1, 2 or 4) bytes each, the first `head`
// of them before w's first 16-byte boundary; out: n values of out_dtype;
// the grid from kernels/vp_dequant.py:plan_packed.  Returns the CUDA
// error of the launch (cudaErrorInvalidValue for a head that does not
// reach the boundary, or a grid the kernel does not take).
extern "C" int vp_dequant_packed_launch(const void* w, int w_bytes, void* out,
                                        long long n, int out_dtype,
                                        const VPFmt* f, int head, int blocks,
                                        int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (w_bytes) {
    case 1:
      return packed_out<int8_t>(w, out, n, out_dtype, *f, head, blocks,
                                threads, s);
    case 2:
      return packed_out<int16_t>(w, out, n, out_dtype, *f, head, blocks,
                                 threads, s);
    case 4:
      return packed_out<int32_t>(w, out, n, out_dtype, *f, head, blocks,
                                 threads, s);
  }
  return (int)cudaErrorInvalidValue;
}
