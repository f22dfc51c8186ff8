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
// Storage: int8 significand planes (with uint8 indices), and packed words
// of 1 or 2 bytes: what the port's VP(M <= 8) formats produce.
//
// Bound: bytes.  Each element reads 1 or 2 bytes (plus the 1-byte index of
// the planes layout) and writes 2 or 4, with a handful of integer
// operations.  The planes kernel: a grid-stride loop, one element per
// thread and step, neighbouring threads on neighbouring elements.  The
// packed kernel's first design did the same with 1- or 2-byte loads and
// the select chain for the scale (31 % / 19 % of its f32 / bf16 byte
// bound, PERF.md row 7); it now reads 16 bytes a thread step (8 int16 or
// 16 int8 words, two steps in flight), takes each scale from a K-entry
// table in shared memory, and stores 16-byte vectors: 32 or 64 bytes of
// f32, 16 or 32 of bf16, a step.  A scalar head runs up to the words'
// first 16-byte boundary and a scalar tail covers the rest past the last
// whole step; the grid (kernels/vp_dequant.py:plan_packed) is at most
// one wave of resident blocks.
#include "vp_common.cuh"

namespace {

template <typename OT>
__device__ __forceinline__ OT vp_scaled(int m, float scale) {
  const float mo = vp_to_float(vp_from_float<OT>((float)m));
  return vp_from_float<OT>(mo * scale);
}

template <typename OT>
__global__ void vp_dequant_planes_kernel(const int8_t* __restrict__ m,
                                         const uint8_t* __restrict__ i,
                                         OT* __restrict__ out, long long n,
                                         VPFmt f) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += stride) {
    out[idx] = vp_scaled<OT>((int)m[idx], vp_scale_of_index((int)i[idx], f));
  }
}

// N (8 or 16) values in 16-byte stores to 16-byte aligned p.
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N; q += 4)
    *reinterpret_cast<float4*>(p + q) =
        make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
}

template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const __nv_bfloat16 (&v)[N]) {
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

constexpr int DQ_UNROLL = 2;   // vector steps a thread has in flight

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

// The planes kernel's grid: one thread per element, at most 16 blocks
// of 256 per SM of an H100.
int grid_of(long long n) {
  long long blocks = (n + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return blocks < 1 ? 1 : (int)blocks;
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

// m: n int8 significands; i: n uint8 indices; out: n values of out_dtype.
// Returns the CUDA error of the launch.
extern "C" int vp_dequant_planes_launch(const void* m, const void* i,
                                        void* out, long long n, int out_dtype,
                                        const VPFmt* f, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* mm = (const int8_t*)m;
  const uint8_t* iu = (const uint8_t*)i;
  switch (out_dtype) {
    case VP_F32:
      vp_dequant_planes_kernel<float><<<grid_of(n), 256, 0, s>>>(
          mm, iu, (float*)out, n, *f);
      break;
    case VP_BF16:
      vp_dequant_planes_kernel<__nv_bfloat16><<<grid_of(n), 256, 0, s>>>(
          mm, iu, (__nv_bfloat16*)out, n, *f);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// w: n packed words of `w_bytes` (1 or 2) bytes each, the first `head`
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
  }
  return (int)cudaErrorInvalidValue;
}
