// VP dequantizers, one thread per element: (significand, index) planes
// -> reals, and packed VP words -> reals.
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
// operations.  Design: a grid-stride loop with neighbouring threads on
// neighbouring elements, so loads and stores coalesce; no shared memory.
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

template <typename WT, typename OT>
__global__ void vp_dequant_packed_kernel(const WT* __restrict__ w,
                                         OT* __restrict__ out, long long n,
                                         VPFmt f) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += stride) {
    const int v = (int)w[idx];
    out[idx] = vp_scaled<OT>(v >> f.E, vp_scale_of_index(v & (f.K - 1), f));
  }
}

int grid_of(long long n) {
  long long blocks = (n + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return blocks < 1 ? 1 : (int)blocks;
}

template <typename WT>
int packed_out(const void* w, void* out, long long n, int out_dtype,
               const VPFmt& f, cudaStream_t s) {
  switch (out_dtype) {
    case VP_F32:
      vp_dequant_packed_kernel<WT, float><<<grid_of(n), 256, 0, s>>>(
          (const WT*)w, (float*)out, n, f);
      break;
    case VP_BF16:
      vp_dequant_packed_kernel<WT, __nv_bfloat16><<<grid_of(n), 256, 0, s>>>(
          (const WT*)w, (__nv_bfloat16*)out, n, f);
      break;
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

// w: n packed words of `w_bytes` (1 or 2) bytes each; out: n values of
// out_dtype.  Returns the CUDA error of the launch.
extern "C" int vp_dequant_packed_launch(const void* w, int w_bytes, void* out,
                                        long long n, int out_dtype,
                                        const VPFmt* f, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (w_bytes) {
    case 1: return packed_out<int8_t>(w, out, n, out_dtype, *f, s);
    case 2: return packed_out<int16_t>(w, out, n, out_dtype, *f, s);
  }
  return (int)cudaErrorInvalidValue;
}
