// Packed VP quantizer: f32 -> packed VP words, one thread per element.
//
// Replaces repro/kernels/vp_quant.py:vp_quant_packed_pallas (the
// Fig. 3 cascade plus the (m << E) | i word assembly).
//
// Bound: bytes.  Each element reads 4 bytes and writes 1-4, and does a
// few dozen integer operations, far below the card's operation rate.
// Design: a grid-stride loop with neighbouring threads on neighbouring
// elements, so loads and stores coalesce; no shared memory is needed.
#include "vp_common.cuh"

template <typename OutT>
__global__ void vp_quant_packed_kernel(const float* __restrict__ x,
                                       OutT* __restrict__ w, long long n,
                                       QuantFmt q) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += stride) {
    w[idx] = (OutT)vp_quantize_pack(x[idx], q);
  }
}

// x: n contiguous f32; w: n contiguous words of `out_bytes` bytes each.
// Returns the CUDA error of the launch (0 on success).
extern "C" int vp_quant_packed_launch(const void* x, void* w, long long n,
                                      int out_bytes, const QuantFmt* q,
                                      void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  switch (out_bytes) {
    case 1:
      vp_quant_packed_kernel<int8_t><<<(int)blocks, threads, 0, s>>>(
          xf, (int8_t*)w, n, *q);
      break;
    case 2:
      vp_quant_packed_kernel<int16_t><<<(int)blocks, threads, 0, s>>>(
          xf, (int16_t*)w, n, *q);
      break;
    case 4:
      vp_quant_packed_kernel<int32_t><<<(int)blocks, threads, 0, s>>>(
          xf, (int32_t*)w, n, *q);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
