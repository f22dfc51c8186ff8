// VP quantizers, one thread per element: f32 -> packed VP words, and
// f32 -> (significand, index) planes.
//
// Replace repro/kernels/vp_quant.py:vp_quant_packed_pallas (the Fig. 3
// cascade plus the (m << E) | i word assembly) and vp_quant_pallas (the
// same cascade into an int8/int16 significand plane and a uint8 index
// plane).  Both run vp_common.cuh:vp_quantize, so the cascade exists once.
//
// Bound: bytes.  Each element reads 4 bytes and writes 1-4 (packed) or
// 2-3 (planes), and does a few dozen integer operations, far below the
// card's operation rate.  Design: a grid-stride loop with neighbouring
// threads on neighbouring elements, so loads and stores coalesce; no
// shared memory is needed.
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

// x: n contiguous f32; m: n significands of `m_bytes` bytes each; i: n
// uint8 indices.  Returns the CUDA error of the launch (0 on success).
extern "C" int vp_quant_planes_launch(const void* x, void* m, int m_bytes,
                                      void* i, long long n,
                                      const QuantFmt* q, void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  uint8_t* iu = (uint8_t*)i;
  switch (m_bytes) {
    case 1:
      vp_quant_planes_kernel<int8_t><<<(int)blocks, threads, 0, s>>>(
          xf, (int8_t*)m, iu, n, *q);
      break;
    case 2:
      vp_quant_planes_kernel<int16_t><<<(int)blocks, threads, 0, s>>>(
          xf, (int16_t*)m, iu, n, *q);
      break;
    case 4:
      vp_quant_planes_kernel<int32_t><<<(int)blocks, threads, 0, s>>>(
          xf, (int32_t*)m, iu, n, *q);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
