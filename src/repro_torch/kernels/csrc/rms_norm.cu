// RMSNorm of each row in one launch: out = x * rsqrt(mean(x^2) + eps) *
// (1 + gamma), in f32, stored in x's dtype.
//
// The reference's `models/layers.py:rms_norm` is plain jnp, which XLA
// fuses into one kernel; PyTorch's ops take about nine launches, and its
// mean spreads one row over more threads when a launch holds fewer rows,
// so a decode row's bits would depend on its batch.  Here one warp takes
// one row: lane l sums the squares of columns l, l + 32, ... in order,
// then a butterfly over the 32 lanes (lanes l and l ^ o add; every lane
// ends with the sum of halving the 32 partial sums five times).  That
// order depends on the row's width alone, never on the number of rows,
// and the plain version (`ref.rms_norm_ref`) takes it too: every step is
// one IEEE-rounded add, multiply, divide or square root (no contraction
// into FMA, no approximate rsqrt), so the two agree bit for bit.
//
// x is (rows, D), row-major; gamma is (g_rows, D) and row r takes its
// gamma row r % g_rows (a per-head gamma of shape (H, N) over rows of
// (..., H, N)).  Element types by code: 0 f32, 1 bf16.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define RN_WARPS 8   // rows of a block (kernels/rms_norm.py:RN_WARPS)

__device__ __forceinline__ float rn_load(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float rn_load(const __nv_bfloat16* p,
                                         long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void rn_store(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void rn_store(__nv_bfloat16* p, long long i,
                                         float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename TX, typename TG>
__global__ void __launch_bounds__(RN_WARPS * 32)
rms_norm_kernel(const TX* __restrict__ x, const TG* __restrict__ gamma,
                TX* __restrict__ out, long long rows, int D, int g_rows,
                float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * RN_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long base = row * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float v = rn_load(x, base + c);
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  const float var = __fadd_rn(__fdiv_rn(acc, (float)D), eps);
  const float r = __fdiv_rn(1.f, __fsqrt_rn(var));
  const long long gbase = (row % g_rows) * (long long)D;
  for (int c = lane; c < D; c += 32) {
    const float v = __fmul_rn(rn_load(x, base + c), r);
    rn_store(out, base + c,
             __fmul_rn(v, __fadd_rn(1.f, rn_load(gamma, gbase + c))));
  }
}

template <typename TX, typename TG>
static int launch(const void* x, const void* gamma, void* out,
                  long long rows, int D, int g_rows, float eps, int blocks,
                  cudaStream_t s) {
  rms_norm_kernel<TX, TG><<<blocks, RN_WARPS * 32, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TG*>(gamma),
      static_cast<TX*>(out), rows, D, g_rows, eps);
  return (int)cudaGetLastError();
}

extern "C" int rms_norm_launch(const void* x, int x_dtype, const void* gamma,
                               int g_dtype, void* out, long long rows, int D,
                               int g_rows, float eps, int blocks,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0 && g_dtype == 0)
    return launch<float, float>(x, gamma, out, rows, D, g_rows, eps, blocks,
                                s);
  if (x_dtype == 0 && g_dtype == 1)
    return launch<float, __nv_bfloat16>(x, gamma, out, rows, D, g_rows, eps,
                                        blocks, s);
  if (x_dtype == 1 && g_dtype == 0)
    return launch<__nv_bfloat16, float>(x, gamma, out, rows, D, g_rows, eps,
                                        blocks, s);
  if (x_dtype == 1 && g_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, gamma, out, rows, D,
                                                g_rows, eps, blocks, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* vp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
