// Serving matmul: x (M, K) reals @ dequant(w (K, N) packed VP words).
//
// Replaces repro/kernels/vp_dequant_matmul.py:vp_dequant_matmul_pallas.
// As there, the weight tile is unpacked (arithmetic >> E, & (K-1)) and
// scaled by 2^-f_i while it is staged on chip, so no float weight matrix
// ever exists in device memory; x is converted to f32 and the sum is an
// f32 FMA chain over k, cast to the output type at the end.  The
// per-tensor scale multiply stays outside (models/layers.py:qdot).
//
// Bound: at the decode shape (M = batch = 4) the kernel must read every
// packed word once, so it is bound by bytes (2 bytes per weight); at the
// prefill shape (M = 512) by operations.  Design of this first version:
// a plain 64 x 64 output tile per block, 16-deep k slices staged in
// shared memory, a 4 x 4 register tile per thread, CUDA-core FMAs (no
// tensor cores yet).  Ragged M/N/K are bounds-checked, not padded.  At
// M = 4 most of the 64 tile rows are empty, so the skinny case runs far
// from its byte bound; a split-K or skinny variant is later work.
#include "vp_common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

template <typename XT, typename WT, typename OT>
__global__ void __launch_bounds__(THREADS)
vp_dequant_matmul_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                         OT* __restrict__ out, int M, int K, int N, VPFmt f) {
  __shared__ float xs[BK][BM + 4];  // x tile, transposed: xs[k][m]
  __shared__ float ws[BK][BN + 4];  // dequantized weight tile

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      xs[c][r] = (gm < M && gk < K)
                     ? vp_to_float(x[(long long)gm * K + gk]) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      ws[r][c] = (gk < K && gn < N)
                     ? vp_dequant((int)w[(long long)gk * N + gn], f) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) out[(long long)gm * N + gn] = vp_from_float<OT>(acc[i][j]);
    }
  }
}

template <typename XT, typename WT, typename OT>
int launch(const void* x, const void* w, void* out, int M, int K, int N,
           const VPFmt& f, cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  vp_dequant_matmul_kernel<XT, WT, OT><<<grid, THREADS, 0, s>>>(
      (const XT*)x, (const WT*)w, (OT*)out, M, K, N, f);
  return (int)cudaGetLastError();
}

template <typename XT, typename WT>
int launch_out(const void* x, const void* w, void* out, int M, int K, int N,
               int out_dtype, const VPFmt& f, cudaStream_t s) {
  switch (out_dtype) {
    case VP_F32: return launch<XT, WT, float>(x, w, out, M, K, N, f, s);
    case VP_BF16:
      return launch<XT, WT, __nv_bfloat16>(x, w, out, M, K, N, f, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename XT>
int launch_w(const void* x, const void* w, void* out, int M, int K, int N,
             int w_bytes, int out_dtype, const VPFmt& f, cudaStream_t s) {
  switch (w_bytes) {
    case 1: return launch_out<XT, int8_t>(x, w, out, M, K, N, out_dtype, f, s);
    case 2: return launch_out<XT, int16_t>(x, w, out, M, K, N, out_dtype, f, s);
    case 4: return launch_out<XT, int32_t>(x, w, out, M, K, N, out_dtype, f, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (M, K) of x_dtype, w (K, N) packed words of w_bytes, out (M, N) of
// out_dtype; all contiguous.  Returns the CUDA error of the launch.
extern "C" int vp_dequant_matmul_launch(const void* x, const void* w,
                                        void* out, int M, int K, int N,
                                        int x_dtype, int w_bytes,
                                        int out_dtype, const VPFmt* f,
                                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (x_dtype) {
    case VP_F32:
      return launch_w<float>(x, w, out, M, K, N, w_bytes, out_dtype, *f, s);
    case VP_BF16:
      return launch_w<__nv_bfloat16>(x, w, out, M, K, N, w_bytes, out_dtype,
                                     *f, s);
  }
  return (int)cudaErrorInvalidValue;
}
