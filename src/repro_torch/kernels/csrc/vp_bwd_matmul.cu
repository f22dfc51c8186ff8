// Backward matmuls over packed VP words: the two gradient products of
// the packed-weight training path.
//
//   vp_matmul_dx  out (M, K) = g (M, N) @ dequant(w (K, N))^T
//       Replaces repro/kernels/vp_bwd_matmul.py:58 vp_matmul_dx_pallas.
//       The activation gradient of x @ dequant(w): the same packed words
//       the forward read, contracted over their OUTPUT dim.
//
//   vp_matmul_dw  out (K, N) = dequant(a (M, K))^T @ g (M, N)
//       Replaces repro/kernels/vp_bwd_matmul.py:108 vp_matmul_dw_pallas.
//       The second-operand gradient of the fused quantize + matmul: the
//       packed QUANTIZED first operand (the autograd residual),
//       contracted over M, the token dimension.
//
// As in the Pallas bodies, every word is unpacked (arithmetic >> E,
// & (K-1)) and scaled by 2^-f_i on chip, each product is exact and the
// sum is f32, cast once to the output type at the end.
//
// Bound: at the training shapes (M = 1024 tokens, K and N of 512 to
// 3072) both products do 2 M K N operations on ~2 (M K + K N + M N)
// bytes, far above the card's ridge point: bound by operations, 6.5 us
// at (1024, 1024, 3072) in bf16 (989 TFLOP/s).
//
// Two bodies; the wrapper (kernels/vp_bwd_matmul.py:bwd_body) picks one
// from the format alone, before launch, and nothing falls back:
//
// 1. Tensor cores, for significands of M <= 9 bits (every format on the
//    port's paths has M = 7): vp_matmul_dx_tc_kernel /
//    vp_matmul_dw_tc_kernel, the warp-specialized `wgmma` body of
//    vp_tc_mm.cuh in its roles TC_DX and TC_DW (why bf16 computes the
//    same function, the f32 split of g and the design are stated there).
//    dx's operands are K-major (contraction contiguous), dw's MN-major.
//    A split contraction ends in vp_bwd_splitk_reduce_kernel.
//
// 2. CUDA cores, for M > 9 (every int32-word format among them):
//    vp_bwd_mm_kernel, the port's first version of both products.  A
//    64 x 64 output tile per block, 16-deep slices staged in shared
//    memory, a 4 x 4 register tile per thread, f32 FMAs.  Each operand
//    is staged in the order of its contiguous axis, so a warp's loads
//    coalesce.
//
// Ragged shapes are bounds-checked (zero fill in, masked stores out).
#include "vp_tc_mm.cuh"

namespace {

// ---------------------------------------------------------------------------
// 1. Tensor-core body
// ---------------------------------------------------------------------------

template <typename GT, typename WT>
__global__ void __launch_bounds__(TC_THREADS, 1)
vp_matmul_dx_tc_kernel(const TcArgs p, const __grid_constant__ TcMaps maps) {
  tc_body<TC_DX, GT, WT>(p, maps);
}

template <typename GT, typename WT>
__global__ void __launch_bounds__(TC_THREADS, 1)
vp_matmul_dw_tc_kernel(const TcArgs p, const __grid_constant__ TcMaps maps) {
  tc_body<TC_DW, GT, WT>(p, maps);
}

__global__ void vp_bwd_splitk_reduce_kernel(const float* __restrict__ ws,
                                            void* out, long long n,
                                            int split, int out_bf16) {
  splitk_reduce(ws, out, n, split, out_bf16);
}

template <int ROLE, typename GT, typename WT>
int tc_go(const TcArgs& p, int split, cudaStream_t s) {
  TcKernel kern = ROLE == TC_DX ? &vp_matmul_dx_tc_kernel<GT, WT>
                                : &vp_matmul_dw_tc_kernel<GT, WT>;
  return tc_launch<ROLE, GT, WT>(kern, &vp_bwd_splitk_reduce_kernel, p,
                                 split, s);
}

// Either product on the tensor-core body; validates what the wrapper's
// planner chose.
template <int ROLE>
int tc_run(const void* first, const void* second, void* out, void* ws,
           int M, int K, int N, int g_dtype, int w_bytes, int out_dtype,
           int split, int kb_per, const VPFmt& f, cudaStream_t s) {
  TcArgs p;
  const int err = tc_args<ROLE>(&p, first, second, out, ws, M, K, N, g_dtype,
                                w_bytes, out_dtype, split, kb_per, f);
  if (p.R <= 0 || p.C <= 0) return 0;
  if (err) return err;
  if (g_dtype == VP_F32) {
    if (w_bytes == 1) return tc_go<ROLE, float, int8_t>(p, split, s);
    return tc_go<ROLE, float, int16_t>(p, split, s);
  }
  if (w_bytes == 1) return tc_go<ROLE, __nv_bfloat16, int8_t>(p, split, s);
  return tc_go<ROLE, __nv_bfloat16, int16_t>(p, split, s);
}

// ---------------------------------------------------------------------------
// 2. CUDA-core body
// ---------------------------------------------------------------------------

constexpr int BR = 64, BC = 64, BS = 16, TR = 4, TC = 4;
constexpr int THREADS = (BR / TR) * (BC / TC);  // 256

// Element (i, j) of a row-major real matrix with leading dimension ld.
template <typename T>
struct RealAt {
  const T* p;
  long long ld;
  __device__ __forceinline__ float operator()(int i, int j) const {
    return vp_to_float(p[(long long)i * ld + j]);
  }
};

// Element (i, j) of a row-major packed-word matrix, dequantized.
template <typename W>
struct WordAt {
  const W* p;
  long long ld;
  VPFmt f;
  __device__ __forceinline__ float operator()(int i, int j) const {
    return vp_dequant((int)p[(long long)i * ld + j], f);
  }
};

// out (R, C) = sum_s A(r, s) B(s, c), with A and B given by loaders
// la(r, s) and lb(s, c) (`Trans` reads a stored matrix transposed).
// A_S_CONTIG / B_S_CONTIG say whether neighbouring s are neighbouring in
// memory; the staging loop walks that axis fastest.
template <bool A_S_CONTIG, bool B_S_CONTIG, class LA, class LB, typename OT>
__global__ void __launch_bounds__(THREADS)
vp_bwd_mm_kernel(LA la, LB lb, OT* __restrict__ out, int R, int S, int C) {
  __shared__ float as[BS][BR + 4];  // as[s][r]
  __shared__ float bs[BS][BC + 4];  // bs[s][c]

  const int tid = threadIdx.x;
  const int tx = tid % (BC / TC), ty = tid / (BC / TC);
  const int r0 = blockIdx.y * BR, c0 = blockIdx.x * BC;

  float acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;

  for (int s0 = 0; s0 < S; s0 += BS) {
    for (int e = tid; e < BR * BS; e += THREADS) {
      const int r = A_S_CONTIG ? e / BS : e % BR;
      const int s = A_S_CONTIG ? e % BS : e / BR;
      const int gr = r0 + r, gs = s0 + s;
      as[s][r] = (gr < R && gs < S) ? la(gr, gs) : 0.f;
    }
    for (int e = tid; e < BS * BC; e += THREADS) {
      const int c = B_S_CONTIG ? e / BS : e % BC;
      const int s = B_S_CONTIG ? e % BS : e / BC;
      const int gs = s0 + s, gc = c0 + c;
      bs[s][c] = (gs < S && gc < C) ? lb(gs, gc) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int ss = 0; ss < BS; ++ss) {
      float a[TR], b[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) a[i] = as[ss][ty * TR + i];
#pragma unroll
      for (int j = 0; j < TC; ++j) b[j] = bs[ss][tx * TC + j];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int gr = r0 + ty * TR + i;
    if (gr >= R) continue;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int gc = c0 + tx * TC + j;
      if (gc < C) out[(long long)gr * C + gc] = vp_from_float<OT>(acc[i][j]);
    }
  }
}

// A(r, s) = M(s, r) for a matrix M given by loader L: the transposed view.
template <class L>
struct Trans {
  L l;
  __device__ __forceinline__ float operator()(int i, int j) const {
    return l(j, i);
  }
};

template <bool A_S_CONTIG, bool B_S_CONTIG, typename OT, class LA, class LB>
int launch_mm(const LA& la, const LB& lb, void* out, int R, int S, int C,
              cudaStream_t s) {
  if (R <= 0 || C <= 0) return 0;
  dim3 grid((C + BC - 1) / BC, (R + BR - 1) / BR);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  vp_bwd_mm_kernel<A_S_CONTIG, B_S_CONTIG, LA, LB, OT>
      <<<grid, THREADS, 0, s>>>(la, lb, (OT*)out, R, S, C);
  return (int)cudaGetLastError();
}

// dx (M, K) = g (M, N) . w (K, N)^T: A = g (contiguous along n = s),
// B(s = n, c = k) = w[k, n] (contiguous along n = s).
template <typename GT, typename WT, typename OT>
int dx_launch(const void* g, const void* w, void* out, int M, int K, int N,
              const VPFmt& f, cudaStream_t s) {
  RealAt<GT> la{(const GT*)g, N};
  Trans<WordAt<WT>> lb{WordAt<WT>{(const WT*)w, N, f}};
  return launch_mm<true, true, OT>(la, lb, out, M, N, K, s);
}

// dw (K, N) = a (M, K)^T . g (M, N): A(r = k, s = m) = a[m, k]
// (contiguous along k = r), B = g (contiguous along n = c).
template <typename GT, typename WT, typename OT>
int dw_launch(const void* a, const void* g, void* out, int M, int K, int N,
              const VPFmt& f, cudaStream_t s) {
  Trans<WordAt<WT>> la{WordAt<WT>{(const WT*)a, K, f}};
  RealAt<GT> lb{(const GT*)g, N};
  return launch_mm<false, false, OT>(la, lb, out, K, M, N, s);
}

// Dispatch on (g dtype, word bytes, out dtype) for either product.
template <template <typename, typename, typename> class Op>
struct Dispatch {
  template <typename GT, typename WT>
  static int out(const void* p, const void* q, void* o, int M, int K, int N,
                 int out_dtype, const VPFmt& f, cudaStream_t s) {
    switch (out_dtype) {
      case VP_F32: return Op<GT, WT, float>::run(p, q, o, M, K, N, f, s);
      case VP_BF16:
        return Op<GT, WT, __nv_bfloat16>::run(p, q, o, M, K, N, f, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  template <typename GT>
  static int words(const void* p, const void* q, void* o, int M, int K,
                   int N, int w_bytes, int out_dtype, const VPFmt& f,
                   cudaStream_t s) {
    switch (w_bytes) {
      case 1: return out<GT, int8_t>(p, q, o, M, K, N, out_dtype, f, s);
      case 2: return out<GT, int16_t>(p, q, o, M, K, N, out_dtype, f, s);
      case 4: return out<GT, int32_t>(p, q, o, M, K, N, out_dtype, f, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  static int run(const void* p, const void* q, void* o, int M, int K, int N,
                 int g_dtype, int w_bytes, int out_dtype, const VPFmt& f,
                 cudaStream_t s) {
    switch (g_dtype) {
      case VP_F32:
        return words<float>(p, q, o, M, K, N, w_bytes, out_dtype, f, s);
      case VP_BF16:
        return words<__nv_bfloat16>(p, q, o, M, K, N, w_bytes, out_dtype, f,
                                    s);
    }
    return (int)cudaErrorInvalidValue;
  }
};

template <typename GT, typename WT, typename OT>
struct DxOp {
  static int run(const void* g, const void* w, void* o, int M, int K, int N,
                 const VPFmt& f, cudaStream_t s) {
    return dx_launch<GT, WT, OT>(g, w, o, M, K, N, f, s);
  }
};

template <typename GT, typename WT, typename OT>
struct DwOp {
  static int run(const void* a, const void* g, void* o, int M, int K, int N,
                 const VPFmt& f, cudaStream_t s) {
    return dw_launch<GT, WT, OT>(a, g, o, M, K, N, f, s);
  }
};

}  // namespace

// CUDA-core body.  g (M, N) of g_dtype, w (K, N) packed words of w_bytes
// -> out (M, K) of out_dtype; all contiguous.  Returns the CUDA error of
// the launch.
extern "C" int vp_matmul_dx_cc_launch(const void* g, const void* w, void* out,
                                   int M, int K, int N, int g_dtype,
                                   int w_bytes, int out_dtype,
                                   const VPFmt* f, void* stream) {
  return Dispatch<DxOp>::run(g, w, out, M, K, N, g_dtype, w_bytes, out_dtype,
                             *f, (cudaStream_t)stream);
}

// CUDA-core body.  a (M, K) packed words of a_bytes, g (M, N) of g_dtype
// -> out (K, N) of out_dtype; all contiguous.  Returns the CUDA error of
// the launch.
extern "C" int vp_matmul_dw_cc_launch(const void* a, const void* g, void* out,
                                   int M, int K, int N, int g_dtype,
                                   int a_bytes, int out_dtype,
                                   const VPFmt* f, void* stream) {
  return Dispatch<DwOp>::run(a, g, out, M, K, N, g_dtype, a_bytes, out_dtype,
                             *f, (cudaStream_t)stream);
}

// Tensor-core body (M <= 9, int8 or int16 words).  g (M, N) of g_dtype,
// w (K, N) packed words of w_bytes -> out (M, K) of out_dtype; all
// contiguous.  Output tiles 128 x 64; split > 1 splits the contraction
// into slices of kb_per x 64 and needs ws, (split, M, K) f32.
extern "C" int vp_matmul_dx_tc_launch(const void* g, const void* w, void* out,
                                      void* ws, int M, int K, int N,
                                      int g_dtype, int w_bytes, int out_dtype,
                                      int split, int kb_per,
                                      const VPFmt* f, void* stream) {
  return tc_run<TC_DX>(g, w, out, ws, M, K, N, g_dtype, w_bytes, out_dtype,
                       split, kb_per, *f, (cudaStream_t)stream);
}

// Tensor-core body.  a (M, K) packed words of a_bytes, g (M, N) of
// g_dtype -> out (K, N) of out_dtype; ws (split, K, N) f32 when split > 1.
extern "C" int vp_matmul_dw_tc_launch(const void* a, const void* g, void* out,
                                      void* ws, int M, int K, int N,
                                      int g_dtype, int a_bytes, int out_dtype,
                                      int split, int kb_per,
                                      const VPFmt* f, void* stream) {
  return tc_run<TC_DW>(a, g, out, ws, M, K, N, g_dtype, a_bytes, out_dtype,
                       split, kb_per, *f, (cudaStream_t)stream);
}
