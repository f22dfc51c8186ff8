// Serving matmul: out (M, N) = x (M, K) reals @ dequant(w (K, N) packed
// VP words), N contiguous.
//
// Replaces repro/kernels/vp_dequant_matmul.py:50 vp_dequant_matmul_pallas.
// As there, the words are unpacked (arithmetic >> E, & (K-1)) and scaled
// by 2^-f_i on chip, so no float weight matrix ever exists in device
// memory; the sum is f32, cast once to the output type at the end.  The
// per-tensor scale multiply stays outside (models/layers.py:qdot).
//
// Three bodies; the wrapper (kernels/vp_dequant_matmul.py:fwd_body)
// picks one from M, x's dtype and the format, before launch, and nothing
// falls back:
//
// 1. Skinny, for small M (decode at batch 4; `lm_head`, which reads the
//    last position only, in prefill too): vp_dequant_matmul_skinny_kernel.
//    Bound by bytes: each packed word must be read once, 2 bytes per
//    weight at int16, against 2 M flops; (4, 3072, 1024) moves 6.3 MB,
//    1.9 us at 3.35 TB/s.  At the decode shapes the words are a few MB,
//    so the time is a chain of memory latencies more than a stream: the
//    design keeps that chain short.  A block owns 64 output columns and a
//    run of k rows.  Each thread loads 16 bytes of words per row (8 int16
//    along N; 8 bytes at int8, 32 at int32), neighbouring threads on
//    neighbouring columns (a warp reads 128-byte row segments), 32 rows
//    per block and 4 rows per thread in flight; the first rows' loads go
//    out before x's k-chunk is staged in shared memory as f32.  Words are
//    decoded in registers (shift, mask, the 2^-f table in shared memory,
//    the magic-number int -> float) and each thread keeps M x 8 f32
//    accumulators (FMA chains along its rows).  The 32 k lanes of a block
//    are summed in a fixed order (two shuffles within a warp, then the 8
//    warps in order).  Where the output columns alone do not fill the SMs
//    (w_down has N = 1024), the wrapper splits K across up to 8 blocks
//    that form one thread-block cluster; after a cluster barrier their
//    sums are read from each other's shared memory and added in split
//    order.  No workspace, no atomics: two runs are bit-identical.  M
//    above 16 runs in chunks of 16 rows, reading the words once per
//    chunk (the planner sends M above 4 here only for formats not exact
//    in bf16, whose other body, on the CUDA cores, is slower up to 64).
//
// 2. Tensor cores, for large M and formats with M <= 9 (prefill at
//    M = 512, the train forward at M = 1024): vp_dequant_matmul_tc_kernel,
//    the warp-specialized `wgmma` body of vp_tc_mm.cuh in its role TC_FWD:
//    x is the K-major A operand (bf16 TMA'd into its swizzled tile, f32
//    split into three bf16 terms), the words the MN-major B operand
//    dequantized into bf16 in shared memory.  Bound by operations at
//    those shapes.  A split contraction ends in
//    vp_dqmm_splitk_reduce_kernel.
//
// 3. CUDA cores, for large M and formats with M > 9 (every int32-word
//    format among them), off the main path: vp_dequant_matmul_cc_kernel,
//    the port's first version.  A 64 x 64 output tile per block, 16-deep
//    k slices staged in shared memory, a 4 x 4 register tile per thread,
//    f32 FMAs.
//
// Ragged M/N/K are bounds-checked, not padded.
#include <cooperative_groups.h>

#include "vp_tc_mm.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// 1. Skinny body
// ---------------------------------------------------------------------------

constexpr int SK_THREADS = 256;
constexpr int SK_WARPS = SK_THREADS / 32;
constexpr int SK_CT = 8;                     // column threads of a k lane
constexpr int SK_COLS = SK_CT * 8;           // 64 output columns per block
constexpr int SK_KL = SK_THREADS / SK_CT;    // 32 k lanes per block
constexpr int SK_LPW = 32 / SK_CT;           // 4 k lanes per warp
constexpr int SK_U = 4;                      // rows per thread in flight
constexpr int SK_STEP = SK_KL * SK_U;        // 128 rows per block step
constexpr int SK_XC = 512;                   // rows of x staged at once
constexpr int SK_MAX_SPLIT = 8;              // the portable cluster size
static_assert(SK_XC % SK_STEP == 0, "a step never straddles two chunks");
static_assert(SK_WARPS * SK_COLS <= SK_XC, "x chunk and warp sums share smem");

struct SkArgs {
  const void* x;    // (M, K) f32 or bf16
  const void* w;    // (K, N) packed words
  void* out;        // (M, N) of out_bf16 ? bf16 : f32
  int M, K, N;
  int k_per;        // k rows per split
  int x_bf16, out_bf16;
  int vec;          // 16-byte word loads (rows 16-byte aligned)
  VPFmt f;
};

// Eight consecutive packed words of one row, as loaded.
template <typename WT>
struct Raw8 {
  static constexpr int U32 = 2 * (int)sizeof(WT);
  uint32_t u[U32];
  // Word k, sign-extended.
  __device__ __forceinline__ int word(int k) const {
    if constexpr (sizeof(WT) == 1) {
      return ((int)(u[k >> 2] << (24 - 8 * (k & 3)))) >> 24;
    } else if constexpr (sizeof(WT) == 2) {
      return (k & 1) ? ((int)u[k >> 1]) >> 16 : ((int)(u[k >> 1] << 16)) >> 16;
    } else {
      return (int)u[k];
    }
  }
};

// Words n .. n + 8 of `row` (zero past N); one vector load where the row
// is aligned and whole.
template <typename WT>
__device__ __forceinline__ void load8(Raw8<WT>& r, const WT* row, int n, int N,
                                      bool vec) {
  if (vec && n + 8 <= N) {
    if constexpr (sizeof(WT) == 1) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + n));
      r.u[0] = v.x;
      r.u[1] = v.y;
    } else {
      const uint4* p = reinterpret_cast<const uint4*>(row + n);
#pragma unroll
      for (int q = 0; q < Raw8<WT>::U32 / 4; ++q) {
        const uint4 v = __ldg(p + q);
        r.u[4 * q] = v.x;
        r.u[4 * q + 1] = v.y;
        r.u[4 * q + 2] = v.z;
        r.u[4 * q + 3] = v.w;
      }
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < Raw8<WT>::U32; ++q) r.u[q] = 0;
  constexpr int PER = sizeof(WT) < 4 ? 4 / (int)sizeof(WT) : 1;
  constexpr int BITS = 8 * (int)sizeof(WT);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (n + e < N) {
      const uint32_t v = (uint32_t)(int)row[n + e];
      if constexpr (BITS == 32) {
        r.u[e] = v;
      } else {
        r.u[e / PER] |= (v & ((1u << BITS) - 1)) << (BITS * (e % PER));
      }
    }
  }
}

// One packed word -> its value.  int8 and int16 words go through the
// magic number (exact for |m| < 2^22); an int32 word's significand may
// be wider, so it takes the conversion unit.
template <typename WT>
__device__ __forceinline__ float sk_value(int word, int E, int mask,
                                          const float* tab) {
  const int m = word >> E, i = word & mask;
  if constexpr (sizeof(WT) == 4) {
    return (float)m * tab[i];
  } else {
    return (__int_as_float(0x4B400000 + m) - 12582912.0f) * tab[i];
  }
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z): output columns
// [64 x, 64 x + 64), rows [MT y, MT y + MT), k rows [k_per z, k_per z +
// k_per); the gridDim.z blocks of a column group form one thread-block
// cluster.  Thread t: warp t / 32, column thread ct = lane % 8 (columns
// 8 ct .. 8 ct + 8), k lane L = 4 warp + lane / 8, which takes the rows
// kb + L, kb + L + 32, ... of the block's run in order, 4 of them per
// block step, loaded before they are used (the first step's before x is
// staged).
template <int MT, typename WT>
__global__ void __launch_bounds__(SK_THREADS)
vp_dequant_matmul_skinny_kernel(const SkArgs p) {
  __shared__ __align__(16) float buf[SK_XC * MT];  // x chunk, warp sums
  __shared__ float part[MT * SK_COLS];             // the block's sums
  __shared__ float tab[VP_MAX_K];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int ct = lane % SK_CT, kq = lane / SK_CT;
  const int L = warp * SK_LPW + kq;
  const int n0 = blockIdx.x * SK_COLS, n = n0 + ct * 8;
  const int m0 = blockIdx.y * MT;
  const int kb = blockIdx.z * p.k_per, ke = min(p.K, kb + p.k_per);
  const int E = p.f.E, mask = p.f.K - 1;
  const bool vec = p.vec != 0;
  const WT* w = static_cast<const WT*>(p.w);
  if (t < VP_CHAIN_K)
    tab[t] = p.f.scale[t];
  else if (t < p.f.K)   // E 5-7: the rest from device memory
    tab[t] = __ldg(p.f.wide + t);

  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[m][e] = 0.f;

  // This thread's 4 rows of the step at global row s0.
  auto load_step = [&](Raw8<WT> (&raw)[SK_U], int s0) {
#pragma unroll
    for (int u = 0; u < SK_U; ++u) {
      const int k = s0 + u * SK_KL + L;
      if (k < ke && n < p.N) {
        load8(raw[u], w + (long long)k * p.N, n, p.N, vec);
      } else {
#pragma unroll
        for (int q = 0; q < Raw8<WT>::U32; ++q) raw[u].u[q] = 0;
      }
    }
  };
  // x[m0 .. m0 + MT, c0 .. c0 + XC) into buf as f32, row-major by k.
  int c0 = kb;
  auto stage = [&]() {
    const int rows = min(ke - c0, SK_XC);
    __syncthreads();  // the last chunk's reads are done
    for (int e = t; e < MT * rows; e += SK_THREADS) {
      const int m = e / rows, r = e - m * rows;
      float v = 0.f;
      if (m0 + m < p.M) {
        const long long o = (long long)(m0 + m) * p.K + c0 + r;
        v = p.x_bf16 ? __bfloat162float(
                           static_cast<const __nv_bfloat16*>(p.x)[o])
                     : static_cast<const float*>(p.x)[o];
      }
      buf[r * MT + m] = v;
    }
    __syncthreads();
  };
  // FMAs of the step at s0 (its chunk staged first).
  auto use_step = [&](const Raw8<WT> (&raw)[SK_U], int s0) {
    if (s0 - c0 >= SK_XC) {
      c0 += SK_XC;
      stage();
    }
#pragma unroll
    for (int u = 0; u < SK_U; ++u) {
      const int k = s0 + u * SK_KL + L;
      if (k >= ke) break;
      const float* xr = buf + (k - c0) * MT;
      float xv[MT];
      if constexpr (MT % 4 == 0) {
#pragma unroll
        for (int m = 0; m < MT; m += 4) {
          const float4 q = *reinterpret_cast<const float4*>(xr + m);
          xv[m] = q.x;
          xv[m + 1] = q.y;
          xv[m + 2] = q.z;
          xv[m + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int m = 0; m < MT; ++m) xv[m] = xr[m];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float v = sk_value<WT>(raw[u].word(e), E, mask, tab);
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[m][e] = fmaf(xv[m], v, acc[m][e]);
      }
    }
  };

  Raw8<WT> raw[SK_U];
  load_step(raw, kb);
  stage();
  for (int s0 = kb; s0 < ke; s0 += SK_STEP) {
    use_step(raw, s0);
    if (s0 + SK_STEP < ke) load_step(raw, s0 + SK_STEP);
  }

  // The 4 k lanes of a warp's column thread: (L0 + L1) + (L2 + L3).
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float a = acc[m][e];
#pragma unroll
      for (int off = SK_CT; off < 32; off <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      acc[m][e] = a;
    }
  __syncthreads();  // every thread is done with the x chunk
  if (kq == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        buf[(warp * MT + m) * SK_COLS + ct * 8 + e] = acc[m][e];
  }
  __syncthreads();
  // The 8 warps in order: the block's sum of output (m, c) at 64 m + c.
  for (int e = t; e < MT * SK_COLS; e += SK_THREADS) {
    const int m = e / SK_COLS, c = e % SK_COLS;
    float s = buf[m * SK_COLS + c];
#pragma unroll
    for (int wp = 1; wp < SK_WARPS; ++wp)
      s += buf[(wp * MT + m) * SK_COLS + c];
    part[e] = s;
  }

  // The cluster's blocks (the splits of this column group) in split
  // order, read from each block's shared memory; block z sums the outputs
  // e = 256 z + t (mod 256 gridDim.z).
  const int split = gridDim.z;
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1) cluster.sync();  // every block's `part` is complete
  else __syncthreads();
  for (int e = blockIdx.z * SK_THREADS + t; e < MT * SK_COLS;
       e += split * SK_THREADS) {
    float v[SK_MAX_SPLIT];
#pragma unroll
    for (int z = 0; z < SK_MAX_SPLIT; ++z)
      if (z < split) v[z] = cluster.map_shared_rank(part, z)[e];
    float s = v[0];
#pragma unroll
    for (int z = 1; z < SK_MAX_SPLIT; ++z)
      if (z < split) s += v[z];
    const int gm = m0 + e / SK_COLS, gn = n0 + e % SK_COLS;
    if (gm >= p.M || gn >= p.N) continue;
    const long long o = (long long)gm * p.N + gn;
    if (p.out_bf16) {
      static_cast<__nv_bfloat16*>(p.out)[o] = vp_from_float<__nv_bfloat16>(s);
    } else {
      static_cast<float*>(p.out)[o] = s;
    }
  }
  if (split > 1) cluster.sync();  // no block leaves while another reads
}

template <int MT, typename WT>
int sk_launch(const SkArgs& p, int split, cudaStream_t s) {
  const auto kern = vp_dequant_matmul_skinny_kernel<MT, WT>;
  const dim3 grid((p.N + SK_COLS - 1) / SK_COLS, (p.M + MT - 1) / MT,
                  split);
  if (grid.y > 65535 || split > SK_MAX_SPLIT)
    return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(SK_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;  // no cluster where nothing is split
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, p);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename WT>
int sk_mt(const SkArgs& p, int mt, int split, cudaStream_t s) {
  switch (mt) {
    case 1: return sk_launch<1, WT>(p, split, s);
    case 2: return sk_launch<2, WT>(p, split, s);
    case 4: return sk_launch<4, WT>(p, split, s);
    case 8: return sk_launch<8, WT>(p, split, s);
    case 16: return sk_launch<16, WT>(p, split, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// 2. Tensor-core body
// ---------------------------------------------------------------------------

template <typename GT, typename WT>
__global__ void __launch_bounds__(TC_THREADS, 1)
vp_dequant_matmul_tc_kernel(const TcArgs p,
                            const __grid_constant__ TcMaps maps) {
  tc_body<TC_FWD, GT, WT>(p, maps);
}

__global__ void vp_dqmm_splitk_reduce_kernel(const float* __restrict__ ws,
                                             void* out, long long n,
                                             int split, int out_bf16) {
  splitk_reduce(ws, out, n, split, out_bf16);
}

template <typename GT, typename WT>
int tc_go(const TcArgs& p, int split, cudaStream_t s) {
  return tc_launch<TC_FWD, GT, WT>(&vp_dequant_matmul_tc_kernel<GT, WT>,
                                   &vp_dqmm_splitk_reduce_kernel, p, split, s);
}

// ---------------------------------------------------------------------------
// 3. CUDA-core body
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

template <typename XT, typename WT, typename OT>
__global__ void __launch_bounds__(THREADS)
vp_dequant_matmul_cc_kernel(const XT* __restrict__ x,
                            const WT* __restrict__ w, OT* __restrict__ out,
                            int M, int K, int N, VPFmt f) {
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
int cc_launch(const void* x, const void* w, void* out, int M, int K, int N,
              const VPFmt& f, cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  vp_dequant_matmul_cc_kernel<XT, WT, OT><<<grid, THREADS, 0, s>>>(
      (const XT*)x, (const WT*)w, (OT*)out, M, K, N, f);
  return (int)cudaGetLastError();
}

template <typename XT, typename WT>
int cc_out(const void* x, const void* w, void* out, int M, int K, int N,
           int out_dtype, const VPFmt& f, cudaStream_t s) {
  switch (out_dtype) {
    case VP_F32: return cc_launch<XT, WT, float>(x, w, out, M, K, N, f, s);
    case VP_BF16:
      return cc_launch<XT, WT, __nv_bfloat16>(x, w, out, M, K, N, f, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename XT>
int cc_words(const void* x, const void* w, void* out, int M, int K, int N,
             int w_bytes, int out_dtype, const VPFmt& f, cudaStream_t s) {
  switch (w_bytes) {
    case 1: return cc_out<XT, int8_t>(x, w, out, M, K, N, out_dtype, f, s);
    case 2: return cc_out<XT, int16_t>(x, w, out, M, K, N, out_dtype, f, s);
    case 4: return cc_out<XT, int32_t>(x, w, out, M, K, N, out_dtype, f, s);
  }
  return (int)cudaErrorInvalidValue;
}

bool valid_dtypes(int x_dtype, int out_dtype) {
  return (x_dtype == VP_F32 || x_dtype == VP_BF16) &&
         (out_dtype == VP_F32 || out_dtype == VP_BF16);
}

}  // namespace

// Skinny body.  x (M, K) of x_dtype, w (K, N) packed words of w_bytes ->
// out (M, N) of out_dtype; all contiguous.  Rows of x in chunks of mt
// (1, 2, 4, 8 or 16; M <= mt or mt = 16); K in split runs of k_per rows,
// split <= 8 (one thread-block cluster per column group).  Returns the
// CUDA error of the launch.
extern "C" int vp_dqmm_skinny_launch(const void* x, const void* w, void* out,
                                     int M, int K, int N, int x_dtype,
                                     int w_bytes, int out_dtype, int mt,
                                     int split, int k_per, const VPFmt* f,
                                     void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (!valid_dtypes(x_dtype, out_dtype) || K <= 0 || k_per < 1 ||
      split < 1 || (long long)split * k_per < K ||
      (long long)(split - 1) * k_per >= K || (mt < 16 && mt < M) ||
      f->K > VP_MAX_K)
    return (int)cudaErrorInvalidValue;
  SkArgs p;
  p.x = x;
  p.w = w;
  p.out = out;
  p.M = M;
  p.K = K;
  p.N = N;
  p.k_per = k_per;
  p.x_bf16 = x_dtype == VP_BF16;
  p.out_bf16 = out_dtype == VP_BF16;
  p.vec = aligned16(w, N, w_bytes);
  p.f = *f;
  cudaStream_t s = (cudaStream_t)stream;
  switch (w_bytes) {
    case 1: return sk_mt<int8_t>(p, mt, split, s);
    case 2: return sk_mt<int16_t>(p, mt, split, s);
    case 4: return sk_mt<int32_t>(p, mt, split, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Tensor-core body (M <= 9 formats: int8 or int16 words).  x (M, K) of
// x_dtype, w (K, N) packed words of w_bytes -> out (M, N) of out_dtype;
// all contiguous.  Output tiles 128 x 64; split > 1 splits K into runs
// of kb_per x 64 and needs ws, (split, M, N) f32.
extern "C" int vp_dqmm_tc_launch(const void* x, const void* w, void* out,
                                 void* ws, int M, int K, int N, int x_dtype,
                                 int w_bytes, int out_dtype, int split,
                                 int kb_per, const VPFmt* f, void* stream) {
  TcArgs p;
  const int err = tc_args<TC_FWD>(&p, x, w, out, ws, M, K, N, x_dtype,
                                  w_bytes, out_dtype, split, kb_per, *f);
  if (p.R <= 0 || p.C <= 0) return 0;
  if (err || K <= 0) return err ? err : (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == VP_F32) {
    if (w_bytes == 1) return tc_go<float, int8_t>(p, split, s);
    return tc_go<float, int16_t>(p, split, s);
  }
  if (w_bytes == 1) return tc_go<__nv_bfloat16, int8_t>(p, split, s);
  return tc_go<__nv_bfloat16, int16_t>(p, split, s);
}

// CUDA-core body.  x (M, K) of x_dtype, w (K, N) packed words of w_bytes,
// out (M, N) of out_dtype; all contiguous.  Returns the CUDA error of the
// launch.
extern "C" int vp_dqmm_cc_launch(const void* x, const void* w, void* out,
                                 int M, int K, int N, int x_dtype,
                                 int w_bytes, int out_dtype, const VPFmt* f,
                                 void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (!valid_dtypes(x_dtype, out_dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == VP_F32)
    return cc_words<float>(x, w, out, M, K, N, w_bytes, out_dtype, *f, s);
  return cc_words<__nv_bfloat16>(x, w, out, M, K, N, w_bytes, out_dtype, *f,
                                 s);
}
