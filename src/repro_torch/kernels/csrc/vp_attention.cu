// Attention kernels of the serving path: decode over a packed VP KV cache,
// and flash prefill.  Both read q in the model's dtype and apply the
// dh**-0.5 scale themselves, rounded as the plain path rounds it (an f32
// multiply for decode; for prefill a multiply by the scale in q's dtype,
// rounded back to q's dtype), so ops.py launches no elementwise kernel
// around them.
//
// 1. vp_decode_attention_split_kernel replaces
//    repro/kernels/vp_attention.py:vp_decode_attention_pallas (and the
//    port's first decode body, one block per (batch, kv head) walking the
//    span serially, which it superseded).
//    Bound: bytes.  Each valid cache word is read once (2 bytes per
//    element at int16, ~4 FLOPs per element at G = 2), plus its two
//    per-position scales; at batch 4 and Smax 160 that is ~0.6 MB, under
//    0.3 us at 3.35 TB/s, so at serving lengths the time is launch and
//    memory latency, and the bound is reached only for long caches
//    (16.8 MB at 4096 positions).  The design attacks the latency chain:
//    - The valid span [lo, hi) (length, sliding window, or the rolling
//      ring clamped to the buffer) of a (batch, kv head) is cut into runs
//      of whole warp steps: one run per warp, `warps` warps per block and
//      `cluster` blocks per thread-block cluster (kernels/vp_attention.py
//      :plan_decode fixes both from shapes alone; 128 blocks at batch 4,
//      8 kv heads).  A run outside the span leaves the neutral partial
//      (m = -1e30, l = 0, acc = 0).
//    - A warp reads 32 16-byte loads per tensor and step: `lpp` lanes
//      hold one position's dh words (8 int16 or 16 int8 per lane), so a
//      step covers 32 / lpp positions, and four steps' loads go out
//      before the first is used.  Words are decoded in registers through
//      a 2^-f table in shared memory.  Int8 rows of dh = 8 mod 16 (168
//      bytes at gemma3's dh) are only 8-byte aligned: there a lane loads
//      8 bytes (NB = 8), int16's 8 words a lane.  Int32 rows past dh
//      128 (M + E > 16 at stablelm's dh 160 and gemma3's 168) take two
//      16-byte loads a lane (NB = 32: 8 words, up to dh 256), at most 4
//      query rows a slice (the loads of four steps in flight double).
//    - All G query rows of the GQA group use each decoded word: q.k is
//      an FMA chain per lane and a shuffle reduction over the position's
//      lanes; the pow2 scales multiply the score (k_s) and the
//      probability (v_s), as in the TPU kernel (exact for powers of two).
//      Each lane group keeps its own online softmax (m, l, acc) in
//      registers, with one expf per row and position.  Where G rows would
//      not fit a lane's registers (G > 4 at 16 int8 words a lane, qwen2's
//      G = 7; G > 8 at 8 words), a grid axis splits them into slices of
//      `gs` rows, one block per slice: a row's sums depend only on its
//      own q and on the runs, so every row keeps the bits it has in an
//      unsplit launch.  (Slices, not 8-byte lanes, at G = 7: twice the
//      blocks where KV is 2, and the faster of the two on the card.)
//    - Partials merge in a fixed order: the position slots of a warp by a
//      shuffle tree, the warps of a block in warp order through shared
//      memory, the blocks of a cluster in rank order through distributed
//      shared memory.  No atomics: two launches are bit-identical.
//    Output acc / max(l, 1e-30) in q's dtype.
//
// 2. flash_prefill_tc_kernel (bf16, dh a multiple of 16 up to 128, and
//    160 and 168) replaces repro/kernels/vp_attention.py:
//    flash_prefill_pallas on the serving path.  Bound: bytes at the
//    serving prompt (4 x 128 tokens: ~1.5 MB against ~67 MFLOP, so ~0.5 us
//    either way) and latency in practice; operations from prompts of a
//    few thousand tokens (gemma3's 2 x 1152 at dh 168: 28.6 GFLOP).
//    Design:
//    - One block per (kv head or pair of its query heads, batch, q tile of
//      64 rows): four warps of 16 rows per query head, so each K/V tile
//      of 64 keys is staged once in shared memory for the G heads it
//      serves (two at a time), by cp.async into two buffers (the next
//      tile loads while this one is used).  The q tile is the grid's
//      slowest axis, last tile first: under a causal or local mask the
//      tiles that see the most keys start first and the short ones fill
//      the last wave.
//    - QK^T and PV on mma.sync m16n8k16 (bf16 in, f32 accumulate), fed by
//      ldmatrix (.trans for V) from rows padded to an odd number of
//      16-byte chunks (no bank conflicts: 16 bytes of pad, 32 at dh = 8
//      mod 16).  mma.sync rather than wgmma: its 16-row warp tiles keep P
//      in registers as PV's A operand (the accumulator fragment of two
//      score tiles is the operand fragment of one k step) with no
//      warpgroup staging; every product fits one warp.
//    - dh = 8 mod 16 (gemma3's 168 = 10.5 k steps): QK^T ends on one
//      m16n8k8 step (q's last 8 columns, K's from one ldmatrix .x4 that
//      serves four key tiles), and PV's odd last n-tile of 8 output
//      columns takes its V fragment from an ldmatrix .x2 .trans.  No
//      padding: every product covers the real columns only.
//    - Registers: a thread holds q's fragments (dh / 4 registers), the
//      16 x 64 scores (32 f32) and its share of the 16 x dh output (dh /
//      2 f32): 158 at dh 168 (234 in all by ptxas), under the 255 of one
//      256-thread block per SM, so nothing goes to local memory
//      (chip_smoke.py counts LDL / STL in the SASS of every instance).
//    - Numerics of the plain version (ref.flash_prefill_ref): scores f32
//      from bf16 q and k; online softmax in f32 (exp2f of log2(e)-scaled
//      scores, within an ulp of expf); p rounded to bf16 before PV, as the
//      TPU kernel casts p.astype(v.dtype); the row sum l from the f32 p;
//      output acc / max(l, 1e-30) rounded to bf16.  Against the plain
//      version the differences are summation order and the point at
//      which p is rounded (relative to the running, not the final, row
//      max): bf16 tolerance, one bf16 rounding of the output plus that
//      of p.
//    - Tiles above the causal diagonal or wholly before the local window
//      are skipped by the loop bounds; the diagonal fringe, the window
//      edge and keys past Sk (zero-filled by cp.async) are masked in the
//      tile.
//
// 3. flash_prefill_cc_kernel: the port's first prefill body, on CUDA-core
//    FMAs from shared memory, for f32 (whose F32_RTOL check a bf16
//    product would not hold) and for bf16 with head dims the tensor-core
//    body is not built for.  One block per (q tile of 64 rows, head,
//    batch).  Bound as above; it stages each K/V tile once per query
//    head.
#include <cooperative_groups.h>

#include "vp_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// 1. Decode, split over the cache span
// ---------------------------------------------------------------------------

constexpr int DEC_MAX_WARPS = 8;
constexpr int DEC_MAX_CLUSTER = 8;
constexpr int DEC_UNROLL = 4;    // warp steps whose loads are in flight

struct DecArgs {
  const void* q;         // (B, KV, G, dh) f32 or bf16, not scaled
  const void* kw;        // (B, smax, KV, dh) packed words
  const void* vw;
  const float* ks;       // (B, smax) pow2 scales
  const float* vs;
  const int* lengths;    // (B,)
  void* out;             // (B, KV, G, dh) in q's dtype
  int KV, G, dh, smax, window, rolling;
  int gs;                // query rows per block (blockIdx.z: the slice)
  int warps;             // runs per block
  int lpp;               // lanes per position (a power of two)
  float scale;           // dh**-0.5 as an f32
};

// NW elements of q from element e, times the scale in f32.
template <typename T, int NW>
__device__ __forceinline__ void load_q(const void* q, long long e,
                                       float scale, float (&qv)[NW]) {
  const T* src = static_cast<const T*>(q) + e;
#pragma unroll
  for (int j = 0; j < NW; ++j) qv[j] = __fmul_rn(vp_to_float(src[j]), scale);
}

// A lane's NB bytes of a cache row: one 8-byte load (into .x and .y),
// or NB / 16 16-byte loads (two at int32 rows past dh 128).
template <int NB>
struct LaneWords {
  uint4 v[NB > 16 ? NB / 16 : 1];
};

template <int NB>
__device__ __forceinline__ LaneWords<NB> load_words(const void* src, bool ok) {
  LaneWords<NB> r;
  if constexpr (NB == 8) {
    const uint2 a = ok ? __ldg(reinterpret_cast<const uint2*>(src))
                       : make_uint2(0, 0);
    r.v[0] = make_uint4(a.x, a.y, 0u, 0u);
  } else {
#pragma unroll
    for (int c = 0; c < NB / 16; ++c)
      r.v[c] = ok ? __ldg(reinterpret_cast<const uint4*>(src) + c)
                  : make_uint4(0, 0, 0, 0);
  }
  return r;
}

// Word j of a lane's bytes, sign-extended (shifts, not a pointer cast: a
// cast would move the words to local memory).
template <typename WT, int NB>
__device__ __forceinline__ int word_at(const LaneWords<NB>& w, int j) {
  constexpr int PER = 4 / sizeof(WT), BITS = 8 * sizeof(WT);
  const uint4& v = w.v[j / (4 * PER)];
  j %= 4 * PER;
  const unsigned c = j < PER ? v.x : j < 2 * PER ? v.y : j < 3 * PER ? v.z : v.w;
  return (int)(c << (32 - BITS - (j % PER) * BITS)) >> (32 - BITS);
}

template <typename WT, int GT, int NB>
__global__ void __launch_bounds__(DEC_MAX_WARPS * 32)
vp_decode_attention_split_kernel(const DecArgs p, const VPFmt f,
                                 const int q_bf16) {
  constexpr int NW = NB / sizeof(WT);   // words per lane: NB bytes
  extern __shared__ float dsm[];
  // This block's slice of the query rows: [g0, g0 + G).
  const int g0 = blockIdx.z * p.gs, G = min(p.gs, p.G - g0);
  float* wacc = dsm;                          // (warps, G, dh) warp partials
  float* bacc = wacc + p.warps * G * p.dh;    // (G, dh) the block's partial
  __shared__ float tab[VP_MAX_K];
  __shared__ float wm[DEC_MAX_WARPS][GT], wl[DEC_MAX_WARPS][GT];
  __shared__ float bm[GT], bl[GT];

  const int b = blockIdx.x / p.KV, h = blockIdx.x % p.KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lpp = p.lpp, pps = 32 / lpp;
  const int slot = lane / lpp, d0 = (lane % lpp) * NW;
  const bool has_d = d0 < p.dh;
  vp_scale_table(tab, f);

  // The valid span, as the plain version and the TPU kernel bound it.
  const int len = p.lengths[b];
  int lo = 0, hi = len;
  if (p.rolling) {
    hi = min(len, p.smax);
  } else if (p.window > 0) {
    lo = max(len - p.window, 0);
  }
  hi = min(hi, p.smax);
  // This warp's run: whole steps of pps positions, in split order.
  const int n = max(hi - lo, 0);
  const int runs = gridDim.y * p.warps;
  const int per = ((n + runs - 1) / runs + pps - 1) / pps * pps;
  const int run = blockIdx.y * p.warps + warp;
  const int r_lo = min(lo + run * per, hi);
  const int r_hi = min(r_lo + per, hi);

  float qv[GT][NW], acc[GT][NW], m[GT], l[GT];
  const long long qrow = ((long long)b * p.KV + h) * p.G + g0;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < NW; ++j) qv[g][j] = acc[g][j] = 0.f;
    if (g < G && has_d) {
      const long long e = (qrow + g) * p.dh + d0;
      if (q_bf16) {
        load_q<__nv_bfloat16>(p.q, e, p.scale, qv[g]);
      } else {
        load_q<float>(p.q, e, p.scale, qv[g]);
      }
    }
  }
  __syncthreads();   // the 2^-f table

  const long long pos_words = (long long)p.KV * p.dh;
  const WT* kbase = static_cast<const WT*>(p.kw) +
                    ((long long)b * p.smax * p.KV + h) * p.dh + d0;
  const WT* vbase = static_cast<const WT*>(p.vw) +
                    ((long long)b * p.smax * p.KV + h) * p.dh + d0;
  const float* ksb = p.ks + (long long)b * p.smax;
  const float* vsb = p.vs + (long long)b * p.smax;

  for (int t0 = r_lo; t0 < r_hi; t0 += DEC_UNROLL * pps) {
    LaneWords<NB> kk[DEC_UNROLL], vv[DEC_UNROLL];
    float kscale[DEC_UNROLL], vscale[DEC_UNROLL];
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u) {
      const int t = t0 + u * pps + slot;
      const bool ok = t < r_hi;
      kk[u] = load_words<NB>(kbase + t * pos_words, ok && has_d);
      vv[u] = load_words<NB>(vbase + t * pos_words, ok && has_d);
      kscale[u] = ok ? __ldg(ksb + t) : 0.f;
      vscale[u] = ok ? __ldg(vsb + t) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u) {
      const bool ok = t0 + u * pps + slot < r_hi;
      float kf[NW], vf[NW];
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const int wk = word_at<WT>(kk[u], j), wv = word_at<WT>(vv[u], j);
        kf[j] = (float)(wk >> f.E) * vp_scale_lookup(wk & (f.K - 1), tab);
        vf[j] = (float)(wv >> f.E) * vp_scale_lookup(wv & (f.K - 1), tab);
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < NW; ++j) s = fmaf(qv[g][j], kf[j], s);
        for (int o = lpp >> 1; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        s *= kscale[u];
        if (g < G && ok) {
          // One exp: the larger of (m, s) becomes the new max.
          const float e = expf(-fabsf(s - m[g]));
          const bool up = s > m[g];
          const float alpha = up ? e : 1.f;
          const float pr = up ? 1.f : e;
          m[g] = up ? s : m[g];
          l[g] = l[g] * alpha + pr;
          const float pv = pr * vscale[u];
#pragma unroll
          for (int j = 0; j < NW; ++j)
            acc[g][j] = fmaf(pv, vf[j], acc[g][j] * alpha);
        }
      }
    }
  }

  // The warp's position slots, by a shuffle tree (a fixed order).
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g >= G) break;   // uniform: the shuffles below stay converged
    float mw = m[g];
    for (int o = lpp; o < 32; o <<= 1)
      mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, o));
    const float sc = expf(m[g] - mw);
    float lw = l[g] * sc;
#pragma unroll
    for (int j = 0; j < NW; ++j) acc[g][j] *= sc;
    for (int o = lpp; o < 32; o <<= 1) {
      lw += __shfl_xor_sync(0xffffffffu, lw, o);
#pragma unroll
      for (int j = 0; j < NW; ++j)
        acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], o);
    }
    if (slot == 0 && has_d) {
      float* dst = wacc + (warp * G + g) * p.dh + d0;
#pragma unroll
      for (int j = 0; j < NW; ++j) dst[j] = acc[g][j];
    }
    if (lane == 0) {
      wm[warp][g] = mw;
      wl[warp][g] = lw;
    }
  }
  __syncthreads();

  // The block's warps, in warp order.
  for (int e = threadIdx.x; e < G * p.dh; e += blockDim.x) {
    const int g = e / p.dh;
    float mb = NEG_INF;
    for (int w = 0; w < p.warps; ++w) mb = fmaxf(mb, wm[w][g]);
    float a = 0.f, lb = 0.f;
    for (int w = 0; w < p.warps; ++w) {
      const float sc = expf(wm[w][g] - mb);
      a += wacc[(w * G + g) * p.dh + e % p.dh] * sc;
      lb += wl[w][g] * sc;
    }
    bacc[e] = a;
    if (e % p.dh == 0) {
      bm[g] = mb;
      bl[g] = lb;
    }
  }

  // The cluster's blocks, in rank order, from each block's shared memory;
  // block z writes outputs e = z * threads + t (mod cluster * threads).
  cg::cluster_group cluster = cg::this_cluster();
  const int split = gridDim.y;
  if (split > 1) cluster.sync();
  else __syncthreads();
  const long long obase = qrow * p.dh;
  for (int e = blockIdx.y * blockDim.x + threadIdx.x; e < G * p.dh;
       e += split * blockDim.x) {
    const int g = e / p.dh;
    float mz[DEC_MAX_CLUSTER];
    float mt = NEG_INF;
#pragma unroll
    for (int z = 0; z < DEC_MAX_CLUSTER; ++z) {
      if (z < split) {
        mz[z] = cluster.map_shared_rank(bm, z)[g];
        mt = fmaxf(mt, mz[z]);
      }
    }
    float a = 0.f, lt = 0.f;
#pragma unroll
    for (int z = 0; z < DEC_MAX_CLUSTER; ++z) {
      if (z < split) {
        const float sc = expf(mz[z] - mt);
        a += cluster.map_shared_rank(bacc, z)[e] * sc;
        lt += cluster.map_shared_rank(bl, z)[g] * sc;
      }
    }
    // l >= 1 for a non-empty span (its largest score adds exp(0)); the
    // fast division keeps the IEEE one's slow-path call (and its register
    // saves) out of the kernel
    const float o = __fdividef(a, fmaxf(lt, 1e-30f));
    if (q_bf16) {
      static_cast<__nv_bfloat16*>(p.out)[obase + e] = vp_from_float<__nv_bfloat16>(o);
    } else {
      static_cast<float*>(p.out)[obase + e] = o;
    }
  }
  if (split > 1) cluster.sync();   // no block leaves while another reads
}

template <typename WT, int GT, int NB>
int dec_launch(const DecArgs& p, const VPFmt& f, int B, int cluster,
               int q_bf16, cudaStream_t s) {
  const auto kern = vp_decode_attention_split_kernel<WT, GT, NB>;
  const size_t smem = sizeof(float) * (size_t)(p.warps + 1) * p.gs * p.dh;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * p.KV, cluster, (p.G + p.gs - 1) / p.gs);
  cfg.blockDim = dim3(32 * p.warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, p, f, q_bf16);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The rows of a slice (p.gs) pick the register tile GT.
template <typename WT, int NB>
int dec_g(const DecArgs& p, const VPFmt& f, int B, int cluster, int q_bf16,
          cudaStream_t s) {
  if (p.gs <= 1) return dec_launch<WT, 1, NB>(p, f, B, cluster, q_bf16, s);
  if (p.gs <= 2) return dec_launch<WT, 2, NB>(p, f, B, cluster, q_bf16, s);
  if (p.gs <= 4) return dec_launch<WT, 4, NB>(p, f, B, cluster, q_bf16, s);
  // 8 rows of 16 int8 words, or of 8 int32 words on 32-byte lanes, would
  // not fit in registers
  if constexpr (NB <= 16 && NB / sizeof(WT) <= 8) {
    if (p.gs <= 8) return dec_launch<WT, 8, NB>(p, f, B, cluster, q_bf16, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// 2. Prefill on the tensor cores (bf16)
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 64;        // q rows of a head per block: 4 warps of 16
constexpr int TC_BK = 64;        // keys per tile
constexpr int TC_MAX_GH = 2;     // query heads per block

struct FlashArgs {
  const void* q;     // (B, Sq, H, dh), not scaled
  const void* k;     // (B, Sk, KV, dh)
  const void* v;
  void* out;         // (B, Sq, H, dh)
  int Sq, Sk, H, KV, dh, causal, window;
  float scale;       // dh**-0.5 rounded to q's dtype
};

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;   // 0: zero-fill the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8 f32) += a (16 x 8 bf16, row) * b (8 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4],
                                            const unsigned (&a)[2],
                                            unsigned b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// Row stride of a K / V tile in bf16: dh plus a pad that makes the row
// an odd number of 16-byte chunks, so the 8 rows an ldmatrix reads fall
// in 8 distinct 4-bank groups.
template <int DH>
__host__ __device__ constexpr int tc_lds() {
  return DH + (DH % 16 ? 16 : 8);
}

template <int DH>
__global__ void __launch_bounds__(TC_MAX_GH * 4 * 32)
flash_prefill_tc_kernel(const FlashArgs p) {
  static_assert(DH % 8 == 0, "dh is a whole number of 8-column tiles");
  constexpr int LDS = tc_lds<DH>();
  constexpr int KT = DH / 16;          // k16 steps of QK^T
  constexpr bool K8 = DH % 16 != 0;    // and one k8 step for the last 8
  constexpr int NS = TC_BK / 8;        // score n-tiles
  constexpr int NO = DH / 8;           // output n-tiles (odd at dh 168)
  constexpr int CHUNKS = TC_BK * DH / 8;   // 16-byte chunks of a tile
  extern __shared__ __align__(16) unsigned char fsm[];
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(fsm);  // [2][BK][LDS]
  __nv_bfloat16* vt = kt + 2 * TC_BK * LDS;                    // [2][BK][LDS]

  const int G = p.H / p.KV, gh = blockDim.x / 128;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TC_BQ, b = blockIdx.y;
  const int kvh = blockIdx.x / (G / gh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = kvh * G + (blockIdx.x % (G / gh)) * gh + warp / 4;
  const int r0 = q0 + (warp % 4) * 16;     // the warp's first q row
  const int gr = lane >> 2, tq = lane & 3; // fragment row, column pair

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v);

  // Keys any row of this block can see.
  const int q_last = min(q0 + TC_BQ, p.Sq) - 1;
  int k_begin = 0, k_end = p.Sk;
  if (p.causal) {
    k_end = min(p.Sk, q_last + 1);
    if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
  }

  auto load_tile = [&](int k0, int buf) {
    for (int c = threadIdx.x; c < CHUNKS; c += blockDim.x) {
      const int row = c / (DH / 8), col = (c % (DH / 8)) * 8;
      const int key = k0 + row;
      const bool ok = key < p.Sk;
      const long long src =
          (((long long)b * p.Sk + (ok ? key : 0)) * p.KV + kvh) * DH + col;
      const int dst = (buf * TC_BK + row) * LDS + col;
      cp_async16(kt + dst, kg + src, ok);
      cp_async16(vt + dst, vg + src, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if (k_begin < k_end) load_tile(k_begin, 0);

  // q rows, scaled as the plain path scales them: bf16(q * bf16(scale)).
  unsigned qa[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + gr + (e & 1) * 8;
      const int col = kk * 16 + tq * 2 + (e >> 1) * 8;
      float lo = 0.f, hi = 0.f;
      if (row < p.Sq) {
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
            q + (((long long)b * p.Sq + row) * p.H + h) * DH + col);
        lo = __fmul_rn(__low2float(x), p.scale);
        hi = __fmul_rn(__high2float(x), p.scale);
      }
      qa[kk][e] = pack_bf16(lo, hi);
    }
  }
  unsigned qt[2] = {0u, 0u};   // the k8 step's fragment (rows gr, gr + 8)
  if constexpr (K8) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = r0 + gr + e * 8;
      if (row < p.Sq) {
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
            q + (((long long)b * p.Sq + row) * p.H + h) * DH + KT * 16 +
            tq * 2);
        qt[e] = pack_bf16(__fmul_rn(__low2float(x), p.scale),
                          __fmul_rn(__high2float(x), p.scale));
      }
    }
  }

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float mrow[2] = {NEG_INF, NEG_INF}, lrow[2] = {0.f, 0.f};

  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += TC_BK, buf ^= 1) {
    if (k0 + TC_BK < k_end) {
      load_tile(k0 + TC_BK, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const __nv_bfloat16* ktb = kt + buf * TC_BK * LDS;
    const __nv_bfloat16* vtb = vt + buf * TC_BK * LDS;

    // s = q k^T (16 x 64 per warp), f32
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        unsigned bf[4];
        ldsm_x4(bf, ktb + (j * 8 + (lane & 7) + (lane >> 4) * 8) * LDS +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[j], qa[kk], bf[0], bf[1]);
        mma_bf16(s[j + 1], qa[kk], bf[2], bf[3]);
      }
    }
    if constexpr (K8) {   // columns KT * 16 .. DH: one ldmatrix, 4 tiles
#pragma unroll
      for (int j = 0; j < NS; j += 4) {
        unsigned bf[4];
        ldsm_x4(bf, ktb + (j * 8 + lane) * LDS + KT * 16);
#pragma unroll
        for (int t = 0; t < 4; ++t) mma_bf16_k8(s[j + t], qt, bf[t]);
      }
    }

    // log2 domain; masks only where the tile can hold a masked pair for
    // the warp's rows [r0, r0 + 16): keys past Sk, past the first row
    // (causal), or a window or more before the last row (local)
    const bool edge = k0 + TC_BK > p.Sk ||
                      (p.causal && (k0 + TC_BK - 1 > r0 ||
                                    (p.window > 0 && r0 + 15 - k0 >= p.window)));
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[j][e] * LOG2E;
        if (edge) {
          const int row = r0 + gr + (e >> 1) * 8;
          const int key = k0 + j * 8 + tq * 2 + (e & 1);
          bool ok = key < p.Sk;
          if (p.causal) {
            ok = ok && key <= row;
            if (p.window > 0) ok = ok && row - key < p.window;
          }
          v = ok ? v : NEG_INF;
        }
        s[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(mrow[r], mx[r]);
      alpha[r] = exp2f(mrow[r] - mn);
      mrow[r] = mn;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - mrow[e >> 1]);
        sum[e >> 1] += s[j][e];        // l from the f32 p
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) lrow[r] = lrow[r] * alpha[r] + sum[r];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // o += bf16(p) v: two score tiles are one k step's A fragment
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j + 1 < NO; j += 2) {
        unsigned bf[4];
        ldsm_x4_t(bf, vtb + (kk * 16 + (lane & 15)) * LDS + j * 8 +
                          (lane >> 4) * 8);
        mma_bf16(o[j], pa, bf[0], bf[1]);
        mma_bf16(o[j + 1], pa, bf[2], bf[3]);
      }
      if constexpr (NO % 2) {   // the odd last n-tile
        unsigned bf[2];
        ldsm_x2_t(bf, vtb + (kk * 16 + (lane & 15)) * LDS + (NO - 1) * 8);
        mma_bf16(o[NO - 1], pa, bf[0], bf[1]);
      }
    }
    __syncthreads();   // the next load overwrites this buffer
  }

  // l over the four lanes of a row, then out = o / max(l, 1e-30) in bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
    lrow[r] = fmaxf(lrow[r], 1e-30f);
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + gr + r * 8;
    if (row >= p.Sq) continue;
    __nv_bfloat16* dst = out + (((long long)b * p.Sq + row) * p.H + h) * DH;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<unsigned*>(dst + j * 8 + tq * 2) =
          pack_bf16(o[j][2 * r] / lrow[r], o[j][2 * r + 1] / lrow[r]);
    }
  }
}

template <int DH>
int tc_launch(const FlashArgs& p, int B, cudaStream_t s) {
  const int G = p.H / p.KV;
  const int gh = G % TC_MAX_GH == 0 ? TC_MAX_GH : 1;
  const size_t smem = sizeof(__nv_bfloat16) * 4 * TC_BK * tc_lds<DH>();
  const auto kern = flash_prefill_tc_kernel<DH>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(p.KV * (G / gh), B, (p.Sq + TC_BQ - 1) / TC_BQ);
  kern<<<grid, 128 * gh, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// The head dims the tensor-core body is built for
// (kernels/vp_attention.py:TC_DHS).
int tc_dh(const FlashArgs& p, int B, cudaStream_t s) {
  switch (p.dh) {
    case 16: return tc_launch<16>(p, B, s);
    case 32: return tc_launch<32>(p, B, s);
    case 48: return tc_launch<48>(p, B, s);
    case 64: return tc_launch<64>(p, B, s);
    case 80: return tc_launch<80>(p, B, s);
    case 96: return tc_launch<96>(p, B, s);
    case 112: return tc_launch<112>(p, B, s);
    case 128: return tc_launch<128>(p, B, s);
    case 160: return tc_launch<160>(p, B, s);
    case 168: return tc_launch<168>(p, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// 3. Prefill on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int FQ = 64, FK = 64;
constexpr int FL_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(FL_THREADS)
flash_prefill_cc_kernel(const FlashArgs p) {
  extern __shared__ float sm[];
  const int dh = p.dh;
  const int ldk = dh + 1;              // pad: score reads walk kt rows
  float* qs = sm;                      // (FQ, dh)
  float* kt = qs + FQ * dh;            // (FK, dh + 1)
  float* vt = kt + FK * ldk;           // (FK, dh)
  float* st = vt + FK * dh;            // (FQ, FK) scores, then probabilities
  float* acc = st + FQ * FK;           // (FQ, dh)
  float* mrow = acc + FQ * dh;         // (FQ)
  float* lrow = mrow + FQ;             // (FQ)
  float* arow = lrow + FQ;             // (FQ)

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int Sq = p.Sq, Sk = p.Sk, H = p.H;
  const int q0 = blockIdx.x * FQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / p.KV);
  const int tid = threadIdx.x;

  for (int e = tid; e < FQ * dh; e += FL_THREADS) {
    const int r = e / dh, d = e % dh;
    const int qp = q0 + r;
    // q * scale in q's dtype, as the plain path pre-scales it
    qs[e] = qp < Sq ? vp_to_float(vp_from_float<T>(__fmul_rn(
                          vp_to_float(q[(((long long)b * Sq + qp) * H + h) * dh + d]),
                          p.scale)))
                    : 0.f;
    acc[e] = 0.f;
  }
  for (int r = tid; r < FQ; r += FL_THREADS) {
    mrow[r] = NEG_INF;
    lrow[r] = 0.f;
  }

  // Keys any row of this tile can see.
  const int q_last = min(q0 + FQ, Sq) - 1;
  int k_begin = 0, k_end = Sk;
  if (p.causal) {
    k_end = min(Sk, q_last + 1);
    if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
  }
  __syncthreads();

  for (int k0 = k_begin; k0 < k_end; k0 += FK) {
    const int nk = min(FK, k_end - k0);
    for (int e = tid; e < nk * dh; e += FL_THREADS) {
      const int c = e / dh, d = e % dh;
      const long long idx = (((long long)b * Sk + k0 + c) * p.KV + kvh) * dh + d;
      kt[c * ldk + d] = vp_to_float(k[idx]);
      vt[c * dh + d] = vp_to_float(v[idx]);
    }
    __syncthreads();
    for (int e = tid; e < FQ * nk; e += FL_THREADS) {
      const int r = e / nk, c = e % nk;
      const int qp = q0 + r, kp = k0 + c;
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(qs[r * dh + d], kt[c * ldk + d], s);
      bool valid = true;
      if (p.causal) {
        valid = kp <= qp;
        if (p.window > 0) valid = valid && (qp - kp < p.window);
      }
      st[r * FK + c] = valid ? s : NEG_INF;
    }
    __syncthreads();
    for (int r = tid; r < FQ; r += FL_THREADS) {
      float* row = st + r * FK;
      float mc = NEG_INF;
      for (int c = 0; c < nk; ++c) mc = fmaxf(mc, row[c]);
      const float mp = mrow[r];
      const float mn = fmaxf(mp, mc);
      const float alpha = expf(mp - mn);
      float sum = 0.f;
      for (int c = 0; c < nk; ++c) {
        const float pr = expf(row[c] - mn);
        sum += pr;
        row[c] = vp_to_float(vp_from_float<T>(pr));  // p.astype(v.dtype)
      }
      lrow[r] = alpha * lrow[r] + sum;
      mrow[r] = mn;
      arow[r] = alpha;
    }
    __syncthreads();
    for (int e = tid; e < FQ * dh; e += FL_THREADS) {
      const int r = e / dh, d = e % dh;
      float pv = 0.f;
      for (int c = 0; c < nk; ++c) pv = fmaf(st[r * FK + c], vt[c * dh + d], pv);
      acc[e] = acc[e] * arow[r] + pv;
    }
    __syncthreads();
  }

  T* out = static_cast<T*>(p.out);
  for (int e = tid; e < FQ * dh; e += FL_THREADS) {
    const int r = e / dh, d = e % dh;
    const int qp = q0 + r;
    if (qp < Sq) {
      out[(((long long)b * Sq + qp) * H + h) * dh + d] =
          vp_from_float<T>(acc[e] / fmaxf(lrow[r], 1e-30f));
    }
  }
}

template <typename T>
int cc_launch(const FlashArgs& p, int B, cudaStream_t s) {
  const int dh = p.dh;
  const size_t smem = sizeof(float) *
      (size_t)(FQ * dh + FK * (dh + 1) + FK * dh + FQ * FK + FQ * dh + 3 * FQ);
  const auto kern = flash_prefill_cc_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((p.Sq + FQ - 1) / FQ, p.H, B);
  kern<<<grid, FL_THREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, KV, G, dh) f32 or bf16 (q_bf16), not scaled; k_w / v_w (B, smax,
// KV, dh) packed words of w_bytes, aligned to lane_bytes; k_s / v_s (B,
// smax) f32; lengths (B,) int32; out (B, KV, G, dh) in q's dtype.
// window <= 0 means no window.  The span splits over `cluster` blocks of
// `warps` warps with `lpp` lanes per position, each lane loading
// `lane_bytes` (16, or 8 at int8 words) of a row, the G rows over slices
// of `gs` rows (kernels/vp_attention.py:plan_decode).
extern "C" int vp_decode_attention_launch(
    const void* q, const void* kw, const void* vw, const void* ks,
    const void* vs, const void* lengths, void* out, int B, int KV, int G,
    int dh, int smax, int window, int rolling, int w_bytes, int q_bf16,
    int cluster, int warps, int lpp, int lane_bytes, int gs, float scale,
    const VPFmt* f, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cluster < 1 || cluster > DEC_MAX_CLUSTER || warps < 1 ||
      warps > DEC_MAX_WARPS || lpp < 1 || lpp > 32 || (lpp & (lpp - 1)) ||
      (w_bytes != 1 && w_bytes != 2 && w_bytes != 4) ||
      (lane_bytes != 16 && (lane_bytes != 8 || w_bytes != 1) &&
       (lane_bytes != 32 || w_bytes != 4)) || gs < 1 ||
      gs > G ||
      dh % (lane_bytes / w_bytes) || lpp * (lane_bytes / w_bytes) < dh)
    return (int)cudaErrorInvalidValue;
  DecArgs p{q,     kw,     vw,   (const float*)ks, (const float*)vs,
            (const int*)lengths, out, KV, G, dh, smax, window, rolling,
            gs, warps, lpp, scale};
  if (lane_bytes == 8) return dec_g<int8_t, 8>(p, *f, B, cluster, q_bf16, s);
  if (lane_bytes == 32) return dec_g<int32_t, 32>(p, *f, B, cluster, q_bf16, s);
  switch (w_bytes) {
    case 1: return dec_g<int8_t, 16>(p, *f, B, cluster, q_bf16, s);
    case 2: return dec_g<int16_t, 16>(p, *f, B, cluster, q_bf16, s);
    case 4: return dec_g<int32_t, 16>(p, *f, B, cluster, q_bf16, s);
  }
  return (int)cudaErrorInvalidValue;
}

// q (B, Sq, H, dh) not scaled, k / v (B, Sk, KV, dh), out (B, Sq, H, dh),
// all of `dtype`; scale is dh**-0.5 rounded to that dtype.  causal = 0 is
// the full pattern; window <= 0 means none.  body 0: tensor cores (bf16,
// dh a multiple of 16 up to 128 or 160 or 168, 16-byte aligned rows), 1:
// CUDA cores.
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* out, int B, int Sq,
                                    int Sk, int H, int KV, int dh, int causal,
                                    int window, int dtype, int body,
                                    float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const FlashArgs p{q, k, v, out, Sq, Sk, H, KV, dh, causal, window, scale};
  if (body == 0) {
    if (dtype != VP_BF16) return (int)cudaErrorInvalidValue;
    return tc_dh(p, B, s);
  }
  switch (dtype) {
    case VP_F32: return cc_launch<float>(p, B, s);
    case VP_BF16: return cc_launch<__nv_bfloat16>(p, B, s);
  }
  return (int)cudaErrorInvalidValue;
}
