// Block-VP quantizer of the vp_block path: x (R, C) -> x / s block-VP
// quantized, with s the tensor's power-of-two scale, in at most two
// launches and with no host sync.
//
// Replaces what the JAX package leaves to XLA to fuse (no Pallas kernel):
// repro/core/quantize.py:164 block_vp_quantize applied to x / _pow2_scale(x)
// (repro/models/layers.py:223-224 for the activations, :85-86 for a
// weight's export).  Bit for bit the port's plain version
// (kernels/ref.py:block_vp_quant_ref):
//   s = exp2(ceil(log2(max(amax|x|, 1e-30)))), 1 where amax is 0, taken
//       with log2f, ceilf and exp2f as torch takes them; with bf16 math
//       (a bf16 weight's export) each step rounded to bf16 as torch's bf16
//       ops round;
//   xn = x / s (rounded to bf16 with bf16 math), then per element the FXP
//       grid (rintf, clip) and the Fig. 3 cascade's exponent index
//       (vp_common.cuh:vp_quantize's i, by a loop that ends at the first
//       option that fits);
//   each block of `block` elements along the axis (the row for axis -1,
//       the column for axis 0) takes the largest index of its elements,
//       and every element is re-shifted at that index (vp_shift), clipped
//       to the significand range and stored as int8.
//
// Bound by bytes: x read (4 or 2 bytes an element), one int8 significand
// and a uint8 index per block written.  Design: the amax is a grid-stride
// max (exact and order-free, so deterministic) whose last block, found by
// a counter that it resets to 0, turns the partial maxima into s; the
// quantize pass reads s from device memory.  A CUDA block of the quantize
// pass owns whole index blocks: pass 1 takes each element's index and
// folds it into its block's shared-memory slot by atomicMax (a max, so
// order-free; a warp's maximum first where its 32 elements share a
// block); pass 2 re-reads x (cache-hot), re-shifts and stores; each
// thread keeps 8 loads in flight in both.  A tensor of at most FUSED_MAX
// elements (decode activations) takes one launch: each CUDA block finds
// the amax of the whole (cache-hot) tensor itself before its share.
#include "vp_common.cuh"

namespace {

constexpr int BQ_THREADS = 256;
// Work per CUDA block: small, so that many blocks share each SM and hide
// each other's latencies.
constexpr int BQ_SEG_ELEMS = 1024;    // axis -1: elements per CUDA block
constexpr int BQ_FUSED_ELEMS = 256;   // ... where it takes the amax itself
constexpr int BQ_COLS = 16;           // axis 0: columns per CUDA block
constexpr int BQ_SEG_MAX = 4096;      // index blocks a CUDA block holds
constexpr int BQ_ILP = 8;             // loads of a thread in flight
constexpr long long BQ_FUSED_MAX = 16384;

struct BqArgs {
  const void* x;      // (R, C) f32 or bf16, contiguous
  int8_t* m;          // (R, C) significands
  uint8_t* idx;       // (R, C / block) for axis -1, (R / block, C) for 0
  float* s;           // the scale (one f32)
  float* part;        // the amax pass's per-block maxima
  unsigned* count;    // the amax pass's finished blocks; 0 between launches
  long long R, C;
  int block;
  int axis0;          // blocks along the rows (a weight's d_in)
  int x_bf16;         // x is bf16
  int bf16_math;      // scale and x / s rounded to bf16
  int vec;            // x 16-byte aligned
  QuantFmt q;
};

__device__ __forceinline__ float load_x(const BqArgs& p, long long e) {
  return p.x_bf16 ? __bfloat162float(
                        static_cast<const __nv_bfloat16*>(p.x)[e])
                  : static_cast<const float*>(p.x)[e];
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The plain path's _pow2_scale of a tensor whose max |x| is amax.
__device__ __forceinline__ float pow2_scale_of(float amax, bool bf16) {
  if (!(amax > 0.f)) return 1.f;
  if (bf16) {
    const float c = fmaxf(amax, bf16_round(1e-30f));
    return bf16_round(exp2f(ceilf(bf16_round(log2f(c)))));
  }
  return exp2f(ceilf(log2f(fmaxf(amax, 1e-30f))));
}

// The Fig. 3 cascade's exponent index of a raw FXP integer (what
// vp_common.cuh:vp_quantize gives as i): the first of the K options
// whose shifted value fits the significand range, else the last.  The
// loop ends at the first fit, and the shifts come from shared memory.
__device__ __forceinline__ int cascade_index(int raw, const int* shift,
                                             int K, int lo, int hi) {
  for (int k = 0; k < K; ++k) {
    const int mk = vp_shift(raw, shift[k]);
    if (mk >= lo && mk <= hi) return k;
  }
  return K - 1;
}

// Max of v over the CUDA block (every thread gets it).
__device__ __forceinline__ float block_max(float v) {
  __shared__ float red[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red is free (an earlier call's readers are done)
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// max |x| over elements [first, n) step `stride` (16-byte vectors where
// x is aligned, then the tail).
__device__ __forceinline__ float amax_from(const BqArgs& p, long long first,
                                           long long stride) {
  const long long n = p.R * p.C;
  float a = 0.f;
  if (p.vec) {
    const int per = p.x_bf16 ? 8 : 4;
    const long long nv = n / per;
    const uint4* xv = static_cast<const uint4*>(p.x);
    for (long long v0 = first; v0 < nv; v0 += 4 * stride) {
      uint4 u[4];  // four loads in flight
#pragma unroll
      for (int j = 0; j < 4; ++j)
        u[j] = v0 + j * stride < nv ? __ldg(xv + v0 + j * stride)
                                    : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t w[4] = {u[j].x, u[j].y, u[j].z, u[j].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (p.x_bf16) {
            a = fmaxf(a, fabsf(__uint_as_float(w[k] << 16)));
            a = fmaxf(a, fabsf(__uint_as_float(w[k] & 0xFFFF0000u)));
          } else {
            a = fmaxf(a, fabsf(__uint_as_float(w[k])));
          }
        }
      }
    }
    for (long long e = nv * per + first; e < n; e += stride)  // the tail
      a = fmaxf(a, fabsf(load_x(p, e)));
    return a;
  }
  for (long long e = first; e < n; e += stride)
    a = fmaxf(a, fabsf(load_x(p, e)));
  return a;
}

__global__ void __launch_bounds__(BQ_THREADS)
vp_block_amax_kernel(const BqArgs p) {
  const long long t = (long long)blockIdx.x * BQ_THREADS + threadIdx.x;
  const float a = block_max(amax_from(p, t, (long long)gridDim.x *
                                                BQ_THREADS));
  __shared__ bool last;
  if (threadIdx.x == 0) {
    p.part[blockIdx.x] = a;
    __threadfence();
    last = atomicAdd(p.count, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float b = 0.f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += BQ_THREADS)
    b = fmaxf(b, __ldcg(p.part + i));
  b = block_max(b);
  if (threadIdx.x == 0) {
    *p.s = pow2_scale_of(b, p.bf16_math != 0);
    *p.count = 0;
  }
}

// Elements per CUDA block along the rows (axis -1): whole index blocks,
// fewer where the block finds the scale itself (more blocks share the
// tensor).
template <bool FUSED>
__device__ __forceinline__ int segs_per_cta(int block) {
  return max(1, (FUSED ? BQ_FUSED_ELEMS : BQ_SEG_ELEMS) / block);
}

// The element of slot u (< the block's slots) of this CUDA block's work
// and its index block (local: the shared-memory slot; seg: the index
// output).  Returns false past the tensor.
struct Work {
  long long e, seg;
  int local;
};

template <bool AXIS0, bool FUSED>
__device__ __forceinline__ bool work_of(const BqArgs& p, int u, Work& w) {
  if constexpr (!AXIS0) {
    const long long s0 = (long long)blockIdx.x * segs_per_cta<FUSED>(p.block);
    w.e = s0 * p.block + u;
    if (w.e >= p.R * p.C) return false;
    w.local = u / p.block;
    w.seg = s0 + w.local;
  } else {
    const int rr = u / BQ_COLS, cc = u % BQ_COLS;
    const long long c = (long long)blockIdx.x * BQ_COLS + cc;
    if (rr >= p.block || c >= p.C) return false;
    w.e = ((long long)blockIdx.y * p.block + rr) * p.C + c;
    w.seg = (long long)blockIdx.y * p.C + c;
    w.local = cc;
  }
  return true;
}

// Slots of this CUDA block's work, and its index blocks.
template <bool AXIS0, bool FUSED>
__device__ __forceinline__ void extent(const BqArgs& p, int& slots,
                                       int& segs) {
  if constexpr (!AXIS0) {
    const int per = segs_per_cta<FUSED>(p.block);
    const long long s0 = (long long)blockIdx.x * per;
    segs = (int)min((long long)per, p.R * p.C / p.block - s0);
    slots = segs * p.block;
  } else {
    slots = p.block * BQ_COLS;
    segs = BQ_COLS;
  }
}

// FUSED: each CUDA block takes the tensor's amax itself (a small tensor,
// cache-hot) and block 0 writes the scale; otherwise the amax pass has.
template <bool AXIS0, bool FUSED>
__global__ void __launch_bounds__(BQ_THREADS)
vp_block_quant_kernel(const BqArgs p) {
  __shared__ int seg_idx[BQ_SEG_MAX];
  __shared__ int shift[VP_MAX_K];
  const int t = threadIdx.x, T = BQ_THREADS;
  const bool bf16 = p.bf16_math != 0;
  const int K = p.q.vp.K, lo = p.q.vp.m_lo, hi = p.q.vp.m_hi;
  if (t < VP_MAX_K) shift[t] = p.q.shift[t];

  float s;
  if constexpr (FUSED) {
    s = pow2_scale_of(block_max(amax_from(p, t, T)), bf16);
    if (t == 0 && blockIdx.x == 0 && blockIdx.y == 0) *p.s = s;
  } else {
    s = *p.s;
  }
  int slots, segs;
  extent<AXIS0, FUSED>(p, slots, segs);
  for (int k = t; k < segs; k += T) seg_idx[k] = 0;
  __syncthreads();

  // BQ_ILP elements of this thread, loaded before any is used.
  Work w[BQ_ILP];
  bool ok[BQ_ILP];
  float v[BQ_ILP];
  auto fetch = [&](int u0) {
#pragma unroll
    for (int j = 0; j < BQ_ILP; ++j) {
      const int u = u0 + j * T;
      ok[j] = u < slots && work_of<AXIS0, FUSED>(p, u, w[j]);
      const float q = ok[j] ? load_x(p, w[j].e) / s : 0.f;
      v[j] = bf16 ? bf16_round(q) : q;
    }
  };
  // Pass 1: each element's index, folded into its block's maximum.  Along
  // the rows with blocks of whole warps (a warp's 32 slots are 32
  // consecutive elements of one block, and all its lanes have slots or
  // none) the warp takes its maximum first, so one lane in 32 folds it in.
  const bool warp_fold = !AXIS0 && p.block % 32 == 0;
  for (int u0 = t; u0 < slots; u0 += BQ_ILP * T) {
    fetch(u0);
#pragma unroll
    for (int j = 0; j < BQ_ILP; ++j) {
      const int iv =
          ok[j] ? cascade_index(vp_fxp_raw(v[j], p.q), shift, K, lo, hi) : 0;
      if (warp_fold) {
        const int wv = __reduce_max_sync(0xffffffffu, iv);
        if ((t & 31) == 0 && ok[j]) atomicMax(&seg_idx[w[j].local], wv);
      } else if (ok[j]) {
        atomicMax(&seg_idx[w[j].local], iv);
      }
    }
  }
  __syncthreads();
  // Pass 2: re-shift at the block's index, clip, store.
  for (int u0 = t; u0 < slots; u0 += BQ_ILP * T) {
    fetch(u0);
#pragma unroll
    for (int j = 0; j < BQ_ILP; ++j) {
      if (!ok[j]) continue;
      const int mv = vp_shift(vp_fxp_raw(v[j], p.q),
                              shift[seg_idx[w[j].local]]);
      p.m[w[j].e] = (int8_t)min(max(mv, lo), hi);
    }
  }
  // The indices, one per block.
  for (int k = t; k < segs; k += T) {
    long long seg;
    if constexpr (!AXIS0) {
      seg = (long long)blockIdx.x * segs_per_cta<FUSED>(p.block) + k;
    } else {
      const long long c = (long long)blockIdx.x * BQ_COLS + k;
      if (c >= p.C) continue;
      seg = (long long)blockIdx.y * p.C + c;
    }
    p.idx[seg] = (uint8_t)seg_idx[k];
  }
}

template <bool AXIS0, bool FUSED>
int quant_launch(const BqArgs& p, cudaStream_t st) {
  dim3 grid;
  if (AXIS0) {
    if (p.R / p.block > 65535 || (p.C + BQ_COLS - 1) / BQ_COLS > 0x7fffffff)
      return (int)cudaErrorInvalidConfiguration;
    grid = dim3((unsigned)((p.C + BQ_COLS - 1) / BQ_COLS),
                (unsigned)(p.R / p.block));
  } else {
    const long long per = max(1, (FUSED ? BQ_FUSED_ELEMS : BQ_SEG_ELEMS) /
                                     p.block);
    const long long blocks = (p.R * p.C / p.block + per - 1) / per;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    grid = dim3((unsigned)blocks);
  }
  vp_block_quant_kernel<AXIS0, FUSED><<<grid, BQ_THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x (R, C) of x_dtype -> m (R, C) int8, idx (axis0 ? (R / block, C) :
// (R, C / block)) uint8 and *s, all contiguous; bf16_math rounds the
// scale and x / s to bf16.  amax_blocks = 0: one launch, each CUDA block
// taking the amax itself (R C <= 16384 elements); else the amax pass
// runs first on amax_blocks blocks (part holds that many floats, count
// one zeroed uint that it leaves zeroed).  Returns the CUDA error of the
// launches.
extern "C" int vp_block_quant_launch(const void* x, void* m, void* idx,
                                     void* s, void* part, void* count,
                                     long long R, long long C, int block,
                                     int axis0, int x_dtype, int bf16_math,
                                     int amax_blocks, const QuantFmt* q,
                                     void* stream) {
  const long long dim = axis0 ? R : C;
  if (block <= 0 || R < 0 || C < 0 || dim % block ||
      (x_dtype != VP_F32 && x_dtype != VP_BF16) || q->vp.K > VP_MAX_K ||
      q->vp.m_lo < -128 || q->vp.m_hi > 127 || amax_blocks < 0)
    return (int)cudaErrorInvalidValue;
  if (R * C == 0) return 0;
  const bool fused = amax_blocks == 0;
  if (fused && R * C > BQ_FUSED_MAX) return (int)cudaErrorInvalidValue;
  BqArgs p;
  p.x = x;
  p.m = static_cast<int8_t*>(m);
  p.idx = static_cast<uint8_t*>(idx);
  p.s = static_cast<float*>(s);
  p.part = static_cast<float*>(part);
  p.count = static_cast<unsigned*>(count);
  p.R = R;
  p.C = C;
  p.block = block;
  p.axis0 = axis0;
  p.x_bf16 = x_dtype == VP_BF16;
  p.bf16_math = bf16_math;
  p.vec = (uintptr_t)x % 16 == 0;
  p.q = *q;
  cudaStream_t st = (cudaStream_t)stream;
  if (!fused) {
    vp_block_amax_kernel<<<amax_blocks, BQ_THREADS, 0, st>>>(p);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (axis0)
    return fused ? quant_launch<true, true>(p, st)
                 : quant_launch<true, false>(p, st);
  return fused ? quant_launch<false, true>(p, st)
               : quant_launch<false, false>(p, st);
}
