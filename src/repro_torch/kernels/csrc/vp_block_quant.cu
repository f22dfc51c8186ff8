// Block-VP quantizer of the vp_block path: x (R, C) -> x / s block-VP
// quantized, with s the tensor's power-of-two scale, with no host sync.
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
//   xn = x / s (rounded to bf16 with bf16 math; a power-of-two s divides
//       as the multiplication by 1 / s, which is then exact), then per
//       element the FXP grid (rintf, clip) and the Fig. 3 cascade's
//       exponent index (by the index table, below, or the select chain
//       for a format without one);
//   each block of `block` elements along the axis (the row for axis -1,
//       the column for axis 0) takes the largest index of its elements,
//       and every element is re-shifted at that index (vp_shift), clipped
//       to the significand range and stored as int8 (M <= 8) or int16
//       (M 9-16, core/vp_tensor.py:significand_dtype: a uniform branch
//       at each store, the same stores at twice the width).
//
// Bound by bytes: x read once (4 or 2 bytes an element), one int8 (or
// int16) significand and a uint8 index per block written.  What held the first
// design back was not bytes: a decode activation took three serialized
// reads of x (16 blocks each taking the amax of the whole tensor, then
// an index pass and a store pass) with byte stores, a prefill activation
// a separate amax launch first, the export's 16-column blocks read two
// 32-byte pieces of a row per warp, and every element ran the cascade.
// Every body here reads x from memory once into registers, where it
// stays until its significands are stored, so the scale and the block
// indices cost barriers, not memory round trips; and a block is reduced
// by the largest raw ^ (raw >> 31) of its elements, whose bit length
// gives the block's index by one table lookup (the index grows with the
// bit length), so no element runs the cascade.  The bodies
// (kernels/vp_block_quant.py:plan picks one from the shape):
//
//   small (axis -1, at most SMALL_MAX elements: decode activations): one
//       CUDA block of up to 1024 threads holding up to 4 vectors of 4
//       elements each (8- or 16-byte loads), or a thread-block cluster
//       whose blocks exchange their partial maxima through distributed
//       shared memory.  On the H100 one block was the fastest at (4,
//       1024) and a cluster of 8 at (4, 3072) (chip_smoke.py's sweep,
//       PERF.md), so the planner takes one block up to 4096 elements and
//       a cluster of 8 above.
//   coop (both axes, a tensor whose blocks all fit on the card at once:
//       prefill activations and the layer weights' export): one
//       cooperative launch (every block resident) of 256-thread blocks,
//       two per SM by their launch bounds; the partial maxima meet at one
//       grid-wide barrier (an arrival counter and a generation word that
//       the kernels leave ready for the next launch).
//   two-pass (a tensor that does not fit, such as the lm_head export's
//       311 MB): the amax pass (16-byte loads, a grid-stride max whose
//       last block turns the partial maxima into s), then the same bodies
//       with s read back from memory; its column body keeps x as loaded
//       (half the registers of raw integers) so four blocks share an SM.
//   general (every other block that divides the axis: axis -1 blocks
//       that are not a multiple of 4 or above 8192 elements, axis 0
//       blocks that are not a multiple of 32 or above 256 rows, as
//       `--block 16` and `--block 512` export): the amax pass, then a
//       body that reads x twice (the second time from cache) instead of
//       holding it.  Along the rows a group of g = min(32, 2^ceil(log2
//       block)) lanes takes an index block, strides over it and folds its
//       largest key by a shuffle tree; along the columns a CUDA block
//       takes a tile of `block` rows x 256 (or, for blocks above 64 rows,
//       64) columns, each thread 8 columns of every 8th (32nd) row in
//       16-byte loads, folded in registers and then in shared memory.
//       Off the path's shapes at block 256; its time at blocks 16 and 512
//       is in PERF.md.
//
// Along the rows (axis -1) a thread holds vectors of 4 consecutive
// elements, a CUDA block whole index blocks; a block's largest key is
// folded by __reduce_max_sync (or a shuffle tree for blocks of fewer than
// 128 elements) and one shared-memory atomicMax, and the significands go
// out as 4-byte words.  Along the columns (axis 0) a CUDA block takes a
// tile of `block` rows x 64 columns: 32 x 8 threads, each 8 columns (one
// 16-byte bf16 load a row) of block / 32 rows; a column's largest key
// comes from the thread's rows, a shuffle tree over a warp's 4 row groups
// and one shared-memory step over the 8 warps, and the significands go
// out as 8-byte words, each warp writing four 64-byte row pieces.
#include "vp_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BQ_VEC = 4;          // axis -1: elements of a thread's vector
constexpr int BQ_V = 8;            // axis -1: vectors a thread holds (coop,
                                   // two-pass)
constexpr int BQ_SMALL_V = 4;      // ... in the small body
constexpr int BQ_T = 256;          // threads of the coop and two-pass blocks
constexpr int BQ_SMALL_T = 1024;   // most threads of a small-body block
constexpr int BQ_SLOTS = BQ_SMALL_T * BQ_SMALL_V;  // index blocks of a CUDA
                                   // block (block >= 4)
constexpr int BQ_TX = 8;           // axis 0: threads across a tile
constexpr int BQ_CV = 8;           // axis 0: columns of a thread
constexpr int BQ_COLS = BQ_TX * BQ_CV;   // tile columns
constexpr int BQ_TY = BQ_T / BQ_TX;      // threads down a tile
constexpr int BQ_ROWS = 8;         // axis 0: most rows of a thread (block
                                   // <= BQ_TY * BQ_ROWS = 256)
constexpr int BQ_PER_SM = 2;       // coop blocks on one SM (launch bounds)
constexpr int AMAX_T = 256;

enum ScaleFrom { FROM_CLUSTER, FROM_GRID, LOADED };

struct BqArgs {
  const void* x;      // (R, C) f32 or bf16, contiguous
  void* m;            // (R, C) significands, int8 or (m16) int16
  int m16;            // int16 significands (M 9-16), else int8
  uint8_t* idx;       // (R, C / block) for axis -1, (R / block, C) for 0
  float* s;           // the scale (one f32)
  float* part;        // per-block maxima (coop body, amax pass)
  unsigned* bar;      // [arrivals, generation]: 0 arrivals between launches
  long long R, C;
  int block;
  int x_bf16;         // x is bf16
  int bf16_math;      // scale and x / s rounded to bf16
  int aligned;        // x 16-byte aligned
  int fast_fmt;       // |raw| <= 2^22 and F <= 125 (Elem)
  int nv;             // axis -1: vectors a thread holds
  int chunk;          // axis -1: elements of a CUDA block (whole blocks)
  QuantFmt q;
};

// Significand stores: int8, or int16 (m16, a uniform branch) for M >= 9.
__device__ __forceinline__ void store_m(const BqArgs& p, long long e, int v) {
  if (p.m16)
    static_cast<int16_t*>(p.m)[e] = (int16_t)v;
  else
    static_cast<int8_t*>(p.m)[e] = (int8_t)v;
}

// Four significands from element e (a multiple of 4): one 4- or 8-byte
// store.
__device__ __forceinline__ void store_m4(const BqArgs& p, long long e,
                                         const int (&v)[BQ_VEC]) {
  if (p.m16) {
    *reinterpret_cast<uint2*>(static_cast<int16_t*>(p.m) + e) = make_uint2(
        (v[0] & 0xFFFF) | (unsigned)v[1] << 16,
        (v[2] & 0xFFFF) | (unsigned)v[3] << 16);
  } else {
    *reinterpret_cast<unsigned*>(static_cast<int8_t*>(p.m) + e) =
        (v[0] & 255) | (v[1] & 255) << 8 | (v[2] & 255) << 16 |
        (unsigned)v[3] << 24;
  }
}

// Eight significands from element e: one 8- or 16-byte store where vec
// (e aligned, 8 in the row), else element by element up to the row's end
// (n of them).
__device__ __forceinline__ void store_m8(const BqArgs& p, long long e,
                                         bool vec, int n, const int (&v)[8]) {
  if (vec) {
    if (p.m16)
      vp_store8(static_cast<int16_t*>(p.m) + e, v);
    else
      vp_store8(static_cast<int8_t*>(p.m) + e, v);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < n) store_m(p, e + k, v[k]);
  }
}

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

// Every CUDA block of the grid waits here until all have arrived; the
// launch must keep every block resident (cudaLaunchCooperativeKernel).
// bar[0] counts arrivals and is reset by the last to arrive, which then
// bumps bar[1], the generation the others wait on.  Writes before the
// barrier are visible after it to reads that bypass L1 (__ldcg).
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g0 = *gen;   // read before arriving
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g0) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// The tensor's scale from this CUDA block's max |x| (a):
// FROM_CLUSTER, the blocks of the cluster (the grid) exchange their
// maxima through distributed shared memory; FROM_GRID, through device
// memory across a grid-wide barrier; LOADED, the amax pass wrote it.
template <int FROM>
__device__ __forceinline__ float find_scale(const BqArgs& p, float a) {
  const bool bf16 = p.bf16_math != 0;
  if constexpr (FROM == LOADED) {
    __syncthreads();   // the shared tables are written
    return *p.s;
  } else if constexpr (FROM == FROM_CLUSTER) {
    __shared__ float mine;
    a = block_max(a);
    cg::cluster_group cl = cg::this_cluster();
    float b = a;
    if (cl.num_blocks() > 1) {   // a launch without a cluster has one block
      if (threadIdx.x == 0) mine = a;
      cl.sync();
      for (unsigned r = 0; r < cl.num_blocks(); ++r)
        b = fmaxf(b, *cl.map_shared_rank(&mine, r));
      cl.sync();   // no block leaves while another reads its maximum
    }
    const float s = pow2_scale_of(b, bf16);
    if (blockIdx.x == 0 && threadIdx.x == 0) *p.s = s;
    return s;
  } else {
    a = block_max(a);
    if (threadIdx.x == 0) p.part[blockIdx.x] = a;
    grid_barrier(p.bar);
    float b = 0.f;
    for (unsigned i = threadIdx.x; i < gridDim.x; i += blockDim.x)
      b = fmaxf(b, __ldcg(p.part + i));
    const float s = pow2_scale_of(block_max(b), bf16);
    if (blockIdx.x == 0 && threadIdx.x == 0) *p.s = s;
    return s;
  }
}

// Per element once s is known: the raw FXP integer of x / s, and (below)
// its key.  FAST, where s is a power of two and the format's grid has
// |raw| <= 2^22 and F <= 125 (every format of the path): x / s is the
// exact x * (1 / s); a bf16 x over it is a bf16 value, so bf16 math's
// rounding changes only values below 2^-126, which the grid takes to 0
// either way; and the clipped value rounds to nearest even by adding
// 1.5 * 2^23 (two full-rate instructions for rintf and the conversion).
// Otherwise each step as the plain version takes it.  The bodies choose
// outside their element loops.
struct Elem {
  float s, inv;
  bool fast, bf16;

  __device__ __forceinline__ Elem(float s_, const BqArgs& p)
      : s(s_), inv(1.f / s_), bf16(p.bf16_math != 0) {
    const unsigned u = __float_as_uint(s_);
    fast = p.fast_fmt && (u & 0x007FFFFFu) == 0 && (u & 0x7F800000u) != 0;
  }

  template <bool FAST>
  __device__ __forceinline__ int raw(float x, const QuantFmt& q) const {
    if constexpr (FAST) {
      const float r = fminf(fmaxf(x * inv * q.two_f, q.raw_lo), q.raw_hi);
      return __float_as_int(r + 12582912.f) - 0x4B400000;
    } else {
      const float v = x / s;
      return vp_fxp_raw(bf16 ? bf16_round(v) : v, q);
    }
  }
};

// What a block's elements are reduced by: with the table, k = raw ^ (raw
// >> 31), whose bit length gives the index; the index grows with the bit
// length, so the block's index is that of its largest k.  Without it, the
// chain's index itself.  entry() turns a block's largest k into
// (s_i << 8) | i, as vp_index_table lays out its entries.
template <bool TABLE>
__device__ __forceinline__ int key_of(int raw, const QuantFmt& q) {
  if constexpr (TABLE) {
    return raw ^ (raw >> 31);
  } else {
    int m, i;
    vp_quantize_raw(raw, q, m, i);
    return i;
  }
}

template <bool TABLE>
__device__ __forceinline__ int entry(int key, const int* tab,
                                     const int* shift) {
  if constexpr (TABLE) return tab[32 - __clz(key)];
  return shift[key] * 256 + key;
}

// The shift and index tables in shared memory (the caller syncs).
__device__ __forceinline__ void load_tables(const BqArgs& p, int* shift,
                                            int* tab) {
  for (int k = threadIdx.x; k < VP_MAX_K; k += blockDim.x)
    shift[k] = vp_shift_of(k, p.q);
  vp_index_table(tab, p.q);
}

template <typename XT>
__device__ __forceinline__ void load4(const BqArgs& p, long long e,
                                      float (&v)[BQ_VEC]) {
  if (p.aligned) {
    if constexpr (sizeof(XT) == 2) {
      const uint2 u = *reinterpret_cast<const uint2*>(
          static_cast<const XT*>(p.x) + e);
      v[0] = __uint_as_float(u.x << 16);
      v[1] = __uint_as_float(u.x & 0xFFFF0000u);
      v[2] = __uint_as_float(u.y << 16);
      v[3] = __uint_as_float(u.y & 0xFFFF0000u);
    } else {
      const float4 f = *reinterpret_cast<const float4*>(
          static_cast<const XT*>(p.x) + e);
      v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < BQ_VEC; ++k)
      v[k] = vp_to_float(static_cast<const XT*>(p.x)[e + k]);
  }
}

// Fold v, this thread's largest key over a vector of index block
// `local`, into slot[local].  g = block / 4 threads share a block in one
// step: where a warp lies inside one block it takes its maximum first,
// where groups of g lanes do (g divides 32) a shuffle tree does; ok is
// uniform over each such group.
__device__ __forceinline__ void fold(int* slot, int local, int v, bool ok,
                                     int g) {
  const int lane = threadIdx.x & 31;
  if (g % 32 == 0) {
    v = __reduce_max_sync(0xffffffffu, v);
    if (lane == 0 && ok) atomicMax(slot + local, v);
  } else if (32 % g == 0) {
    for (int o = g >> 1; o > 0; o >>= 1)
      v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane % g == 0 && ok) atomicMax(slot + local, v);
  } else if (ok) {
    atomicMax(slot + local, v);
  }
}

// Raw integers and each vector's largest key (pass 1 of the rows).
template <bool TABLE, bool FAST, int V>
__device__ __forceinline__ void rows_index(const BqArgs& p, const Elem& el,
                                           const float (&v)[V][BQ_VEC],
                                           int (&raw)[V][BQ_VEC],
                                           int (&im)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    im[j] = 0;
    if (j < p.nv) {
#pragma unroll
      for (int k = 0; k < BQ_VEC; ++k) {
        raw[j][k] = el.raw<FAST>(v[j][k], p.q);
        im[j] = max(im[j], key_of<TABLE>(raw[j][k], p.q));
      }
    }
  }
}

// Axis -1: this CUDA block's chunk of whole index blocks, V vectors of 4
// elements per thread at most (p.nv of them), held in registers.
template <typename XT, int FROM, bool TABLE, int V>
__device__ __forceinline__ void rows_body(const BqArgs& p) {
  __shared__ int slot[BQ_SLOTS];
  __shared__ int shift[VP_MAX_K];
  __shared__ int tab[VP_IDX_TAB];
  const int t = threadIdx.x, T = blockDim.x;
  const long long e0 = (long long)blockIdx.x * p.chunk;
  const int len = (int)min((long long)p.chunk, p.R * p.C - e0);
  const int nblk = len / p.block;

  float v[V][BQ_VEC];   // issued first: the tables are built meanwhile
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int o = BQ_VEC * (t + T * j);
    if (j < p.nv && o < len) {
      load4<XT>(p, e0 + o, v[j]);
    } else {
#pragma unroll
      for (int k = 0; k < BQ_VEC; ++k) v[j][k] = 0.f;
    }
  }
  load_tables(p, shift, tab);
  for (int k = t; k < nblk; k += T) slot[k] = 0;
  float a = 0.f;
  if constexpr (FROM != LOADED) {
#pragma unroll
    for (int j = 0; j < V; ++j)
#pragma unroll
      for (int k = 0; k < BQ_VEC; ++k) a = fmaxf(a, fabsf(v[j][k]));
  }
  const Elem el(find_scale<FROM>(p, a), p);   // syncs: tables, slots

  // Pass 1: each vector's largest key, folded into its block's slot.
  int raw[V][BQ_VEC], im[V];
  if (el.fast)
    rows_index<TABLE, true>(p, el, v, raw, im);
  else
    rows_index<TABLE, false>(p, el, v, raw, im);
  const int g = p.block / BQ_VEC;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (j < p.nv) {   // uniform: every lane of the block takes the fold
      const int o = BQ_VEC * (threadIdx.x + blockDim.x * j);
      fold(slot, o / p.block, im[j], o < len, g);
    }
  }
  __syncthreads();
  // Pass 2: re-shift at the block's index, clip, one 4-byte store.
  const int lo = p.q.vp.m_lo, hi = p.q.vp.m_hi;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int o = BQ_VEC * (t + T * j);
    if (j < p.nv && o < len) {
      const int sh = entry<TABLE>(slot[o / p.block], tab, shift) >> 8;
      int mv[BQ_VEC];
#pragma unroll
      for (int k = 0; k < BQ_VEC; ++k)
        mv[k] = min(max(vp_shift(raw[j][k], sh), lo), hi);
      store_m4(p, e0 + o, mv);
    }
  }
  for (int k = t; k < nblk; k += T)
    p.idx[e0 / p.block + k] = (uint8_t)(entry<TABLE>(slot[k], tab, shift) & 255);
}

// Axis 0 keeps x as loaded, 8 columns in one (bf16) or two (f32) uint4
// per row, and takes the raw integers again for the stores: half the
// registers of holding them, so more blocks share an SM and hide each
// other's loads.
template <typename XT>
struct Cols8 {
  static constexpr int W = sizeof(XT) / 2;   // uint4 per 8 columns
  uint4 u[W];
};

// Eight columns [c, c + 8) of row r (0 past C).
template <typename XT>
__device__ __forceinline__ void load8(const BqArgs& p, long long r,
                                      long long c, bool vec, Cols8<XT>& w) {
  const XT* x = static_cast<const XT*>(p.x) + r * p.C + c;
  if (vec && c + BQ_CV <= p.C) {
#pragma unroll
    for (int h = 0; h < Cols8<XT>::W; ++h)
      w.u[h] = *reinterpret_cast<const uint4*>(x + h * (8 / Cols8<XT>::W));
  } else {
    uint32_t b[2 * Cols8<XT>::W * 4 / 2];   // one word per f32, two bf16
#pragma unroll
    for (int k = 0; k < BQ_CV; ++k) {
      const XT e = c + k < p.C ? x[k] : XT(0.f);
      if constexpr (sizeof(XT) == 2) {
        const uint32_t h = __bfloat16_as_ushort(e);
        b[k / 2] = k % 2 ? (b[k / 2] | h << 16) : h;
      } else {
        b[k] = __float_as_uint(e);
      }
    }
#pragma unroll
    for (int h = 0; h < Cols8<XT>::W; ++h)
      w.u[h] = make_uint4(b[4 * h], b[4 * h + 1], b[4 * h + 2], b[4 * h + 3]);
  }
}

template <typename XT>
__device__ __forceinline__ void unpack8(const Cols8<XT>& w, float (&v)[BQ_CV]) {
#pragma unroll
  for (int h = 0; h < Cols8<XT>::W; ++h) {
    const uint32_t b[4] = {w.u[h].x, w.u[h].y, w.u[h].z, w.u[h].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (sizeof(XT) == 2) {
        v[8 * h + 2 * k] = __uint_as_float(b[k] << 16);
        v[8 * h + 2 * k + 1] = __uint_as_float(b[k] & 0xFFFF0000u);
      } else {
        v[4 * h + k] = __uint_as_float(b[k]);
      }
    }
  }
}

// Each column's largest key over the thread's rows.
template <bool TABLE, bool FAST, typename XT>
__device__ __forceinline__ void cols_keys(const BqArgs& p, const Elem& el,
                                          int nr,
                                          const Cols8<XT> (&w)[BQ_ROWS],
                                          int (&im)[BQ_CV]) {
#pragma unroll
  for (int k = 0; k < BQ_CV; ++k) im[k] = 0;
#pragma unroll
  for (int j = 0; j < BQ_ROWS; ++j) {
    if (j < nr) {
      float v[BQ_CV];
      unpack8(w[j], v);
#pragma unroll
      for (int k = 0; k < BQ_CV; ++k)
        im[k] = max(im[k], key_of<TABLE>(el.raw<FAST>(v[k], p.q), p.q));
    }
  }
}

// The significands of the thread's rows, each column shifted by sh.
template <bool FAST, typename XT>
__device__ __forceinline__ void cols_store(const BqArgs& p, const Elem& el,
                                           int nr, long long r0, int ty,
                                           long long c, bool vec,
                                           const Cols8<XT> (&w)[BQ_ROWS],
                                           const int (&sh)[BQ_CV]) {
  const int lo = p.q.vp.m_lo, hi = p.q.vp.m_hi;
#pragma unroll
  for (int j = 0; j < BQ_ROWS; ++j) {
    if (j >= nr) continue;
    float v[BQ_CV];
    unpack8(w[j], v);
    int mv[BQ_CV];
#pragma unroll
    for (int k = 0; k < BQ_CV; ++k)
      mv[k] = min(max(vp_shift(el.raw<FAST>(v[k], p.q), sh[k]), lo), hi);
    store_m8(p, (r0 + ty + BQ_TY * j) * p.C + c, vec && c + BQ_CV <= p.C,
             (int)min((long long)BQ_CV, p.C - c), mv);
  }
}

// Axis 0: tile blockIdx.x of `block` rows x BQ_COLS columns (tiles run
// along the columns first), block / 32 rows of 8 columns per thread.
template <typename XT, int FROM, bool TABLE>
__device__ __forceinline__ void cols_body(const BqArgs& p) {
  __shared__ int red[BQ_T / 32][BQ_COLS];
  __shared__ int colsh[BQ_COLS];
  __shared__ int shift[VP_MAX_K];
  __shared__ int tab[VP_IDX_TAB];
  const int t = threadIdx.x, tx = t % BQ_TX, ty = t / BQ_TX;
  const long long ncb = (p.C + BQ_COLS - 1) / BQ_COLS;
  const long long tr = blockIdx.x / ncb, c0 = blockIdx.x % ncb * BQ_COLS;
  const long long r0 = tr * p.block, c = c0 + BQ_CV * tx;
  const int nr = p.block / BQ_TY;
  const bool vec = p.aligned && p.C % BQ_CV == 0;

  Cols8<XT> w[BQ_ROWS];   // issued first: the tables are built meanwhile
#pragma unroll
  for (int j = 0; j < BQ_ROWS; ++j)
    if (j < nr) load8<XT>(p, r0 + ty + BQ_TY * j, c, vec, w[j]);
  load_tables(p, shift, tab);
  float a = 0.f;
  if constexpr (FROM != LOADED) {
#pragma unroll
    for (int j = 0; j < BQ_ROWS; ++j) {
      if (j < nr) {
        float v[BQ_CV];
        unpack8(w[j], v);
#pragma unroll
        for (int k = 0; k < BQ_CV; ++k) a = fmaxf(a, fabsf(v[k]));
      }
    }
  }
  const Elem el(find_scale<FROM>(p, a), p);   // syncs: tables

  // Each column's largest key: the thread's rows, the warp's 4 row
  // groups (lanes 8 and 16 apart), then the 8 warps.
  int im[BQ_CV];
  if (el.fast)
    cols_keys<TABLE, true>(p, el, nr, w, im);
  else
    cols_keys<TABLE, false>(p, el, nr, w, im);
  const int lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int k = 0; k < BQ_CV; ++k) {
    im[k] = max(im[k], __shfl_xor_sync(0xffffffffu, im[k], 8));
    im[k] = max(im[k], __shfl_xor_sync(0xffffffffu, im[k], 16));
    if (lane < BQ_TX) red[warp][BQ_CV * tx + k] = im[k];
  }
  __syncthreads();
  if (t < BQ_COLS) {
    int mx = 0;
#pragma unroll
    for (int ww = 0; ww < BQ_T / 32; ++ww) mx = max(mx, red[ww][t]);
    const int e = entry<TABLE>(mx, tab, shift);
    colsh[t] = e >> 8;
    if (c0 + t < p.C) p.idx[tr * p.C + c0 + t] = (uint8_t)(e & 255);
  }
  __syncthreads();
  int sh[BQ_CV];
#pragma unroll
  for (int k = 0; k < BQ_CV; ++k) sh[k] = colsh[BQ_CV * tx + k];
  if (el.fast)
    cols_store<true>(p, el, nr, r0, ty, c, vec, w, sh);
  else
    cols_store<false>(p, el, nr, r0, ty, c, vec, w, sh);
}

// The bodies, each under its own name (the profiler tells them apart).
template <typename XT, bool TABLE>
__global__ void __launch_bounds__(BQ_SMALL_T)
vp_block_quant_small_kernel(const BqArgs p) {
  rows_body<XT, FROM_CLUSTER, TABLE, BQ_SMALL_V>(p);
}

template <typename XT, bool TABLE>
__global__ void __launch_bounds__(BQ_T, BQ_PER_SM)
vp_block_quant_coop_rows_kernel(const BqArgs p) {
  rows_body<XT, FROM_GRID, TABLE, BQ_V>(p);
}

template <typename XT, bool TABLE>
__global__ void __launch_bounds__(BQ_T, BQ_PER_SM)
vp_block_quant_coop_cols_kernel(const BqArgs p) {
  cols_body<XT, FROM_GRID, TABLE>(p);
}

template <typename XT, bool TABLE>
__global__ void __launch_bounds__(BQ_T, BQ_PER_SM)
vp_block_quant_2pass_rows_kernel(const BqArgs p) {
  rows_body<XT, LOADED, TABLE, BQ_V>(p);
}

template <typename XT, bool TABLE>
__global__ void __launch_bounds__(BQ_T, sizeof(XT) == 2 ? 2 * BQ_PER_SM
                                                        : BQ_PER_SM)
vp_block_quant_2pass_cols_kernel(const BqArgs p) {
  cols_body<XT, LOADED, TABLE>(p);
}

// The general bodies: any block that divides the axis, with s from the
// amax pass.  x is read twice (the second time from cache); every
// element runs the same arithmetic as in the other bodies.
constexpr int BQ_GMAX = BQ_T / BQ_TX * BQ_CV;   // axis 0: widest tile (256)

template <typename XT, bool TABLE, bool FAST>
__device__ __forceinline__ void general_rows(const BqArgs& p, const Elem& el,
                                             const int* tab,
                                             const int* shift) {
  const XT* x = static_cast<const XT*>(p.x);
  const int lane = threadIdx.x & 31, lo = p.q.vp.m_lo, hi = p.q.vp.m_hi;
  int g = 1;                           // lanes per index block
  while (g < p.block && g < 32) g <<= 1;
  const int per = 32 / g;              // index blocks per warp and step
  const long long nb = p.R * p.C / p.block;
  const long long step = (long long)gridDim.x * (BQ_T / 32) * per;
  // b0 is uniform over the warp, so every lane takes every shuffle.
  for (long long b0 = ((long long)blockIdx.x * (BQ_T / 32) +
                       (threadIdx.x >> 5)) * per;
       b0 < nb; b0 += step) {
    const long long b = b0 + lane / g, e0 = b * p.block;
    const int j = lane % g;
    const bool ok = b < nb;
    int key = 0;
    if (ok)
      for (int k = j; k < p.block; k += g)
        key = max(key, key_of<TABLE>(
                           el.raw<FAST>(vp_to_float(x[e0 + k]), p.q), p.q));
    for (int o = g >> 1; o > 0; o >>= 1)
      key = max(key, __shfl_xor_sync(0xffffffffu, key, o));
    if (ok) {
      const int e = entry<TABLE>(key, tab, shift);
      if (j == 0) p.idx[b] = (uint8_t)(e & 255);
      for (int k = j; k < p.block; k += g)
        store_m(p, e0 + k,
                min(max(vp_shift(el.raw<FAST>(vp_to_float(x[e0 + k]), p.q),
                                 e >> 8),
                        lo),
                    hi));
    }
  }
}

// One row of a general column tile: its 8 columns' keys (index table)
// folded into im, or its significands at the columns' shifts sh stored.
template <typename XT, bool FAST>
__device__ __forceinline__ void general_keys(const BqArgs& p, const Elem& el,
                                             long long r, long long c,
                                             bool vec, int (&im)[BQ_CV]) {
  Cols8<XT> w;
  float v[BQ_CV];
  load8<XT>(p, r, c, vec, w);
  unpack8(w, v);
#pragma unroll
  for (int k = 0; k < BQ_CV; ++k)
    im[k] = max(im[k], key_of<true>(el.raw<FAST>(v[k], p.q), p.q));
}

template <typename XT, bool FAST>
__device__ __forceinline__ void general_store(const BqArgs& p, const Elem& el,
                                              long long r, long long c,
                                              bool vec,
                                              const int (&sh)[BQ_CV]) {
  Cols8<XT> w;
  float v[BQ_CV];
  int mv[BQ_CV];
  load8<XT>(p, r, c, vec, w);
  unpack8(w, v);
#pragma unroll
  for (int k = 0; k < BQ_CV; ++k)
    mv[k] = min(max(vp_shift(el.raw<FAST>(v[k], p.q), sh[k]), p.q.vp.m_lo),
                p.q.vp.m_hi);
  store_m8(p, r * p.C + c, vec && c + BQ_CV <= p.C,
           (int)min((long long)BQ_CV, p.C - c), mv);
}

// Axis 0: tile blockIdx.x of `block` rows x 8 * (256 / gy) columns
// (tiles along the columns first); a thread takes 8 columns (16-byte
// loads of bf16, two of f32; element by element at a ragged or unaligned
// edge) of every gy-th row, gy = p.nv threads down the tile (8 or 32).
// Each column's largest key: the thread's rows in registers, then the gy
// threads in shared memory.  With the select chain (a format without the
// index table, on no path) a thread takes its 8 columns one at a time:
// eight chains a row spill registers.
template <typename XT, bool TABLE, bool FAST>
__device__ __forceinline__ void general_cols(const BqArgs& p, const Elem& el,
                                             const int* tab,
                                             const int* shift) {
  __shared__ int red[BQ_T * BQ_CV];   // [gy][columns of the tile]
  __shared__ int colsh[BQ_GMAX];
  const int gy = p.nv, gx = BQ_T / gy, width = gx * BQ_CV;
  const int tx = threadIdx.x % gx, ty = threadIdx.x / gx;
  const long long ncb = (p.C + width - 1) / width;
  const long long tr = blockIdx.x / ncb, c0 = blockIdx.x % ncb * width;
  const long long r0 = tr * p.block, c = c0 + BQ_CV * tx;
  const bool vec = p.aligned && p.C % BQ_CV == 0;
  int* mine = red + ty * width + BQ_CV * tx;
  if constexpr (TABLE) {
    int im[BQ_CV];
#pragma unroll
    for (int k = 0; k < BQ_CV; ++k) im[k] = 0;
    if (c < p.C)
      for (int r = ty; r < p.block; r += gy)
        general_keys<XT, FAST>(p, el, r0 + r, c, vec, im);
#pragma unroll
    for (int k = 0; k < BQ_CV; ++k) mine[k] = im[k];
  } else {
#pragma unroll 1
    for (int k = 0; k < BQ_CV; ++k) {
      int key = 0;
      if (c + k < p.C)
        for (int r = ty; r < p.block; r += gy)
          key = max(key, key_of<TABLE>(
                             el.raw<FAST>(load_x(p, (r0 + r) * p.C + c + k),
                                          p.q),
                             p.q));
      mine[k] = key;
    }
  }
  __syncthreads();
  if (threadIdx.x < width) {
    const int t = threadIdx.x;
    int mx = 0;
    for (int w = 0; w < gy; ++w) mx = max(mx, red[w * width + t]);
    const int e = entry<TABLE>(mx, tab, shift);
    colsh[t] = e >> 8;
    if (c0 + t < p.C) p.idx[tr * p.C + c0 + t] = (uint8_t)(e & 255);
  }
  __syncthreads();
  if (c >= p.C) return;
  int sh[BQ_CV];
#pragma unroll
  for (int k = 0; k < BQ_CV; ++k) sh[k] = colsh[BQ_CV * tx + k];
  for (int r = ty; r < p.block; r += gy)
    general_store<XT, FAST>(p, el, r0 + r, c, vec, sh);
}

template <typename XT, bool TABLE, bool AXIS0>
__global__ void __launch_bounds__(BQ_T)
vp_block_quant_general_kernel(const BqArgs p) {
  __shared__ int shift[VP_MAX_K];
  __shared__ int tab[VP_IDX_TAB];
  load_tables(p, shift, tab);
  const Elem el(find_scale<LOADED>(p, 0.f), p);   // syncs: tables
  if constexpr (AXIS0) {
    if (el.fast)
      general_cols<XT, TABLE, true>(p, el, tab, shift);
    else
      general_cols<XT, TABLE, false>(p, el, tab, shift);
  } else {
    if (el.fast)
      general_rows<XT, TABLE, true>(p, el, tab, shift);
    else
      general_rows<XT, TABLE, false>(p, el, tab, shift);
  }
}

// max |x| over elements [first, n) step `stride` (16-byte vectors where
// x is aligned, then the tail).
__device__ __forceinline__ float amax_from(const BqArgs& p, long long first,
                                           long long stride) {
  const long long n = p.R * p.C;
  float a = 0.f;
  if (p.aligned) {
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

// The two-pass bodies' first pass: a grid-stride max whose last block,
// found by the arrival counter (which it resets), writes s.
__global__ void __launch_bounds__(AMAX_T)
vp_block_amax_kernel(const BqArgs p) {
  const long long t = (long long)blockIdx.x * AMAX_T + threadIdx.x;
  const float a = block_max(amax_from(p, t, (long long)gridDim.x * AMAX_T));
  __shared__ bool last;
  if (threadIdx.x == 0) {
    p.part[blockIdx.x] = a;
    __threadfence();
    last = atomicAdd(p.bar, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float b = 0.f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += AMAX_T)
    b = fmaxf(b, __ldcg(p.part + i));
  b = block_max(b);
  if (threadIdx.x == 0) {
    *p.s = pow2_scale_of(b, p.bf16_math != 0);
    *p.bar = 0;
  }
}

template <typename XT, bool TABLE>
int quant_launch(const BqArgs& p, int axis0, int body, int grid, int threads,
                 cudaStream_t st) {
  void* args[] = {const_cast<BqArgs*>(&p)};
  cudaError_t err = cudaSuccess;
  if (body == 0) {   // small: one cluster of `grid` blocks
    if (axis0 || grid > 8) return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(threads);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = grid;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = grid > 1 ? 1 : 0;
    err = cudaLaunchKernelEx(&cfg, vp_block_quant_small_kernel<XT, TABLE>, p);
  } else if (body == 1) {   // coop: every block resident
    if (threads != BQ_T) return (int)cudaErrorInvalidValue;
    const void* kern = axis0 ? (const void*)vp_block_quant_coop_cols_kernel<XT, TABLE>
                             : (const void*)vp_block_quant_coop_rows_kernel<XT, TABLE>;
    err = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(threads), args,
                                      0, st);
  } else if (body == 2) {
    if (threads != BQ_T) return (int)cudaErrorInvalidValue;
    if (axis0)
      vp_block_quant_2pass_cols_kernel<XT, TABLE><<<grid, threads, 0, st>>>(p);
    else
      vp_block_quant_2pass_rows_kernel<XT, TABLE><<<grid, threads, 0, st>>>(p);
  } else {   // general
    if (threads != BQ_T) return (int)cudaErrorInvalidValue;
    if (axis0)
      vp_block_quant_general_kernel<XT, TABLE, true>
          <<<grid, threads, 0, st>>>(p);
    else
      vp_block_quant_general_kernel<XT, TABLE, false>
          <<<grid, threads, 0, st>>>(p);
  }
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// x (R, C) of x_dtype -> m (R, C) int8 (m_bytes 1) or int16 (2), idx
// (axis0 ? (R / block, C) : (R, C / block)) uint8 and *s, all
// contiguous; bf16_math rounds the scale and x / s to bf16.  body (kernels/vp_block_quant.py:plan): 0
// small (axis -1; one cluster of `grid` = `cluster` blocks), 1 coop
// (every block resident), 2 two-pass, 3 general (both with amax_blocks
// blocks of the amax pass first).  The fast axis -1 bodies take `chunk`
// elements (whole blocks) per CUDA block in nv vectors of 4 per thread;
// the general body any block that divides the axis (chunk unread; along
// the rows a grid-stride loop, nv unread; along the columns one CUDA block
// per tile of block rows x 8 * (256 / nv) columns, nv = 8 or 32 threads
// down each tile).  part holds max(grid,
// amax_blocks) floats, bar two zeroed uints that the kernels leave
// zeroed.  table: the index by q->idx_tab.  Returns the CUDA error of the
// launches.
extern "C" int vp_block_quant_launch(const void* x, void* m, void* idx,
                                     void* s, void* part, void* bar,
                                     long long R, long long C, int block,
                                     int axis0, int x_dtype, int bf16_math,
                                     int body, int grid, int threads,
                                     int nv, int chunk, int amax_blocks,
                                     int table, int m_bytes,
                                     const QuantFmt* q, void* stream) {
  const long long dim = axis0 ? R : C;
  const int vmax = body == 0 ? BQ_SMALL_V : BQ_V;
  if (block <= 0 || R < 0 || C < 0 || dim % block ||
      (x_dtype != VP_F32 && x_dtype != VP_BF16) || q->vp.K > VP_MAX_K ||
      (m_bytes != 1 && m_bytes != 2) ||
      q->vp.m_lo < (m_bytes == 1 ? -128 : -32768) ||
      q->vp.m_hi > (m_bytes == 1 ? 127 : 32767) || body < 0 || body > 3 ||
      grid < 1 || threads < 32 || threads % 32 || amax_blocks < 0 ||
      (body >= 2) != (amax_blocks > 0))
    return (int)cudaErrorInvalidValue;
  if (body == 3) {
    const long long width = axis0 && (nv == 8 || nv == 32)
                                ? BQ_T / nv * BQ_CV : 0;
    if (axis0 && (width == 0 ||
                  (long long)grid != R / block * ((C + width - 1) / width)))
      return (int)cudaErrorInvalidValue;
  } else if (axis0 ? (block % BQ_TY || block / BQ_TY > BQ_ROWS ||
                      (long long)grid !=
                          R / block * ((C + BQ_COLS - 1) / BQ_COLS))
                   : (block % BQ_VEC || chunk % block || nv < 1 ||
                      nv > vmax || chunk > (long long)threads * nv * BQ_VEC ||
                      chunk / block > BQ_SLOTS ||
                      (long long)grid * chunk < R * C)) {
    return (int)cudaErrorInvalidValue;
  }
  if (R * C == 0) return 0;
  BqArgs p;
  p.x = x;
  p.m = m;
  p.m16 = m_bytes == 2;
  p.idx = static_cast<uint8_t*>(idx);
  p.s = static_cast<float*>(s);
  p.part = static_cast<float*>(part);
  p.bar = static_cast<unsigned*>(bar);
  p.R = R;
  p.C = C;
  p.block = block;
  p.x_bf16 = x_dtype == VP_BF16;
  p.bf16_math = bf16_math;
  p.aligned = (uintptr_t)x % 16 == 0;
  p.fast_fmt = q->raw_lo >= -4194304.f && q->raw_hi <= 4194304.f &&
               q->two_f <= 0x1p125f;
  p.nv = nv;
  p.chunk = chunk;
  p.q = *q;
  cudaStream_t st = (cudaStream_t)stream;
  if (body >= 2) {
    vp_block_amax_kernel<<<amax_blocks, AMAX_T, 0, st>>>(p);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (p.x_bf16)
    return table ? quant_launch<__nv_bfloat16, true>(p, axis0, body, grid,
                                                     threads, st)
                 : quant_launch<__nv_bfloat16, false>(p, axis0, body, grid,
                                                      threads, st);
  return table ? quant_launch<float, true>(p, axis0, body, grid, threads,
                                           st)
               : quant_launch<float, false>(p, axis0, body, grid, threads,
                                            st);
}

// The amax pass alone (its bandwidth is measured by chip_smoke.py):
// writes *s for x (R, C) with the same arguments as above.
extern "C" int vp_block_amax_launch(const void* x, void* s, void* part,
                                    void* bar, long long R, long long C,
                                    int x_dtype, int bf16_math,
                                    int amax_blocks, void* stream) {
  if ((x_dtype != VP_F32 && x_dtype != VP_BF16) || amax_blocks < 1 ||
      R * C <= 0)
    return (int)cudaErrorInvalidValue;
  BqArgs p = {};
  p.x = x;
  p.s = static_cast<float*>(s);
  p.part = static_cast<float*>(part);
  p.bar = static_cast<unsigned*>(bar);
  p.R = R;
  p.C = C;
  p.x_bf16 = x_dtype == VP_BF16;
  p.bf16_math = bf16_math;
  p.aligned = (uintptr_t)x % 16 == 0;
  vp_block_amax_kernel<<<amax_blocks, AMAX_T, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
