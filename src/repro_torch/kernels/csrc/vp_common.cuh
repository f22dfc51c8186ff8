// Device helpers shared by every VP kernel of the port.
//
// Replaces the in-tile helpers of the JAX package's kernel substrate
// (repro/kernels/substrate.py, part (b)): unpack_cascade, scale_of_index,
// quantize_cascade, quantize_pack_cascade and quantize_dequant_cascade,
// and the matmul bodies that its VP x VP kernels share
// (vp_mm_warp_kernel and vp_mm_tile_kernel below).  Formats are not
// template parameters: they ride each launch as a small struct passed by
// value, so one compiled kernel serves every format with K <= VP_MAX_K:
// every E <= 7 (E 8 fails the int32 contracts at W 12).  The struct holds
// the first VP_CHAIN_K = 16 options, all a canonical format has, and the
// select chains run over them as they always have; a format with more
// (E 5-7) also carries all its scales and shifts in device memory
// (kernels/build.py makes them once per format), which the chains and
// table fills read on a uniform branch that K <= 16 never takes.  Tables
// in shared memory hold VP_MAX_K entries.
//
// Built with nvcc for sm_90a and without --use_fast_math: rintf, expf
// and division must round as the plain PyTorch versions do.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define VP_MAX_K 128   // exponent options a format may have (E <= 7)
#define VP_CHAIN_K 16  // options the struct and the select chains hold

// One VP(M, f) format.  Layout mirrors the ctypes structure in
// repro_torch/kernels/build.py: 4-byte fields, then an 8-byte pointer at
// offset 80, no padding.
struct VPFmt {
  int E;                    // exponent-index bits
  int K;                    // number of exponent options, 2^E
  int m_lo, m_hi;           // significand range [-2^(M-1), 2^(M-1) - 1]
  float scale[VP_CHAIN_K];  // 2^-f_k, exact powers of two (k < 16)
  const float* wide;        // K > 16: all K scales in device memory
};

// Entries of the exponent-index table: one per bit length 0..32.
#define VP_IDX_TAB 33

// An FXP(W, F) grid followed by its VP format (the quantizer's input).
struct QuantFmt {
  VPFmt vp;
  float two_f;             // 2^F
  float raw_lo, raw_hi;    // FXP raw range
  int shift[VP_CHAIN_K];   // s_k = F - f_k (negative: left shift)
  // The Fig. 3 cascade's index as a function of the bit length of
  // raw ^ (raw >> 31) (kernels/vp_quant.py:index_table); all zero for a
  // format whose index is not such a function, which the wrappers send
  // to the select chain instead.
  int idx_tab[VP_IDX_TAB];
  const int* wide_shift;   // K > 16: all K shifts in device memory
};

// 2^-f_i by a select chain over the format's table (K dependent
// selects, no dynamically indexed parameter memory); a format of K > 16
// reads it from its table in device memory (an index past K: scale[0],
// as the chain gives it).
__device__ __forceinline__ float vp_scale_of_index(int i, const VPFmt& f) {
  if (f.K > VP_CHAIN_K) return __ldg(f.wide + ((unsigned)i < (unsigned)f.K
                                               ? i : 0));
  float s = f.scale[0];
#pragma unroll
  for (int k = 1; k < VP_CHAIN_K; ++k) {
    if (k < f.K && i == k) s = f.scale[k];
  }
  return s;
}

// Packed word -> real value m * 2^-f_i.  The arithmetic shift
// sign-extends the significand, the mask extracts the index.
__device__ __forceinline__ float vp_dequant(int w, const VPFmt& f) {
  const int m = w >> f.E;
  const int i = w & (f.K - 1);
  return (float)m * vp_scale_of_index(i, f);
}

// tab[k] = vp_scale_of_index(k, f) for k < VP_MAX_K, written by the
// threads of a block in turn: the select chain run once per entry and
// block, and vp_scale_lookup reads the same numbers back with one load
// (an index past the format's K gets scale[0], as the chain gives it).
__device__ __forceinline__ void vp_scale_table(float* tab, const VPFmt& f) {
  for (int k = threadIdx.x; k < VP_MAX_K; k += blockDim.x)
    tab[k] = vp_scale_of_index(k, f);
}

__device__ __forceinline__ float vp_scale_lookup(int i, const float* tab) {
  return tab[(unsigned)i < VP_MAX_K ? i : 0];
}

// Arithmetic shift of an int32: right by s >= 0, left by -s.  Shifts of
// 32 or more give what the reference's int32 shifts give (sign fill on
// the right, 0 on the left).
__device__ __forceinline__ int vp_shift(int v, int s) {
  if (s >= 0) return v >> (s > 31 ? 31 : s);
  return (-s >= 32) ? 0 : (int)((unsigned)v << (-s));
}

// float -> raw FXP integer: round half to even onto the grid, clip.
__device__ __forceinline__ int vp_fxp_raw(float x, const QuantFmt& q) {
  const float r = rintf(x * q.two_f);
  return (int)fminf(fmaxf(r, q.raw_lo), q.raw_hi);
}

// Raw FXP integer -> (significand m, index i) (paper Fig. 3): the first
// exponent option whose shifted value fits in M signed bits, saturating
// at the last option.
__device__ __forceinline__ void vp_quantize_raw(int raw, const QuantFmt& q,
                                                int& m, int& i) {
  int m_sel = 0, i_sel = 0;
  bool any = false;
  int s_last = q.shift[0];
#pragma unroll
  for (int k = 0; k < VP_CHAIN_K; ++k) {
    if (k < q.vp.K) {
      const int mk = vp_shift(raw, q.shift[k]);
      const bool valid = mk >= q.vp.m_lo && mk <= q.vp.m_hi;
      if (valid && !any) {
        m_sel = mk;
        i_sel = k;
      }
      any = any || valid;
      s_last = q.shift[k];
    }
  }
  if (q.vp.K > VP_CHAIN_K) {   // E 5-7: the rest of the options
#pragma unroll 1
    for (int k = VP_CHAIN_K; k < q.vp.K; ++k) {
      const int sk = __ldg(q.wide_shift + k);
      const int mk = vp_shift(raw, sk);
      const bool valid = mk >= q.vp.m_lo && mk <= q.vp.m_hi;
      if (valid && !any) {
        m_sel = mk;
        i_sel = k;
      }
      any = any || valid;
      s_last = sk;
    }
  }
  if (!any) {
    m_sel = min(max(vp_shift(raw, s_last), q.vp.m_lo), q.vp.m_hi);
    i_sel = q.vp.K - 1;
  }
  m = m_sel;
  i = i_sel;
}

// The cascade in O(1) (kernels/vp_quant.py:index_table).  Option k fits
// iff raw >> s_k lies in [-2^(M-1), 2^(M-1) - 1], which for s_k >= 0 (a
// floor) and for left shifts -(M-1) <= s_k < 0 that cannot wrap is
// bitlen(raw ^ (raw >> 31)) <= M - 1 + s_k: the first option that fits is
// a function of that bit length alone.  vp_index_table writes, for each
// bit length L, (s_i << 8) | i into shared memory (threads of the block
// in turn; the caller syncs), and vp_quantize_raw_tab reads it with one
// load: i, then m = vp_shift(raw, s_i) clipped, which is the chain's m
// where option i fits and its saturating m where none does.
// q.shift[k] by a select chain (no dynamically indexed parameter memory),
// or from the table in device memory for a format of K > 16 (an index
// past K: shift[0], as the chain gives it).
__device__ __forceinline__ int vp_shift_of(int k, const QuantFmt& q) {
  if (q.vp.K > VP_CHAIN_K)
    return __ldg(q.wide_shift + ((unsigned)k < (unsigned)q.vp.K ? k : 0));
  int s = q.shift[0];
#pragma unroll
  for (int j = 1; j < VP_CHAIN_K; ++j)
    if (k == j) s = q.shift[j];
  return s;
}

__device__ __forceinline__ void vp_index_table(int* tab, const QuantFmt& q) {
  for (int L = threadIdx.x; L < VP_IDX_TAB; L += blockDim.x) {
    int i = 0;
#pragma unroll
    for (int j = 0; j < VP_IDX_TAB; ++j)
      if (L == j) i = q.idx_tab[j];
    tab[L] = vp_shift_of(i, q) * 256 + i;
  }
}

__device__ __forceinline__ int vp_bitlen(int raw) {
  return 32 - __clz(raw ^ (raw >> 31));
}

__device__ __forceinline__ void vp_quantize_raw_tab(int raw, const int* tab,
                                                    int lo, int hi, int& m,
                                                    int& i) {
  const int e = tab[vp_bitlen(raw)];
  i = e & 255;
  m = min(max(vp_shift(raw, e >> 8), lo), hi);
}

// float -> (significand m, index i): vp_fxp_raw, then vp_quantize_raw.
__device__ __forceinline__ void vp_quantize(float x, const QuantFmt& q,
                                            int& m, int& i) {
  vp_quantize_raw(vp_fxp_raw(x, q), q, m, i);
}

// float -> packed VP word (m << E) | i.
__device__ __forceinline__ int vp_quantize_pack(float x, const QuantFmt& q) {
  int m, i;
  vp_quantize(x, q, m, i);
  return (int)(((unsigned)m << q.vp.E) | (unsigned)i);
}

__device__ __forceinline__ float vp_to_float(float v) { return v; }
__device__ __forceinline__ float vp_to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T vp_from_float(float v);
template <> __device__ __forceinline__ float vp_from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 vp_from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, like astype
}

// Eight words (the low bytes of w) in one store of 8 x sizeof(OutT)
// bytes; p aligned to that.
__device__ __forceinline__ void vp_store8(int8_t* p, const int (&w)[8]) {
  uint2 u;
  u.x = (w[0] & 255) | (w[1] & 255) << 8 | (w[2] & 255) << 16 |
        (unsigned)w[3] << 24;
  u.y = (w[4] & 255) | (w[5] & 255) << 8 | (w[6] & 255) << 16 |
        (unsigned)w[7] << 24;
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void vp_store8(int16_t* p, const int (&w)[8]) {
  uint4 u;
  u.x = (w[0] & 0xFFFF) | (unsigned)w[1] << 16;
  u.y = (w[2] & 0xFFFF) | (unsigned)w[3] << 16;
  u.z = (w[4] & 0xFFFF) | (unsigned)w[5] << 16;
  u.w = (w[6] & 0xFFFF) | (unsigned)w[7] << 16;
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void vp_store8(int32_t* p, const int (&w)[8]) {
  *reinterpret_cast<int4*>(p) = make_int4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<int4*>(p + 4) = make_int4(w[4], w[5], w[6], w[7]);
}

// Size codes shared with the Python wrappers.
enum VPDtype { VP_F32 = 0, VP_BF16 = 1 };

// ---------------------------------------------------------------------------
// VP x VP matmul bodies, shared by vp_matmul.cu and vp_quant_matmul.cu:
// (G, M, K) x (G, K, N) -> (G, M, N) f32.  Two bodies, one sum.
//
// The warp body (vp_mm_warp_kernel), for many small products (the MIMO
// engine's G = 100,000 x (16, 64) x (64, 2)): one warp computes a tm x
// tn = 32 tile of one batch element's output, one output per lane.  The
// k axis is walked in chunks of 32: the warp stages its A rows (tm x 32)
// and B columns (32 x tn) in shared memory, each element read and
// converted to its real value once by the operand's loader, then every
// lane runs an f32 FMA chain over the chunk in k order.
//
// The tile body (vp_mm_tile_kernel), for one large product (the masked
// mode's and vp_quant_matmul's G = 1 launches, (2048, 64) x (64, 256)):
// a block of 512 threads stages the operands of a 64 x 64 output tile,
// and its first 256 threads compute the tile, each a 4 x 4 micro-tile in
// registers.  The block holds A (64 x 64, k-major) and B (64 x 64) in
// shared memory for each k chunk of 64; it converts only its half of the
// A tile and copies the other half from the other block of its cluster
// pair (the two blocks along n that share the A tile), so an A element
// is loaded and converted once per pair and a B element once per block,
// not once per warp.  Per k a computing thread reads 4 A and 4 B values
// (two 16-byte loads, free of bank conflicts) for 16 FMAs; 2 x 4
// micro-tiles on all 512 threads would take more shared-memory reads per
// FMA.  The quantizing loader's cascade is its other cost: the
// block looks up the scales in a table in shared memory and, for an FXP
// grid of at most VP_LUT_MAX values (the MIMO y operand's 512), the
// value of every raw FXP integer too, built while the chunk's loads are
// in flight.
//
// The batch body (vp_mm_batch_kernel), for many small products: the
// batched launches of vp_quant_matmul (float operands quantized on load)
// and of vp_matmul in the MIMO engine's stored layouts (int16 x int8
// words, int8 planes), at G = 100,000 and the wideband 65,536 x (16, 64)
// x (64, 2).  A persistent grid in which each warp takes one product at a
// time, one output per lane.  The warp body read each element with a 1-,
// 2- or 4-byte load and spent ~160 integer instructions on the Fig. 3
// select chain (or ~20 on the dequant one) per element; here each block
// builds its tables once (the scales; for float operands also the index
// table and the value of every raw FXP integer of a grid of at most
// VP_MB_LUT_MAX values: the y operand's 512, the W operand's 4096, which
// measured faster than the index table for W), each element is
// converted once in O(1) (a scale lookup, or one FXP rounding and a
// value lookup), and a warp reads a product's A and B in 16-byte chunks
// ahead of the one it converts: float operands into registers one
// product ahead, stored ones by cp.async.bulk into a ring of stages in
// shared memory, up to three products ahead.
//
// The loaders are the only difference between the kernels (words or
// planes -> dequant; floats -> quantize -> dequant), and every converted
// value is an exact m * 2^-f, so the fused kernel is bit for bit the
// quantize kernel followed by the plane or word matmul.
//
// The sum of one output is the same in all three bodies: acc starts at +0
// and runs acc = fmaf(a, b, acc) over k = 0 .. K-1 in order, skipping
// the k-ranges that CSPADE mutes.  So the bodies are bit-identical
// at every shape, mask grid and layout.  The tile body pads ragged M, N
// and K with zeros and, where a micro-tile holds loud and muted outputs
// of one k-range, multiplies the muted ones by +0: fmaf(0, b, acc) is
// acc for a finite b, and an acc that starts at +0 never becomes -0.
//
// CSPADE: with activity flags, the k-range of mask tile kt contributes
// to output (g, m, n) iff a_act[g, m / bm, kt] | b_act[g, kt, n / bn]
// (repro/kernels/ref.py:vp_matmul_batched_ref).  The mask grid (bm, bk,
// bn) is the caller's, not the kernels' tiling.  Ragged M, N and K are
// bounds-checked.
// ---------------------------------------------------------------------------

constexpr int VP_MM_WARPS = 4;  // warp body: warps per block
constexpr int VP_MM_KC = 32;    // warp body: k chunk staged per step
constexpr int VP_MM_APAD = VP_MM_KC + 1;  // A row stride in shared memory
constexpr int VP_MM_BPAD = 9;             // B row stride (tn <= 8)

constexpr int VP_TM_BM = 64;       // tile body: output rows per block
constexpr int VP_TM_BN = 64;       // output columns per block
constexpr int VP_TM_KC = 64;       // k chunk staged per step
constexpr int VP_TM_THREADS = 512;  // threads per block: staging
constexpr int VP_TM_MR = 4;        // micro-tile: output rows per thread
constexpr int VP_TM_NR = 4;        // output columns per thread
constexpr int VP_TM_FMA_THREADS =  // the first 256: 16 x 16 micro-tiles
    VP_TM_BM / VP_TM_MR * (VP_TM_BN / VP_TM_NR);
// Row strides of the k-major A tile and the B tile in shared memory: a
// multiple of 4 floats keeps the 8- and 16-byte micro-tile reads aligned,
// and 4 mod 32 banks lets a warp store 8 k x 4 rows of A without
// conflicts.
constexpr int VP_TM_AST = VP_TM_BM + 4;
constexpr int VP_TM_BST = VP_TM_BN + 4;

// Which body a launch runs; the codes are shared with the Python wrappers.
enum VPMMBody { VP_MM_WARP = 0, VP_MM_TILE = 1, VP_MM_BATCH = 2 };

// Real value of element `idx` of a VP operand stored as packed words
// (i == nullptr) or as a significand plane plus a uint8 index plane.
// `bytes` is the element size of `m` (1, 2 or 4); the branches on it are
// uniform across the warp.  A loader reads an element as 32 raw bits
// (`fetch`) plus an index byte (`fetch_aux`, planes only: kAux) and
// converts them (`value`), so a body can put many reads in flight before
// it converts; raw 0 converts to +0.  Given a table of the format's
// scales (vp_scale_table of `fmt()`), `value` looks each scale up instead
// of running the select chain: the same numbers.
struct VPLoad {
  const void* m;
  const uint8_t* i;
  int bytes;
  VPFmt f;
  static constexpr bool kAux = true;
  static constexpr bool kLut = false;
  __device__ __forceinline__ const VPFmt& fmt() const { return f; }
  __device__ __forceinline__ int fetch(long long idx) const {
    return bytes == 1 ? (int)((const int8_t*)m)[idx]
         : bytes == 2 ? (int)((const int16_t*)m)[idx]
                      : ((const int*)m)[idx];
  }
  __device__ __forceinline__ int fetch_aux(long long idx) const {
    return i == nullptr ? 0 : (int)i[idx];
  }
  __device__ __forceinline__ float value(int v, int aux) const {
    if (i == nullptr) return vp_dequant(v, f);
    return (float)v * vp_scale_of_index(aux, f);
  }
  __device__ __forceinline__ float value(int v, int aux,
                                         const float* tab) const {
    const bool packed = i == nullptr;  // then vp_dequant, scale looked up
    const int m_ = packed ? v >> f.E : v;
    return (float)m_ * vp_scale_lookup(packed ? v & (f.K - 1) : aux, tab);
  }
  __device__ __forceinline__ float operator()(long long idx) const {
    return value(fetch(idx), fetch_aux(idx));
  }
};

// Real value of element `idx` of a float operand after the Fig. 3
// quantizer: the VP-rounded m * 2^-f_i (substrate.quantize_dequant_cascade).
// Its raw bits are the float's.  Where the FXP grid has at most
// VP_LUT_MAX raw values (`lut_size`), a body may tabulate the value of
// each (`lut_entry`: vp_quantize_raw, as `value` runs it) and look an
// element up by its raw value (`lut_index`: vp_fxp_raw, as `value` runs
// it): the same number for one FXP rounding and a load.
constexpr int VP_LUT_MAX = 1024;

struct VPQuantLoad {
  const float* x;
  QuantFmt q;
  static constexpr bool kAux = false;
  static constexpr bool kLut = true;
  __device__ __forceinline__ int lut_size() const {
    const float n = q.raw_hi - q.raw_lo + 1.f;
    return n <= (float)VP_LUT_MAX ? (int)n : 0;
  }
  __device__ __forceinline__ float lut_entry(int j, const float* tab) const {
    int m, i;
    vp_quantize_raw((int)q.raw_lo + j, q, m, i);
    return (float)m * vp_scale_lookup(i, tab);
  }
  __device__ __forceinline__ int lut_index(int bits) const {
    return vp_fxp_raw(__int_as_float(bits), q) - (int)q.raw_lo;
  }
  __device__ __forceinline__ const VPFmt& fmt() const { return q.vp; }
  __device__ __forceinline__ int fetch(long long idx) const {
    return __float_as_int(x[idx]);
  }
  __device__ __forceinline__ int fetch_aux(long long) const { return 0; }
  __device__ __forceinline__ float value(int bits, int) const {
    int m, i;
    vp_quantize(__int_as_float(bits), q, m, i);
    return (float)m * vp_scale_of_index(i, q.vp);
  }
  __device__ __forceinline__ float value(int bits, int,
                                         const float* tab) const {
    int m, i;
    vp_quantize(__int_as_float(bits), q, m, i);
    return (float)m * vp_scale_lookup(i, tab);
  }
  __device__ __forceinline__ float operator()(long long idx) const {
    return value(fetch(idx), 0);
  }
  // The batch body's reads and tables: four elements' raw bits in one
  // 16-byte chunk (x 16-byte aligned, v counting float4s), streamed past
  // L1; the scales and the index table (vp_index_table; zeros for a
  // format without one); the table of values with the index from it
  // where `itab` is set, else by the chain (where the format has the
  // table, kernels/vp_quant.py:table_ok, these are the numbers
  // `lut_entry` gives); and a chunk's values looked up in that table.
  static constexpr int kPer = 4;
  __device__ __forceinline__ uint4 chunk(long long v) const {
    return __ldcs(reinterpret_cast<const uint4*>(x) + v);
  }
  __device__ __forceinline__ void tables(float* stab, int* itab) const {
    vp_scale_table(stab, q.vp);
    vp_index_table(itab, q);
  }
  __device__ __forceinline__ float lut_value(int j, const int* itab,
                                             const float* stab) const {
    if (itab == nullptr) return lut_entry(j, stab);
    int m, i;
    vp_quantize_raw_tab((int)q.raw_lo + j, itab, q.vp.m_lo, q.vp.m_hi, m, i);
    return (float)m * vp_scale_lookup(i, stab);
  }
  __device__ __forceinline__ void values(uint4 u, uint4, const float*,
                                         const float* lut,
                                         float (&v)[kPer]) const {
    v[0] = lut[lut_index((int)u.x)];
    v[1] = lut[lut_index((int)u.y)];
    v[2] = lut[lut_index((int)u.z)];
    v[3] = lut[lut_index((int)u.w)];
  }
};

// The batch body's loaders of stored VP operands.  A product's bytes
// are contiguous in each plane (`plane(0)`, and `plane(1)` for a second,
// index plane: kAux), which the body copies into shared memory whole, and
// a loader converts a 16-byte chunk of kPer elements (and its index
// chunk) in O(1) an element from the block's table of the format's scales
// (`tables` builds it: vp_scale_table): the numbers VPLoad::value(v, aux,
// tab) gives, so the batch body sums what the warp body sums.  No table
// of values (kLut): an int16 word may hold any of 65,536 values, and the
// scale table serves every format.
//
// Packed words of type WT (int8: 16 a chunk, int16: 8): m = w >> E
// (arithmetic: sign-extended), i = w & (K - 1) < K.
template <typename WT>
struct VPLoadWords {
  const WT* w;
  VPFmt f;
  static constexpr int kPer = 16 / (int)sizeof(WT);
  static constexpr bool kAux = false;
  static constexpr bool kLut = false;
  __device__ __forceinline__ const VPFmt& fmt() const { return f; }
  __device__ __forceinline__ const void* plane(int) const { return w; }
  __device__ __forceinline__ void tables(float* stab, int*) const {
    vp_scale_table(stab, f);
  }
  // Word t of a 32-bit lane of the chunk (little-endian), sign-extended.
  __device__ __forceinline__ static int word(uint32_t x, int t) {
    constexpr int B = 8 * (int)sizeof(WT), SH = 32 - B;
    return (int)(x << (SH - B * t)) >> SH;
  }
  __device__ __forceinline__ void values(uint4 u, uint4, const float* stab,
                                         const float*,
                                         float (&v)[kPer]) const {
    const uint32_t x[4] = {u.x, u.y, u.z, u.w};
    constexpr int PW = kPer / 4;   // words per 32 bits
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int t = 0; t < PW; ++t) {
        const int wv = word(x[q], t);
        v[q * PW + t] = (float)(wv >> f.E) * stab[wv & (f.K - 1)];
      }
  }
};

// An int8 significand plane beside a uint8 index plane, 16 elements a
// chunk of each: m * 2^-f_i, an index past the table taking scale[0] as
// the select chain gives it (vp_scale_lookup).
struct VPLoadPlanes {
  const int8_t* m;
  const uint8_t* i;
  VPFmt f;
  static constexpr int kPer = 16;
  static constexpr bool kAux = true;
  static constexpr bool kLut = false;
  __device__ __forceinline__ const VPFmt& fmt() const { return f; }
  __device__ __forceinline__ const void* plane(int p) const {
    return p == 0 ? (const void*)m : (const void*)i;
  }
  __device__ __forceinline__ void tables(float* stab, int*) const {
    vp_scale_table(stab, f);
  }
  __device__ __forceinline__ void values(uint4 u, uint4 x, const float* stab,
                                         const float*,
                                         float (&v)[kPer]) const {
    const uint32_t um[4] = {u.x, u.y, u.z, u.w};
    const uint32_t ui[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int mv = (int)(um[q] << (24 - 8 * t)) >> 24;
        const int iv = (int)((ui[q] >> (8 * t)) & 255u);
        v[q * 4 + t] = (float)mv * vp_scale_lookup(iv, stab);
      }
  }
};

struct VPMMGeom {
  int G, M, K, N;
  int bm, bk, bn;  // CSPADE mask grid
  int tm, tn;      // warp body's warp tile, tm * tn = 32
};

template <class LoadA, class LoadB>
__global__ void __launch_bounds__(VP_MM_WARPS * 32)
vp_mm_warp_kernel(LoadA load_a, LoadB load_b, float* __restrict__ out,
                  const int* __restrict__ a_act,
                  const int* __restrict__ b_act, VPMMGeom g) {
  __shared__ float a_s[VP_MM_WARPS][32 * VP_MM_APAD];
  __shared__ float b_s[VP_MM_WARPS][VP_MM_KC * VP_MM_BPAD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nmt = (g.M + g.tm - 1) / g.tm, nnt = (g.N + g.tn - 1) / g.tn;
  const long long wid = (long long)blockIdx.x * VP_MM_WARPS + warp;
  if (wid >= (long long)g.G * nmt * nnt) return;  // the whole warp
  const long long gi = wid / (nmt * nnt);
  const int rem = (int)(wid - gi * nmt * nnt);
  const int m0 = (rem / nnt) * g.tm, n0 = (rem % nnt) * g.tn;
  const int lm = lane / g.tn, ln = lane % g.tn;
  const int gm = m0 + lm, gn = n0 + ln;
  const bool valid = gm < g.M && gn < g.N;
  float* as = a_s[warp];
  float* bs = b_s[warp];
  const long long a0 = gi * g.M * g.K, b0 = gi * g.K * g.N;
  const int nkt = a_act ? g.K / g.bk : 0;
  const int* a_row = a_act ? a_act + (gi * (g.M / g.bm) + gm / g.bm) * nkt
                           : nullptr;
  const int* b_col = b_act ? b_act + gi * nkt * (g.N / g.bn) + gn / g.bn
                           : nullptr;
  float acc = 0.f;
  for (int k0 = 0; k0 < g.K; k0 += VP_MM_KC) {
    const int kc = min(VP_MM_KC, g.K - k0);
    for (int e = lane; e < g.tm * VP_MM_KC; e += 32) {
      const int r = e / VP_MM_KC, c = e % VP_MM_KC;
      const int row = m0 + r, k = k0 + c;
      as[r * VP_MM_APAD + c] =
          (row < g.M && k < g.K) ? load_a(a0 + (long long)row * g.K + k) : 0.f;
    }
    for (int e = lane; e < VP_MM_KC * g.tn; e += 32) {
      const int r = e / g.tn, c = e % g.tn;
      const int k = k0 + r, col = n0 + c;
      bs[r * VP_MM_BPAD + c] =
          (k < g.K && col < g.N) ? load_b(b0 + (long long)k * g.N + col) : 0.f;
    }
    __syncwarp();
    if (valid) {
      int c = 0;
      while (c < kc) {
        int c_end = kc;
        bool on = true;
        if (a_row) {
          const int kt = (k0 + c) / g.bk;
          c_end = min(kc, (kt + 1) * g.bk - k0);
          on = (a_row[kt] | b_col[(long long)kt * (g.N / g.bn)]) != 0;
        }
        if (on) {
          for (; c < c_end; ++c)
            acc = fmaf(as[lm * VP_MM_APAD + c], bs[c * VP_MM_BPAD + ln], acc);
        }
        c = c_end;
      }
    }
    __syncwarp();
  }
  if (valid) out[(gi * g.M + gm) * g.N + gn] = acc;
}

// The tile body's thread-block cluster: the VP_TM_CN = 2 blocks along n
// of one output row band, which share its A tile.  Each block loads and
// converts one half of the A tile's rows, and all of its B tile, then
// copies the other half of A out of its partner's shared memory: 6144
// conversions per block where a lone block needs 8192.  Larger clusters
// would convert less, but an H100 holds fewer clusters of 4 or 8 at once
// (cudaOccupancyMaxActiveClusters) than the masked mode's 128 tiles
// need, and a second wave costs more than the conversions save.
constexpr int VP_TM_CN = 2;
constexpr int VP_TM_SHARE_A = VP_TM_BM / VP_TM_CN;  // A rows a block converts
constexpr int VP_TM_PER_A = VP_TM_SHARE_A * VP_TM_KC / VP_TM_THREADS;  // 4
constexpr int VP_TM_PER_B = VP_TM_KC * VP_TM_BN / VP_TM_THREADS;       // 8
static_assert(VP_TM_PER_A * VP_TM_THREADS == VP_TM_SHARE_A * VP_TM_KC &&
              VP_TM_PER_B * VP_TM_THREADS == VP_TM_KC * VP_TM_BN,
              "whole shares per thread");

// Where element s of this thread's share lies: A (row r, k c) for s <
// VP_TM_PER_A, with a warp on 4 rows x 8 consecutive k (its stores to the
// k-major tile hit 32 banks); B (k kb, column n) for s < VP_TM_PER_B, a
// warp on 32 consecutive columns of one k row.
__device__ __forceinline__ void vp_tm_slot_a(int s, int cx, int& r, int& c) {
  const int e = threadIdx.x + s * VP_TM_THREADS;
  const int q = e >> 5, l = e & 31;
  r = cx * VP_TM_SHARE_A + (q / (VP_TM_KC / 8)) * 4 + (l >> 3);
  c = (q % (VP_TM_KC / 8)) * 8 + (l & 7);
}

__device__ __forceinline__ void vp_tm_slot_b(int s, int& kb, int& n) {
  const int e = threadIdx.x + s * VP_TM_THREADS;
  kb = e / VP_TM_BN;
  n = e % VP_TM_BN;
}

// The value of one raw element: from the loader's table of values where
// it has one (lut non-null), else by its conversion.
template <class Load>
__device__ __forceinline__ float vp_tm_value(const Load& load, int bits,
                                             int aux, const float* tab,
                                             const float* lut) {
  if constexpr (Load::kLut) {
    if (lut != nullptr) return lut[load.lut_index(bits)];
  }
  return load.value(bits, aux, tab);
}

// Fill `lut` with the loader's table of values (threads in turn) and
// return it, or return null where the loader has none.
template <class Load>
__device__ __forceinline__ const float* vp_tm_lut(const Load& load,
                                                  float* lut,
                                                  const float* tab) {
  if constexpr (Load::kLut) {
    const int n = load.lut_size();
    if (n == 0) return nullptr;
    for (int j = threadIdx.x; j < n; j += VP_TM_THREADS)
      lut[j] = load.lut_entry(j, tab);
    return lut;
  }
  return nullptr;
}

// Stage this block's share of one k chunk, A rows into a_s[k][m] and B
// k rows into b_s[k][n], zeros outside the operands, in two steps.
// vp_tm_fetch reads a thread's raw elements (32 bits, plus an index byte
// for planes) into registers all at once: one memory round trip, during
// which the caller can do other work.  vp_tm_convert converts them, all
// in flight together, with the scales looked up in a_tab / b_tab or the
// values in a_lut / b_lut, and stores them.
struct VPTMRaw {
  int va[VP_TM_PER_A], xa[VP_TM_PER_A], vb[VP_TM_PER_B], xb[VP_TM_PER_B];
};

template <class LoadA, class LoadB>
__device__ __forceinline__ void vp_tm_fetch(
    const LoadA& load_a, const LoadB& load_b, VPTMRaw& raw,
    const VPMMGeom& g, long long a0, long long b0, int m0, int n0, int k0,
    int cx) {
#pragma unroll
  for (int s = 0; s < VP_TM_PER_A; ++s) {
    int r, c;
    vp_tm_slot_a(s, cx, r, c);
    const bool in = m0 + r < g.M && k0 + c < g.K;
    const long long idx = a0 + (long long)(m0 + r) * g.K + k0 + c;
    raw.va[s] = in ? load_a.fetch(idx) : 0;
    raw.xa[s] = LoadA::kAux && in ? load_a.fetch_aux(idx) : 0;
  }
#pragma unroll
  for (int s = 0; s < VP_TM_PER_B; ++s) {
    int kb, n;
    vp_tm_slot_b(s, kb, n);
    const bool in = k0 + kb < g.K && n0 + n < g.N;
    const long long idx = b0 + (long long)(k0 + kb) * g.N + n0 + n;
    raw.vb[s] = in ? load_b.fetch(idx) : 0;
    raw.xb[s] = LoadB::kAux && in ? load_b.fetch_aux(idx) : 0;
  }
}

template <class LoadA, class LoadB>
__device__ __forceinline__ void vp_tm_convert(
    const LoadA& load_a, const LoadB& load_b, const VPTMRaw& raw,
    float* a_s, float* b_s, const float* a_tab, const float* b_tab,
    const float* a_lut, const float* b_lut, int cx) {
#pragma unroll
  for (int s = 0; s < VP_TM_PER_A; ++s) {   // outside A: raw 0, value +0
    int r, c;
    vp_tm_slot_a(s, cx, r, c);
    a_s[c * VP_TM_AST + r] =
        vp_tm_value(load_a, raw.va[s], raw.xa[s], a_tab, a_lut);
  }
#pragma unroll
  for (int s = 0; s < VP_TM_PER_B; ++s) {
    int kb, n;
    vp_tm_slot_b(s, kb, n);
    b_s[kb * VP_TM_BST + n] =
        vp_tm_value(load_b, raw.vb[s], raw.xb[s], b_tab, b_lut);
  }
}

// Copy the other half of the chunk's A tile out of the partner block's
// shared memory: one 16-byte value per thread.
__device__ __forceinline__ void vp_tm_gather(float* a_s, int cx) {
  constexpr int AQ = VP_TM_SHARE_A / 4;   // float4 per k of a half
  static_assert(VP_TM_CN == 2 && VP_TM_KC * AQ == VP_TM_THREADS,
                "one float4 of the partner's half per thread");
  const int px = 1 - cx;                  // the partner's rank
  const int o = (threadIdx.x / AQ) * VP_TM_AST + px * VP_TM_SHARE_A +
                (threadIdx.x % AQ) * 4;
  *(float4*)(a_s + o) = *(const float4*)cooperative_groups::this_cluster()
                             .map_shared_rank(a_s + o, px);
}

// acc[i][j] += a[k][rm + i] * b[k][cn + j] for k in [c, c_end) of the
// staged chunk, in k order; with kMixed, a product whose output is muted
// (!(a_on[i] || b_on[j])) adds +0 instead.
template <bool kMixed>
__device__ __forceinline__ void vp_tm_fma(
    float (&acc)[VP_TM_MR][VP_TM_NR], const float* a_s, const float* b_s,
    int rm, int cn, int c, int c_end, const bool (&a_on)[VP_TM_MR],
    const bool (&b_on)[VP_TM_NR]) {
  static_assert(VP_TM_MR == 4 && VP_TM_NR == 4, "16-byte reads");
#pragma unroll 8
  for (; c < c_end; ++c) {
    const float4 a = *(const float4*)&a_s[c * VP_TM_AST + rm];
    const float4 b = *(const float4*)&b_s[c * VP_TM_BST + cn];
    const float av[VP_TM_MR] = {a.x, a.y, a.z, a.w};
    const float bv[VP_TM_NR] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < VP_TM_MR; ++i)
#pragma unroll
      for (int j = 0; j < VP_TM_NR; ++j)
        acc[i][j] = fmaf(!kMixed || a_on[i] || b_on[j] ? av[i] : 0.f,
                         bv[j], acc[i][j]);
  }
}

// Grid (n tiles rounded up to whole pairs, m tiles, G); a block past the
// output's edge still stages its half of A for its partner.
template <class LoadA, class LoadB>
__global__ void __launch_bounds__(VP_TM_THREADS, 1)
vp_mm_tile_kernel(LoadA load_a, LoadB load_b, float* __restrict__ out,
                  const int* __restrict__ a_act,
                  const int* __restrict__ b_act, VPMMGeom g) {
  constexpr int A_WORDS = VP_TM_KC * VP_TM_AST, B_WORDS = VP_TM_KC * VP_TM_BST;
  __shared__ __align__(16) float a_s[A_WORDS];  // [k][m]
  __shared__ __align__(16) float b_s[B_WORDS];  // [k][n]
  __shared__ float a_tab[VP_MAX_K], b_tab[VP_MAX_K];  // 2^-f_i per index
  __shared__ float a_lv[LoadA::kLut ? VP_LUT_MAX : 1];  // value per FXP raw
  __shared__ float b_lv[LoadB::kLut ? VP_LUT_MAX : 1];
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int cx = blockIdx.x % VP_TM_CN;
  const int m0 = blockIdx.y * VP_TM_BM, n0 = blockIdx.x * VP_TM_BN;
  const long long gi = blockIdx.z;
  // Blocks past the output's edge only stage; threads past the first
  // VP_TM_FMA_THREADS only stage.
  const bool active = m0 < g.M && n0 < g.N &&
                      threadIdx.x < VP_TM_FMA_THREADS;
  // A warp covers 4 x 8 micro-tiles, so each k's micro-tile reads touch
  // 64 bytes of A (4 distinct 16-byte values) and 128 of B (8 distinct).
  constexpr int WX = VP_TM_BN / VP_TM_NR / 8;  // warps along n
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rm = ((warp / WX) * 4 + lane / 8) * VP_TM_MR;
  const int cn = ((warp % WX) * 8 + lane % 8) * VP_TM_NR;
  const long long a0 = gi * g.M * g.K, b0 = gi * g.K * g.N;
  const int nkt = a_act ? g.K / g.bk : 0;
  float acc[VP_TM_MR][VP_TM_NR];
#pragma unroll
  for (int i = 0; i < VP_TM_MR; ++i)
#pragma unroll
    for (int j = 0; j < VP_TM_NR; ++j) acc[i][j] = 0.f;
  const float* a_lut = nullptr;
  const float* b_lut = nullptr;
  for (int k0 = 0; k0 < g.K; k0 += VP_TM_KC) {
    // The partner has copied this block's last half of A (and this block
    // has used its tiles) before the next chunk overwrites them.
    if (k0 > 0) cluster.sync();
    VPTMRaw raw;
    vp_tm_fetch(load_a, load_b, raw, g, a0, b0, m0, n0, k0, cx);
    if (k0 == 0) {   // the tables, while the first chunk is in flight
      vp_scale_table(a_tab, load_a.fmt());
      vp_scale_table(b_tab, load_b.fmt());
      __syncthreads();
      a_lut = vp_tm_lut(load_a, a_lv, a_tab);
      b_lut = vp_tm_lut(load_b, b_lv, b_tab);
      if (a_lut || b_lut) __syncthreads();
    }
    vp_tm_convert(load_a, load_b, raw, a_s, b_s, a_tab, b_tab, a_lut, b_lut,
                  cx);
    cluster.sync();                  // both halves of A converted
    vp_tm_gather(a_s, cx);
    __syncthreads();                 // this block's tiles complete
    // Without masks the whole chunk (its padding adds +0); with masks one
    // k-range per mask tile kt.
    const bool loud_a[VP_TM_MR] = {}, loud_b[VP_TM_NR] = {};  // unread
    if (active && !a_act)
      vp_tm_fma<false>(acc, a_s, b_s, rm, cn, 0, VP_TM_KC, loud_a, loud_b);
    const int kc = min(VP_TM_KC, g.K - k0);
    int c = active && a_act ? 0 : kc;
    while (c < kc) {
      const int kt = (k0 + c) / g.bk;
      const int c_end = min(kc, (kt + 1) * g.bk - k0);
      bool a_on[VP_TM_MR], b_on[VP_TM_NR];
      bool all_a = true, all_b = true, any = false;
#pragma unroll
      for (int i = 0; i < VP_TM_MR; ++i) {   // rows past the edge: loud,
        const int row = m0 + rm + i;         // and discarded
        a_on[i] = row >= g.M ||
                  a_act[(gi * (g.M / g.bm) + row / g.bm) * nkt + kt] != 0;
        all_a = all_a && a_on[i];
        any = any || a_on[i];
      }
#pragma unroll
      for (int j = 0; j < VP_TM_NR; ++j) {
        const int col = n0 + cn + j;
        b_on[j] = col >= g.N ||
                  b_act[(gi * nkt + kt) * (g.N / g.bn) + col / g.bn] != 0;
        all_b = all_b && b_on[j];
        any = any || b_on[j];
      }
      const bool all = all_a || all_b;
      if (all) {
        vp_tm_fma<false>(acc, a_s, b_s, rm, cn, c, c_end, a_on, b_on);
      } else if (any) {
        vp_tm_fma<true>(acc, a_s, b_s, rm, cn, c, c_end, a_on, b_on);
      }
      c = c_end;
    }
  }
  cluster.sync();  // no block leaves while its partner may still copy
  if (!active) return;
  const bool vec = (g.N & 3) == 0;
#pragma unroll
  for (int i = 0; i < VP_TM_MR; ++i) {
    const int row = m0 + rm + i, col = n0 + cn;
    if (row >= g.M) continue;
    float* o = out + (gi * g.M + row) * g.N + col;
    if (vec && col + 3 < g.N) {
      *(float4*)o = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < VP_TM_NR; ++j)
        if (col + j < g.N) o[j] = acc[i][j];
    }
  }
}

// Launch one body (VP_MM_WARP or VP_MM_TILE) after checking the masks.
// The warp body takes tn = the smallest power of two >= N, at most 8, and
// tm = 32 / tn; the tile body one block per 64 x 64 output tile, in
// pairs along n.  Both kernels run the body they are
// given, so at one shape and body their sums run in the same order.
template <class LoadA, class LoadB>
int vp_mm_launch(const LoadA& load_a, const LoadB& load_b, void* out,
                 const int* a_act, const int* b_act, int G, int M, int K,
                 int N, int bm, int bk, int bn, int body,
                 cudaStream_t stream) {
  VPMMGeom g{G, M, K, N, bm, bk, bn, 0, 0};
  if ((a_act == nullptr) != (b_act == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (a_act && (bm <= 0 || bk <= 0 || bn <= 0 || M % bm || K % bk ||
                N % bn)) {
    return (int)cudaErrorInvalidValue;
  }
  if (body == VP_MM_WARP) {
    g.tn = 1;
    while (g.tn < N && g.tn < 8) g.tn <<= 1;
    g.tm = 32 / g.tn;
    const long long warps = (long long)G * ((M + g.tm - 1) / g.tm) *
                            ((N + g.tn - 1) / g.tn);
    const long long blocks = (warps + VP_MM_WARPS - 1) / VP_MM_WARPS;
    if (blocks < 1) return 0;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    vp_mm_warp_kernel<LoadA, LoadB><<<(unsigned)blocks, VP_MM_WARPS * 32, 0,
                                      stream>>>(load_a, load_b, (float*)out,
                                                a_act, b_act, g);
    return (int)cudaGetLastError();
  }
  if (body != VP_MM_TILE) return (int)cudaErrorInvalidValue;
  const long long nx = ((N + VP_TM_BN - 1) / VP_TM_BN + VP_TM_CN - 1) /
                       VP_TM_CN * VP_TM_CN;
  const long long ny = (M + VP_TM_BM - 1) / VP_TM_BM;
  if (G < 1 || M < 1 || N < 1) return 0;
  if (nx > 0x7fffffffLL || ny > 65535 || G > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)nx, (unsigned)ny, (unsigned)G);
  cfg.blockDim = dim3(VP_TM_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = VP_TM_CN;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, vp_mm_tile_kernel<LoadA, LoadB>, load_a, load_b, (float*)out,
      a_act, b_act, g);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The batch body.  A product's operands must fit one warp's staging: M N
// <= 32 outputs (one per lane); K a multiple of 4 and of A's chunk
// (LoadA::kPer elements, so every row of A is whole chunks) and K N a
// multiple of B's; M K <= VP_MB_A_MAX and K N <= VP_MB_B_MAX (one load
// round of 16 bytes per lane: up to 8 chunks of f32 A a lane, 4 of int16
// words, 2 of int8 significands plus 2 of indices, and one chunk of B
// (plus its index chunk) on each of the first K N / kPer lanes); and the
// converted A rows and B columns, (M + N) (K + 4) floats, within
// VP_MB_WARP_FLOATS; every plane 16-byte aligned.  kernels/vp_matmul.py
// (batch_fits, qmm_body, vmm_body) sends other shapes to the warp body.
// Each warp's area holds A row-major with row stride K + 4 and B
// transposed (column n at row M + n, same stride): a chunk of A lands as
// kPer / 4 float4 stores at the slot vp_mb_slots gives it, a chunk of B
// element by element down its columns, and the float4 reads of a k-quad
// in the sum (lanes of one output row share an A address, lanes of one
// column a B address) are free of bank conflicts at (16, 64) x (64, 2).
constexpr int VP_MB_THREADS = 256;     // threads of a block
constexpr int VP_MB_WARPS = VP_MB_THREADS / 32;
constexpr int VP_MB_A_MAX = 1024;      // elements of A a product
constexpr int VP_MB_B_MAX = 128;       // elements of B a product
constexpr int VP_MB_WARP_FLOATS = 1280;  // a warp's converted operands
constexpr int VP_MB_LUT_MAX = 4096;    // largest FXP grid tabulated by value

// One product's raw chunks, as a lane holds them.
template <class LoadA, class LoadB>
struct VPMBRaw {
  static constexpr int NA = VP_MB_A_MAX / (32 * LoadA::kPer);
  uint4 a[NA];
  uint4 ax[LoadA::kAux ? NA : 1];
  uint4 b, bx;
};

// Where a lane's chunks land in the warp's area, the same for every
// product: A chunk j at a[j] (-1: none), the first element of its B
// chunk at (k, n) = (bk, bn) (bk -1: none).
template <int NA>
struct VPMBSlots {
  int a[NA];
  int bk, bn;
};

template <class LoadA, class LoadB, int NA>
__device__ __forceinline__ void vp_mb_slots(const VPMMGeom& g,
                                            VPMBSlots<NA>& s) {
  const int lane = threadIdx.x & 31, kp = g.K + 4;
  const int nca = g.M * g.K / LoadA::kPer, ncb = g.K * g.N / LoadB::kPer;
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    const int v = lane + 32 * j, e = v * LoadA::kPer;
    s.a[j] = v < nca ? (e / g.K) * kp + e % g.K : -1;
  }
  const int e = lane * LoadB::kPer;
  s.bk = lane < ncb ? e / g.N : -1;
  s.bn = e % g.N;
}

// Product gi's raw chunks, loaded into registers (the fused kernel's
// f32 operands; zeros past the batch or the operands).
template <class LoadA, class LoadB>
__device__ __forceinline__ void vp_mb_fetch(const LoadA& load_a,
                                            const LoadB& load_b,
                                            const VPMMGeom& g, long long gi,
                                            VPMBRaw<LoadA, LoadB>& r) {
  static_assert(!LoadA::kAux && !LoadB::kAux, "index planes take the ring");
  const int lane = threadIdx.x & 31;
  const int nca = g.M * g.K / LoadA::kPer, ncb = g.K * g.N / LoadB::kPer;
  const bool in = gi < g.G;
  const uint4 z = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int j = 0; j < VPMBRaw<LoadA, LoadB>::NA; ++j) {
    const int v = lane + 32 * j;
    r.a[j] = in && v < nca ? load_a.chunk(gi * nca + v) : z;
  }
  r.ax[0] = r.bx = z;
  r.b = in && lane < ncb ? load_b.chunk(gi * ncb + lane) : z;
}

// Convert product gi's raw chunks into the warp's area `ws` at the
// lane's slots (scales from a_stab / b_stab, or values from a_lut /
// b_lut: the loader's), then sum each output in k order (skipping the
// k-ranges CSPADE mutes) and store it.
template <class LoadA, class LoadB>
__device__ __forceinline__ void vp_mb_product(
    const LoadA& load_a, const LoadB& load_b, const VPMMGeom& g,
    long long gi, const VPMBRaw<LoadA, LoadB>& r, float* ws,
    const VPMBSlots<VPMBRaw<LoadA, LoadB>::NA>& s, const float* a_stab,
    const float* b_stab, const float* a_lut, const float* b_lut,
    float* __restrict__ out, const int* __restrict__ a_act,
    const int* __restrict__ b_act) {
  if (gi >= g.G) return;   // uniform over the warp
  const int lane = threadIdx.x & 31, kp = g.K + 4;
#pragma unroll
  for (int j = 0; j < VPMBRaw<LoadA, LoadB>::NA; ++j)
    if (s.a[j] >= 0) {
      float v[LoadA::kPer];
      load_a.values(r.a[j], r.ax[LoadA::kAux ? j : 0], a_stab, a_lut, v);
#pragma unroll
      for (int q = 0; q < LoadA::kPer / 4; ++q)
        *reinterpret_cast<float4*>(ws + s.a[j] + 4 * q) =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  if (s.bk >= 0) {
    float v[LoadB::kPer];
    load_b.values(r.b, r.bx, b_stab, b_lut, v);
    int k = s.bk, n = s.bn;
#pragma unroll
    for (int t = 0; t < LoadB::kPer; ++t) {
      ws[(g.M + n) * kp + k] = v[t];
      if (++n == g.N) {
        n = 0;
        ++k;
      }
    }
  }
  __syncwarp();
  if (lane < g.M * g.N) {
    const int m = lane / g.N, n = lane - m * g.N;
    const float* ar = ws + m * kp;
    const float* bc = ws + (g.M + n) * kp;
    float acc = 0.f;
    // k in [k, k_end) in order, four at a time where both are multiples
    // of 4 (the rows are 16-byte aligned): the same fmaf chain.
    const auto range = [&](int k, int k_end) {
      if (((k | k_end) & 3) == 0) {
        for (; k < k_end; k += 4) {
          const float4 a = *reinterpret_cast<const float4*>(ar + k);
          const float4 b = *reinterpret_cast<const float4*>(bc + k);
          acc = fmaf(a.x, b.x, acc);
          acc = fmaf(a.y, b.y, acc);
          acc = fmaf(a.z, b.z, acc);
          acc = fmaf(a.w, b.w, acc);
        }
      } else {
        for (; k < k_end; ++k) acc = fmaf(ar[k], bc[k], acc);
      }
    };
    if (a_act == nullptr) {
      range(0, g.K);
    } else {
      const int nkt = g.K / g.bk, nbn = g.N / g.bn;
      const int* a_row = a_act + (gi * (g.M / g.bm) + m / g.bm) * nkt;
      const int* b_col = b_act + gi * nkt * nbn + n / g.bn;
      for (int kt = 0; kt < nkt; ++kt)
        if ((a_row[kt] | b_col[(long long)kt * nbn]) != 0)
          range(kt * g.bk, (kt + 1) * g.bk);
    }
    out[(gi * g.M + m) * g.N + n] = acc;
  }
  __syncwarp();   // the area is free for the next product
}

// The stored operands' route (VPLoadWords, VPLoadPlanes): one lane of
// each warp copies whole products with cp.async.bulk into the warp's ring
// of VP_MB_STAGES stages in shared memory, each completing an mbarrier;
// the lanes wait for a product's stage, read its chunks, hand the stage
// back to the copy of the product VP_MB_STAGES ahead, and convert.  Up to
// three products a warp in flight, 110 KB an SM at (16, 64) x (64, 2);
// it measured 6 % faster than two products ahead in registers (PERF.md
// row 9).  The fused kernel's f32 operands (4736 bytes a product) stay on
// registers, one product ahead.
constexpr int VP_MB_STAGES = 3;
constexpr int VP_MB_STAGE_BYTES = 2304;   // A 2048 + B 256 at most

__device__ __forceinline__ void vp_bulk_copy(uint32_t dst, const void* src,
                                             int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Lane 0: product gi's planes into the stage at dst, completing bar.
template <class LoadA, class LoadB>
__device__ __forceinline__ void vp_mb_issue(const LoadA& load_a,
                                            const LoadB& load_b,
                                            const VPMMGeom& g, long long gi,
                                            uint32_t dst, uint32_t bar) {
  const int sa = g.M * g.K / LoadA::kPer * 16;
  const int sb = g.K * g.N / LoadB::kPer * 16;
  const int total = sa * (LoadA::kAux ? 2 : 1) + sb * (LoadB::kAux ? 2 : 1);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(total) : "memory");
  vp_bulk_copy(dst, (const char*)load_a.plane(0) + gi * sa, sa, bar);
  uint32_t o = sa;
  if constexpr (LoadA::kAux) {
    vp_bulk_copy(dst + o, (const char*)load_a.plane(1) + gi * sa, sa,
                 bar);
    o += sa;
  }
  vp_bulk_copy(dst + o, (const char*)load_b.plane(0) + gi * sb, sb,
               bar);
  if constexpr (LoadB::kAux)
    vp_bulk_copy(dst + o + sb, (const char*)load_b.plane(1) + gi * sb,
                 sb, bar);
}

__device__ __forceinline__ void vp_mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// A product's chunks from its stage, as vp_mb_fetch lays them out.
template <class LoadA, class LoadB>
__device__ __forceinline__ void vp_mb_read(const uint4* st, const VPMMGeom& g,
                                           VPMBRaw<LoadA, LoadB>& r) {
  const int lane = threadIdx.x & 31;
  const int nca = g.M * g.K / LoadA::kPer, ncb = g.K * g.N / LoadB::kPer;
  const uint4 z = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int j = 0; j < VPMBRaw<LoadA, LoadB>::NA; ++j) {
    const int v = lane + 32 * j;
    r.a[j] = v < nca ? st[v] : z;
    r.ax[LoadA::kAux ? j : 0] = LoadA::kAux && v < nca ? st[nca + v] : z;
  }
  const int o = nca * (LoadA::kAux ? 2 : 1);
  r.b = lane < ncb ? st[o + lane] : z;
  r.bx = LoadB::kAux && lane < ncb ? st[o + ncb + lane] : z;
}

// Whether the loaders' products take the ring (stored VP operands) or
// registers (the fused kernel's f32 operands, with their value tables).
template <class LoadA, class LoadB>
__host__ __device__ constexpr bool vp_mb_ring() {
  return !LoadA::kLut && !LoadB::kLut;
}

// Dynamic shared memory: the warps' areas, then the value tables of A (na
// floats) and B (nb), then (the ring) each warp's stages; a_table /
// b_table: the index table is valid (the value tables are then built
// from it, else by the chain).
template <class LoadA, class LoadB>
__global__ void __launch_bounds__(VP_MB_THREADS, 2)
vp_mm_batch_kernel(LoadA load_a, LoadB load_b, float* __restrict__ out,
                   const int* __restrict__ a_act,
                   const int* __restrict__ b_act, VPMMGeom g, int na, int nb,
                   int a_table, int b_table) {
  using Raw = VPMBRaw<LoadA, LoadB>;
  constexpr bool kRing = vp_mb_ring<LoadA, LoadB>();
  extern __shared__ __align__(16) float vp_mb_smem[];
  __shared__ float a_stab[VP_MAX_K], b_stab[VP_MAX_K];
  __shared__ int a_itab[VP_IDX_TAB], b_itab[VP_IDX_TAB];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ws = vp_mb_smem + warp * VP_MB_WARP_FLOATS;
  float* a_lut = vp_mb_smem + VP_MB_WARPS * VP_MB_WARP_FLOATS;
  float* b_lut = a_lut + na;
  const long long nw = (long long)gridDim.x * VP_MB_WARPS;
  long long gi = (long long)blockIdx.x * VP_MB_WARPS + warp;
  Raw r0, r1;
  __shared__ __align__(8) uint64_t bars[VP_MB_WARPS][VP_MB_STAGES];
  const char* stages = reinterpret_cast<const char*>(b_lut + nb) +
                       warp * VP_MB_STAGES * VP_MB_STAGE_BYTES;
  const uint32_t ring = (uint32_t)__cvta_generic_to_shared(stages);
  const uint32_t bar0 = (uint32_t)__cvta_generic_to_shared(&bars[warp][0]);
  if constexpr (kRing) {
    if (lane == 0) {
      for (int s = 0; s < VP_MB_STAGES; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                     ::"r"(bar0 + 8 * s) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int s = 0; s < VP_MB_STAGES; ++s)
        if (gi + s * nw < g.G)
          vp_mb_issue(load_a, load_b, g, gi + s * nw,
                      ring + s * VP_MB_STAGE_BYTES, bar0 + 8 * s);
    }
    __syncwarp();
  }
  if constexpr (!kRing)
    vp_mb_fetch(load_a, load_b, g, gi, r0);   // in flight while the tables
  load_a.tables(a_stab, a_itab);              // are built
  load_b.tables(b_stab, b_itab);
  __syncthreads();
  if constexpr (LoadA::kLut)
    for (int j = threadIdx.x; j < na; j += VP_MB_THREADS)
      a_lut[j] = load_a.lut_value(j, a_table ? a_itab : nullptr, a_stab);
  if constexpr (LoadB::kLut)
    for (int j = threadIdx.x; j < nb; j += VP_MB_THREADS)
      b_lut[j] = load_b.lut_value(j, b_table ? b_itab : nullptr, b_stab);
  __syncthreads();
  VPMBSlots<Raw::NA> sl;
  vp_mb_slots<LoadA, LoadB>(g, sl);
  const auto product = [&](long long i, const Raw& r) {
    vp_mb_product(load_a, load_b, g, i, r, ws, sl, a_stab, b_stab, a_lut,
                  b_lut, out, a_act, b_act);
  };
  if constexpr (kRing) {
    int s = 0;
    uint32_t ph = 0;
    for (; gi < g.G; gi += nw) {
      vp_mbar_wait(bar0 + 8 * s, ph);
      vp_mb_read<LoadA, LoadB>(reinterpret_cast<const uint4*>(
                                   stages + s * VP_MB_STAGE_BYTES), g, r0);
      __syncwarp();   // every lane has read the stage: refill it
      if (lane == 0 && gi + VP_MB_STAGES * nw < g.G) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        vp_mb_issue(load_a, load_b, g, gi + VP_MB_STAGES * nw,
                    ring + s * VP_MB_STAGE_BYTES, bar0 + 8 * s);
      }
      product(gi, r0);
      if (++s == VP_MB_STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
  } else {
    // Two products per step, each one's loads issued before the other is
    // converted: r0 and r1 take turns.
    for (; gi < g.G; gi += 2 * nw) {
      vp_mb_fetch(load_a, load_b, g, gi + nw, r1);
      product(gi, r0);
      vp_mb_fetch(load_a, load_b, g, gi + 2 * nw, r0);
      product(gi + nw, r1);
    }
  }
}

// Launch the batch body: na / nb the sizes of the operands' FXP grids
// where the loader tabulates values (kLut: each at most VP_MB_LUT_MAX;
// else 0), a_table / b_table whether their index tables are valid (the
// value tables are then built from them, else by the chain).  Refuses
// (cudaErrorInvalidValue) a shape, mask grid or grid size it does not
// take; the caller checks the alignment and the layout.
template <class LoadA, class LoadB>
int vp_mm_batch_launch(const LoadA& load_a, const LoadB& load_b, void* out,
                       const int* a_act, const int* b_act, int G, int M,
                       int K, int N, int bm, int bk, int bn, int na, int nb,
                       int a_table, int b_table, cudaStream_t stream) {
  constexpr bool kRing = vp_mb_ring<LoadA, LoadB>();
  VPMMGeom g{G, M, K, N, bm, bk, bn, 0, 0};
  if ((a_act == nullptr) != (b_act == nullptr))
    return (int)cudaErrorInvalidValue;
  if (a_act && (bm <= 0 || bk <= 0 || bn <= 0 || M % bm || K % bk || N % bn))
    return (int)cudaErrorInvalidValue;
  if (M < 1 || N < 1 || K < 4 || K % 4 || K % LoadA::kPer ||
      (K * N) % LoadB::kPer || M * N > 32 || M * K > VP_MB_A_MAX ||
      K * N > VP_MB_B_MAX || (M + N) * (K + 4) > VP_MB_WARP_FLOATS)
    return (int)cudaErrorInvalidValue;
  if (LoadA::kLut ? (na < 1 || na > VP_MB_LUT_MAX) : na != 0)
    return (int)cudaErrorInvalidValue;
  if (LoadB::kLut ? (nb < 1 || nb > VP_MB_LUT_MAX) : nb != 0)
    return (int)cudaErrorInvalidValue;
  if (G < 1) return 0;
  const auto kern = vp_mm_batch_kernel<LoadA, LoadB>;
  const int smem =
      (VP_MB_WARPS * VP_MB_WARP_FLOATS + na + nb) * (int)sizeof(float) +
      (kRing ? VP_MB_WARPS * VP_MB_STAGES * VP_MB_STAGE_BYTES : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        VP_MB_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long blocks = ((long long)g.G + VP_MB_WARPS - 1) / VP_MB_WARPS;
  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  kern<<<(unsigned)blocks, VP_MB_THREADS, smem, stream>>>(
      load_a, load_b, static_cast<float*>(out), a_act, b_act, g, na, nb,
      a_table, b_table);
  return (int)cudaGetLastError();
}

extern "C" const char* vp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
