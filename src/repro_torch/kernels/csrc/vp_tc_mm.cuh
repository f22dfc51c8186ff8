// The warp-specialized tensor-core body shared by the products over packed
// VP words: out (R, C) = A (R x S) . B (S x C), one operand real (f32 or
// bf16), the other packed words, dequantized into bf16 in shared memory.
//
// Three roles (TcRole) name which operand is real and how each is stored:
//   TC_DX   vp_matmul_dx       A = g (M, N) real, K-major;
//                              B = w^T, words stored (K, N), K-major.
//   TC_DW   vp_matmul_dw       A = a^T, words stored (M, K), MN-major;
//                              B = g (M, N) real, MN-major.
//   TC_FWD  vp_dequant_matmul  A = x (M, K) real, K-major;
//                              B = w, words stored (K, N), MN-major.
// K-major: the contraction is contiguous; MN-major: the output dim is.
// `wgmma` reads an MN-major operand through its transpose bit, so every
// operand stays in its stored orientation and nothing is transposed.
//
// Why bf16 computes the same function: a word of a format with M <= 9
// decodes to m * 2^-f_i with |m| <= 2^(M-1) <= 256, which fits bf16's
// 8-bit significand, and bf16 has f32's exponent range, so the
// dequantized operand is exact in bf16.  A bf16 real operand times it is
// an exact f32 product, so `wgmma ... f32.bf16.bf16` forms the
// reference's products exactly; only the order of the f32 sum differs.
// An f32 real operand is split into three bf16 terms hi + mid + lo by
// truncation (split8): never an infinity, and exact for every f32 of
// exponent -110 to 127, up to +-FLT_MAX.  Below 2^-110 the lo term falls
// into bf16's subnormals and drops the bits under 2^-133 (a relative
// error up to 2^-16 at 2^-117, growing as the value shrinks).  Each
// term's product is exact, and each 64-deep block's tensor-core partial
// is added into an f32 accumulator in registers (the tensor cores' own
// f32 sum may drop low bits, so it never runs over more than one block).
//
// Design: a block computes a 128 x 64 output tile over 64-deep
// contraction slices, with warps specialized by role and handing slices
// on through mbarriers (no block-wide barrier in the loop):
// - a producer warp keeps up to 8 slices in flight in a ring of TMA
//   copies (as many slots as shared memory holds): a bf16 real operand
//   straight into its 128-byte-swizzled `wgmma` tile, an f32 one and the
//   words raw.  TMA zero fills past the edges.  Where a row is not
//   16-byte aligned, TMA cannot map the matrix and the warp loads
//   elements into the same layouts;
// - two converter warpgroups dequantize the words (shift, mask, a 2^-f
//   table in shared memory, int -> float by the magic number) and split
//   an f32 real operand, into bf16 tiles in the same layout, into one of
//   two conversion buffers (one where two do not fit: an f32 operand),
//   and make those generic-proxy stores visible to `wgmma` with
//   `fence.proxy.async`;
// - two consumer warpgroups of 64 rows each run `wgmma` m64n64k16 with
//   the accumulators in registers, one slice's group in flight while the
//   next is issued.
// No f32 or bf16 weight plane and no transposed copy exists in device
// memory.  When the output has too few tiles to fill the card, the
// wrapper splits the contraction: each split writes f32 partials into a
// workspace and a reduction kernel (splitk_reduce) sums them in split
// order (deterministic) and casts.
//
// Each including source defines its own __global__ kernels around
// tc_body and splitk_reduce, so each library names its kernels.
#pragma once

#include <cuda.h>

#include <cstring>
#include <type_traits>

#include "vp_common.cuh"

namespace {

constexpr int TC_BM = 128;      // output rows per block: 2 warpgroups x 64
constexpr int TC_BN = 64;       // output columns per block
constexpr int TC_BK = 64;       // contraction slice: 128 bytes of bf16
constexpr int TC_CONSUMERS = 256;   // two warpgroups: wgmma
constexpr int TC_CONVERTERS = 256;  // two warpgroups: dequantize, split
constexpr int TC_THREADS = TC_CONSUMERS + TC_CONVERTERS + 32;  // + producer
constexpr int TC_MAX_STAGES = 8;  // slices in flight in the copy ring
constexpr int TC_SMEM_MAX = 232448;

enum TcRole { TC_DX = 0, TC_DW = 1, TC_FWD = 2 };

template <int ROLE>
struct RoleOf {
  static constexpr bool A_REAL = ROLE != TC_DW;  // else B is the real one
  static constexpr bool A_KMAJ = ROLE != TC_DW;
  static constexpr bool B_KMAJ = ROLE == TC_DX;
};

// The launch's operands.  A (R x S) and B (S x C) are read from `a` and
// `b` in their stored orientation (RoleOf).
struct TcArgs {
  const void* a;
  const void* b;
  void* out;        // (R, C) of out_bf16 ? bf16 : f32
  float* ws;        // (split, R, C) f32 partials when gridDim.z > 1
  int R, C, S;
  int lda, ldb;     // leading dims (elements) of the stored a and b
  int kb_per;       // contraction slices per split
  int vec;          // TMA copies (every row 16-byte aligned)
  int out_bf16;
  VPFmt f;
};

// Shared memory of one block (bytes; every part a multiple of 1024):
//   ring[STAGES]:    per slice, the real operand (a bf16 tile in the
//                    wgmma layout, or raw f32) and the raw words, as TMA
//                    copies them;
//   conv[CB]:        the slice's dequantized words as a bf16 tile, and
//                    for an f32 real operand its three bf16 terms; two
//                    buffers when they fit, so one slice converts while
//                    the previous one's wgmmas run.
template <int ROLE, typename GT, typename WT>
struct TcCfg {
  static constexpr bool F32 = std::is_same<GT, float>::value;
  static constexpr bool A_REAL = RoleOf<ROLE>::A_REAL;
  static constexpr int G_ROWS = A_REAL ? TC_BM : TC_BN;  // real's out rows
  static constexpr int W_ROWS = A_REAL ? TC_BN : TC_BM;  // the words'
  static constexpr int G_SLOT = G_ROWS * TC_BK * (F32 ? 4 : 2);
  static constexpr int W_SLOT = W_ROWS * TC_BK * (int)sizeof(WT);
  static constexpr int SLOT = G_SLOT + W_SLOT;
  static constexpr int W_TILE = W_ROWS * TC_BK * 2;
  static constexpr int G_TILE = G_ROWS * TC_BK * 2;
  static constexpr int CONV = W_TILE + (F32 ? 3 * G_TILE : 0);
  // Alignment slack, scale table, mbarriers.
  static constexpr int FIXED =
      1024 + VP_MAX_K * 4 + (2 * TC_MAX_STAGES + 4) * 8;
  // Two conversion buffers where four ring slots fit beside them; then
  // as many slots as fit, up to TC_MAX_STAGES.
  static constexpr int CB = FIXED + 2 * CONV + 4 * SLOT <= TC_SMEM_MAX ? 2 : 1;
  static constexpr int FIT = (TC_SMEM_MAX - FIXED - CB * CONV) / SLOT;
  static constexpr int STAGES = FIT < TC_MAX_STAGES ? FIT : TC_MAX_STAGES;
  static constexpr int SMEM = FIXED + STAGES * SLOT + CB * CONV;
  static_assert(STAGES >= 2, "two ring slots at least");
};

// The two TMA maps of a launch (unused on the element-load path).
struct TcMaps {
  CUtensorMap a, b;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of TMA copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Spin until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// TMA copy of the box at (inner c0, outer c1) of `map` into dst; zero
// fill outside the matrix; completion counted on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// Where 16-byte chunk j of row r of a fetched tile goes, in 16-byte
// units.  Plain: row-major, unpadded.  The two bf16 layouts the `wgmma`
// descriptors name, both in the 128-byte swizzle (chunk c of a 128-byte
// row r stored at c ^ (r % 8)):
//   KMajor:  rows of 64 contraction elements, one 128-byte row each;
//   MNMajor: rows of the contraction, cut into blocks of 64 output
//            elements; block b holds 64 rows of 128 bytes (8 KB).
template <int CPR>
struct Plain {
  __device__ __forceinline__ int operator()(int r, int j) const {
    return r * CPR + j;
  }
};
struct KMajor {
  __device__ __forceinline__ int operator()(int r, int j) const {
    return r * 8 + (j ^ (r & 7));
  }
};
struct MNMajor {
  __device__ __forceinline__ int operator()(int r, int j) const {
    return (j >> 3) * 512 + r * 8 + ((j & 7) ^ (r & 7));
  }
};

// Element-load path (rows not 16-byte aligned): copy the ROWS x COLS
// tile at (row0, col0) of a row-major (row_lim, col_lim) matrix with
// leading dimension ld into shared memory, 16-byte chunk (r, j) at
// dst + place(r, j), in the layout the TMA copies give; elements outside
// the matrix read as 0.
template <typename T, int ROWS, int COLS, class Place>
__device__ __forceinline__ void fetch_tile(int lane, uint4* dst, Place place,
                                           const T* src, int ld, int row0,
                                           int col0, int row_lim,
                                           int col_lim) {
  constexpr int EPC = 16 / (int)sizeof(T);
  constexpr int CPR = COLS / EPC;
  for (int u = lane; u < ROWS * CPR; u += 32) {
    const int r = u / CPR, j = u % CPR;
    const int gr = row0 + r, gc = col0 + j * EPC;
    const int n = gr < row_lim ? min(max(col_lim - gc, 0), EPC) : 0;
    T* d = reinterpret_cast<T*>(dst + place(r, j));
    const T* s = src + (long long)gr * ld + gc;
#pragma unroll
    for (int e = 0; e < EPC; ++e) d[e] = e < n ? s[e] : T(0);
  }
}

// One operand's slice on the element-load path: EXT output elements at
// `o0` by TC_BK contraction elements at s0, stored K-major (EXT, S) or
// MN-major (S, EXT) with leading dimension ld.
template <typename T, int EXT, bool KMAJ, class Place>
__device__ __forceinline__ void fetch_operand(int lane, uint4* dst,
                                              Place place, const T* src,
                                              int ld, int o0, int s0,
                                              int o_lim, int s_lim) {
  if constexpr (KMAJ) {
    fetch_tile<T, EXT, TC_BK>(lane, dst, place, src, ld, o0, s0, o_lim,
                              s_lim);
  } else {
    fetch_tile<T, TC_BK, EXT>(lane, dst, place, src, ld, s0, o0, s_lim,
                              o_lim);
  }
}

// vp_dequant (vp_common.cuh) tuned for throughput: the 2^-f_i select
// chain becomes a lookup in the launch's scale table in shared memory,
// and int -> float goes through the 1.5 * 2^23 magic number (an integer
// add and a float subtract, exact for |m| < 2^22) instead of the slower
// conversion unit.
struct WordDeq {
  int E, mask;
  const float* tab;
  __device__ __forceinline__ float value(int m, int i) const {
    return (__int_as_float(0x4B400000 + m) - 12582912.0f) * tab[i];
  }
};

// Two values exact in bf16 -> their bf16 pair (the high halves of the
// f32 bits: the low halves are zero).
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Eight consecutive words -> their eight values in bf16 (exact: M <= 9).
// Word b of a 32-bit lane of W-bit words: significand = the arithmetic
// shift of the lane moved so the word is on top, index = its low E bits.
__device__ __forceinline__ uint4 words8(const int8_t* p, const WordDeq& dq) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  float v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t u = k < 4 ? x.x : x.y;
    const int b = k & 3;
    const int m = ((int)(u << (24 - 8 * b))) >> (24 + dq.E);
    v[k] = dq.value(m, (int)(u >> (8 * b)) & dq.mask);
  }
  return make_uint4(pack_exact(v[0], v[1]), pack_exact(v[2], v[3]),
                    pack_exact(v[4], v[5]), pack_exact(v[6], v[7]));
}
__device__ __forceinline__ uint4 words8(const int16_t* p, const WordDeq& dq) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t u4[4] = {x.x, x.y, x.z, x.w};
  uint32_t o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t u = u4[k];
    const float lo =
        dq.value(((int)(u << 16)) >> (16 + dq.E), (int)u & dq.mask);
    const float hi =
        dq.value(((int)u) >> (16 + dq.E), (int)(u >> 16) & dq.mask);
    o[k] = pack_exact(lo, hi);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Eight f32 -> three chunks of eight bf16, hi, mid and lo: each the high
// 16 bits of what the earlier terms left (a truncation, so never larger
// in magnitude than the value and never infinite).  Each subtraction is
// exact: a term holds the residual's top 8 significant bits.  For a
// value of exponent e the residual after two terms holds at most the 8
// bits down to 2^(e-23), so lo is exact when 2^(e-23) >= 2^-133, bf16's
// least subnormal: e >= -110.
__device__ __forceinline__ void split8(const float* p, uint4 (&o)[3]) {
  const float4 x = reinterpret_cast<const float4*>(p)[0];
  const float4 y = reinterpret_cast<const float4*>(p)[1];
  float r[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t lo = __float_as_uint(r[2 * k]) & 0xFFFF0000u;
      const uint32_t hi = __float_as_uint(r[2 * k + 1]) & 0xFFFF0000u;
      w[k] = __byte_perm(lo, hi, 0x7632);
      r[2 * k] -= __uint_as_float(lo);
      r[2 * k + 1] -= __uint_as_float(hi);
    }
    o[t] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// A raw ROWS x COLS slice (row-major, as fetched) -> bf16 tiles, chunk
// (r, j) at place(r, j): words dequantized into one tile, f32 split into
// three (TILE chunks apart).  Neighbouring threads take neighbouring
// chunks of a row: conflict-free reads and writes.
template <int ROWS, int COLS, int TILE, typename T, class Place>
__device__ __forceinline__ void convert(int t, const T* raw, uint4* tile,
                                        Place place, const WordDeq& dq) {
  constexpr int CPR = COLS / 8;
  static_assert(ROWS * CPR % TC_CONVERTERS == 0, "whole rounds");
#pragma unroll
  for (int k = 0; k < ROWS * CPR / TC_CONVERTERS; ++k) {
    const int u = t + k * TC_CONVERTERS;
    const int r = u / CPR, j = u % CPR;
    const T* src = raw + r * COLS + j * 8;
    if constexpr (std::is_integral<T>::value) {
      tile[place(r, j)] = words8(src, dq);
    } else {
      uint4 o[3];
      split8(src, o);
#pragma unroll
      for (int t = 0; t < 3; ++t) tile[t * TILE + place(r, j)] = o[t];
    }
  }
}

// One operand's raw slice (EXT output elements by TC_BK, K-major or
// MN-major as stored) -> its bf16 tile(s) in the matching wgmma layout.
template <int EXT, bool KMAJ, int TILE, typename T>
__device__ __forceinline__ void convert_operand(int t, const T* raw,
                                                uint4* tile,
                                                const WordDeq& dq) {
  if constexpr (KMAJ) {
    convert<EXT, TC_BK, TILE>(t, raw, tile, KMajor{}, dq);
  } else {
    convert<TC_BK, EXT, TILE>(t, raw, tile, MNMajor{}, dq);
  }
}

// `wgmma` shared-memory descriptor of a bf16 tile in the 128-byte
// swizzle: start address >> 4, leading byte offset (bits 16-29), stride
// byte offset (bits 32-45), both in 16-byte units, layout type 1.
//   K-major:  8-row groups 1024 bytes apart (stride); leading unused.
//             A k16 step adds 32 bytes to the start.
//   MN-major: 8-row (8-deep) groups 1024 bytes apart (stride), 64-wide
//             output blocks 8 KB apart (leading).  A k16 step adds 16
//             rows, 2048 bytes.
// Tiles are 1024-byte aligned.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, int lbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Descriptor of k16 step kk of a tile, K-major or MN-major.
template <bool KMAJ>
__device__ __forceinline__ uint64_t tile_desc(const void* p, int kk) {
  return KMAJ ? sw128_desc(p, 1) + 2 * kk : sw128_desc(p, 512) + 128 * kk;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous `wgmma`s (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) asm volatile("" : "+f"(d[k])::"memory");
}

// d (64 x 64, this thread's 32 f32) += A (64 x 16) . B (16 x 64), A and
// B in shared memory (128-byte swizzle; TA / TB: that operand MN-major,
// read through wgmma's transpose bit); scale_d = 0 overwrites d instead.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// One 128 x 64 output tile (blockIdx.y, blockIdx.x) over the contraction
// slices of split blockIdx.z.
template <int ROLE, typename GT, typename WT>
__device__ __forceinline__ void tc_body(const TcArgs& p, const TcMaps& maps) {
  using Cfg = TcCfg<ROLE, GT, WT>;
  constexpr bool F32 = Cfg::F32;
  constexpr bool A_REAL = RoleOf<ROLE>::A_REAL;
  constexpr bool A_KMAJ = RoleOf<ROLE>::A_KMAJ;
  constexpr bool B_KMAJ = RoleOf<ROLE>::B_KMAJ;
  constexpr bool G_KMAJ = A_REAL ? A_KMAJ : B_KMAJ;  // the real operand's
  constexpr bool W_KMAJ = A_REAL ? B_KMAJ : A_KMAJ;  // the words'
  constexpr int NT = F32 ? 3 : 1;          // bf16 terms of the real one
  constexpr int CB = Cfg::CB;
  constexpr int S = Cfg::STAGES;
  extern __shared__ uint8_t tc_smem[];
  const uint32_t mis = smem_u32(tc_smem) & 1023;  // align to 1024 bytes
  uint8_t* ring = tc_smem + ((1024 - mis) & 1023);
  uint8_t* conv = ring + S * Cfg::SLOT;
  float* tab = reinterpret_cast<float*>(conv + CB * Cfg::CONV);
  uint64_t* full = reinterpret_cast<uint64_t*>(tab + VP_MAX_K);  // [S]
  uint64_t* empty = full + S;                                     // [S]
  uint64_t* cfull = empty + S;                                    // [CB]
  uint64_t* cempty = cfull + 2;                                   // [CB]

  const int tid = threadIdx.x;
  const int R0 = blockIdx.y * TC_BM, C0 = blockIdx.x * TC_BN;
  const int nkb = (p.S + TC_BK - 1) / TC_BK;
  const int kb0 = blockIdx.z * p.kb_per;
  const int n = min(nkb, kb0 + p.kb_per) - kb0;
  const bool vec = p.vec != 0;

  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < VP_CHAIN_K; ++k) tab[k] = p.f.scale[k];
#pragma unroll 1
    for (int k = VP_CHAIN_K; k < p.f.K; ++k)   // E 5-7: device memory
      tab[k] = __ldg(p.f.wide + k);
#pragma unroll
    for (int st = 0; st < S; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, 3);  // both consumer warpgroups, converters
    }
#pragma unroll
    for (int b = 0; b < CB; ++b) {
      mbar_init(cfull + b, 1);
      mbar_init(cempty + b, 2);  // both consumer warpgroups
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= TC_CONSUMERS + TC_CONVERTERS) {
    // ---- producer warp: slice j into ring slot j % S ----------------------
    const int lane = tid % 32;
    if (vec && lane != 0) return;
    if (vec) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&maps.a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&maps.b))
                   : "memory");
    }
    for (int j = 0; j < n; ++j) {
      const int st = j % S;
      mbar_wait(empty + st, ((j / S) & 1) ^ 1);
      const int s0 = (kb0 + j) * TC_BK;
      uint8_t* gs = ring + st * Cfg::SLOT;
      uint8_t* ws = gs + Cfg::G_SLOT;
      uint8_t* as = A_REAL ? gs : ws;
      uint8_t* bs = A_REAL ? ws : gs;
      if (vec) {  // TMA: each box whole, zero filled past the edges
        mbar_expect(full + st, Cfg::SLOT);
        if (A_KMAJ) {
          tma_load(as, &maps.a, s0, R0, full + st);
        } else {
          tma_load(as, &maps.a, R0, s0, full + st);
        }
        if (B_KMAJ) {
          tma_load(bs, &maps.b, s0, C0, full + st);
        } else {
          tma_load(bs, &maps.b, C0, s0, full + st);
        }
        continue;
      }
      uint4* g4 = reinterpret_cast<uint4*>(gs);
      uint4* w4 = reinterpret_cast<uint4*>(ws);
      constexpr int WE = 16 / (int)sizeof(WT);
      constexpr int GE = F32 ? 4 : 8;
      const void* gsrc = A_REAL ? p.a : p.b;
      const void* wsrc = A_REAL ? p.b : p.a;
      const int gld = A_REAL ? p.lda : p.ldb, wld = A_REAL ? p.ldb : p.lda;
      const int g0 = A_REAL ? R0 : C0, w0 = A_REAL ? C0 : R0;
      const int glim = A_REAL ? p.R : p.C, wlim = A_REAL ? p.C : p.R;
      constexpr int G_COLS = G_KMAJ ? TC_BK : Cfg::G_ROWS;
      constexpr int W_COLS = W_KMAJ ? TC_BK : Cfg::W_ROWS;
      if constexpr (F32) {
        fetch_operand<float, Cfg::G_ROWS, G_KMAJ>(
            lane, g4, Plain<G_COLS / GE>{}, static_cast<const float*>(gsrc),
            gld, g0, s0, glim, p.S);
      } else if constexpr (G_KMAJ) {
        fetch_operand<uint16_t, Cfg::G_ROWS, true>(
            lane, g4, KMajor{}, static_cast<const uint16_t*>(gsrc), gld, g0,
            s0, glim, p.S);
      } else {
        fetch_operand<uint16_t, Cfg::G_ROWS, false>(
            lane, g4, MNMajor{}, static_cast<const uint16_t*>(gsrc), gld, g0,
            s0, glim, p.S);
      }
      fetch_operand<WT, Cfg::W_ROWS, W_KMAJ>(
          lane, w4, Plain<W_COLS / WE>{}, static_cast<const WT*>(wsrc), wld,
          w0, s0, wlim, p.S);
      // The wgmmas read the bf16 real tile through the async proxy.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(full + st);
    }
    return;
  }

  if (tid >= TC_CONSUMERS) {
    // ---- converters: slice i's words (and an f32 real) into buffer i % CB -
    const int t = tid - TC_CONSUMERS;
    const WordDeq dq{p.f.E, p.f.K - 1, tab};
    constexpr int GT16 = Cfg::G_TILE / 16;
    for (int i = 0; i < n; ++i) {
      const int st = i % S, b = i % CB;
      mbar_wait(full + st, (i / S) & 1);
      mbar_wait(cempty + b, ((i / CB) & 1) ^ 1);
      const uint8_t* slot = ring + st * Cfg::SLOT;
      const WT* rw = reinterpret_cast<const WT*>(slot + Cfg::G_SLOT);
      const float* rg = reinterpret_cast<const float*>(slot);
      uint4* cw = reinterpret_cast<uint4*>(conv + b * Cfg::CONV);
      uint4* cg = reinterpret_cast<uint4*>(conv + b * Cfg::CONV + Cfg::W_TILE);
      convert_operand<Cfg::W_ROWS, W_KMAJ, 0>(t, rw, cw, dq);
      if constexpr (F32)
        convert_operand<Cfg::G_ROWS, G_KMAJ, GT16>(t, rg, cg, dq);
      // Generic-proxy stores, read next by the async proxy (wgmma).
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, %0;\n" ::"n"(TC_CONVERTERS) : "memory");
      if (t == 0) {
        mbar_arrive(cfull + b);
        mbar_arrive(empty + st);
      }
    }
    return;
  }

  // ---- consumers: two warpgroups, 64 output rows each ---------------------
  const int wg = tid / 128;
  float acc[TC_BN / 2];
#pragma unroll
  for (int k = 0; k < TC_BN / 2; ++k) acc[k] = 0.f;
  float part[F32 ? TC_BN / 2 : 1];

  // The slice's 4 x NT wgmmas into d (scale 0 on the first: overwrite).
  auto mma = [&](int st, int b, float (&d)[TC_BN / 2], bool overwrite) {
    const uint8_t* cb = conv + b * Cfg::CONV;
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const uint8_t* gt = F32 ? cb + Cfg::W_TILE + t * Cfg::G_TILE
                                : ring + st * Cfg::SLOT;
        const uint8_t* at = A_REAL ? gt : cb;
        const uint8_t* bt = A_REAL ? cb : gt;
        const int scale = (overwrite && kk == 0 && t == 0) ? 0 : 1;
        // This warpgroup's 64 rows of A: 8 KB on in either layout.
        wgmma_n64<A_KMAJ ? 0 : 1, B_KMAJ ? 0 : 1>(
            d, tile_desc<A_KMAJ>(at + wg * 8192, kk),
            tile_desc<B_KMAJ>(bt, kk), scale);
      }
    }
  };
  // Slice j's buffers are free once its wgmmas have ended.
  auto release = [&](int j) {
    if (tid % 128 == 0) {
      mbar_arrive(cempty + j % CB);
      mbar_arrive(empty + j % S);
    }
  };

  for (int i = 0; i < n; ++i) {
    const int st = i % S, b = i % CB;
    mbar_wait(cfull + b, (i / CB) & 1);
    if (!F32) mbar_wait(full + st, (i / S) & 1);  // the TMA'd real tile
    wgmma_fence();
    if constexpr (F32) {
      fence_regs(part);
      mma(st, b, part, true);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int k = 0; k < TC_BN / 2; ++k) acc[k] += part[k];
      release(i);
    } else {  // keep one slice's wgmmas in flight
      fence_regs(acc);
      mma(st, b, acc, false);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
      if (i > 0) release(i - 1);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue.  Accumulator k of a thread: n8 block j = k / 4, row
  // 16 * warp + lane / 4 (+ 8 for k % 4 >= 2), column 8 j + 2 (lane % 4)
  // (+ 1 for odd k), within its warpgroup's 64 rows.
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int rbase = R0 + wg * 64 + warp * 16 + lane / 4;
  const bool split = gridDim.z > 1;
  const long long plane = (long long)p.R * p.C;
#pragma unroll
  for (int k = 0; k < TC_BN / 2; ++k) {
    const int r = rbase + ((k & 2) ? 8 : 0);
    const int c = C0 + (k / 4) * 8 + 2 * (lane % 4) + (k & 1);
    if (r >= p.R || c >= p.C) continue;
    const long long o = (long long)r * p.C + c;
    if (split) {
      p.ws[blockIdx.z * plane + o] = acc[k];
    } else if (p.out_bf16) {
      static_cast<__nv_bfloat16*>(p.out)[o] =
          vp_from_float<__nv_bfloat16>(acc[k]);
    } else {
      static_cast<float*>(p.out)[o] = acc[k];
    }
  }
}

// out = sum over z of ws[z] in z order (the split's deterministic
// reduction), cast to the output type; the body of each library's
// reduction kernel.
__device__ __forceinline__ void splitk_reduce(const float* __restrict__ ws,
                                              void* out, long long n,
                                              int split, int out_bf16) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < n; e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < split; ++z) s += ws[z * n + e];
    if (out_bf16) {
      static_cast<__nv_bfloat16*>(out)[e] = vp_from_float<__nv_bfloat16>(s);
    } else {
      static_cast<float*>(out)[e] = s;
    }
  }
}

// cuTensorMapEncodeTiled, a driver-API call, through the runtime's entry
// point (no link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// TMA map of a row-major (rows, cols) matrix with leading dimension ld
// (elements), copied in boxes of box_rows x box_cols; 128-byte swizzle
// for the bf16 tiles `wgmma` reads, none for raw tiles.
int make_map(CUtensorMap* m, const void* base, CUtensorMapDataType dt,
             int esize, int rows, int cols, int ld, int box_rows,
             int box_cols, bool swz128) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * esize};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(
      m, dt, 2, const_cast<void*>(base), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      swz128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Map of one operand: EXT output elements by TC_BK per box, stored
// K-major (out_lim, S) or MN-major (S, out_lim); the real one swizzled
// when bf16.
template <int EXT, bool KMAJ>
int operand_map(CUtensorMap* m, const void* base, CUtensorMapDataType dt,
                int esize, int out_lim, int S, int ld, bool swz128) {
  return KMAJ ? make_map(m, base, dt, esize, out_lim, S, ld, EXT, TC_BK,
                         swz128)
              : make_map(m, base, dt, esize, S, out_lim, ld, TC_BK, EXT,
                         swz128);
}

template <int ROLE, typename GT, typename WT>
int tc_maps(const TcArgs& p, TcMaps* maps) {
  constexpr bool F32 = std::is_same<GT, float>::value;
  constexpr bool A_REAL = RoleOf<ROLE>::A_REAL;
  constexpr int GS = F32 ? 4 : 2, WS = (int)sizeof(WT);
  const CUtensorMapDataType gdt = F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapDataType wdt = WS == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                          : CU_TENSOR_MAP_DATA_TYPE_UINT16;
  const int err = operand_map<TC_BM, RoleOf<ROLE>::A_KMAJ>(
      &maps->a, p.a, A_REAL ? gdt : wdt, A_REAL ? GS : WS, p.R, p.S, p.lda,
      A_REAL && !F32);
  if (err) return err;
  return operand_map<TC_BN, RoleOf<ROLE>::B_KMAJ>(
      &maps->b, p.b, A_REAL ? wdt : gdt, A_REAL ? WS : GS, p.C, p.S, p.ldb,
      !A_REAL && !F32);
}

using TcKernel = void (*)(const TcArgs, const TcMaps);
using ReduceKernel = void (*)(const float*, void*, long long, int, int);

// Launch `kern` (a __global__ wrapper of tc_body<ROLE, GT, WT>) over the
// output tiles and `split` contraction runs, then, when split > 1,
// `reduce` (one of splitk_reduce) over the partials.
template <int ROLE, typename GT, typename WT>
int tc_launch(TcKernel kern, ReduceKernel reduce, const TcArgs& p, int split,
              cudaStream_t s) {
  constexpr int smem = TcCfg<ROLE, GT, WT>::SMEM;
  static_assert(smem <= TC_SMEM_MAX, "shared memory of one block");
  // Set on every launch: a setting made from one host thread was not seen
  // by launches from another (autograd's backward runs on its own thread).
  const int attr_err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr_err) return attr_err;
  const dim3 grid((p.C + TC_BN - 1) / TC_BN, (p.R + TC_BM - 1) / TC_BM,
                  split);
  if (grid.y > 65535 || split > 65535)
    return (int)cudaErrorInvalidConfiguration;
  TcMaps maps;
  memset(&maps, 0, sizeof(maps));
  if (p.vec) {
    const int merr = tc_maps<ROLE, GT, WT>(p, &maps);
    if (merr) return merr;
  }
  kern<<<grid, TC_THREADS, smem, s>>>(p, maps);
  const int err = (int)cudaGetLastError();
  if (err || split == 1) return err;
  const long long n = (long long)p.R * p.C;
  const long long blocks = n < 4096LL * 256 ? (n + 255) / 256 : 4096LL;
  reduce<<<(unsigned)blocks, 256, 0, s>>>(p.ws, p.out, n, split, p.out_bf16);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr, int ld, int esize) {
  return ((uintptr_t)ptr % 16 == 0) && ((long long)ld * esize % 16 == 0);
}

// The arguments of a launch from the product's (M, K, N) as the wrappers
// name them (dx: g (M, N), w (K, N); dw: a (M, K), g (M, N); fwd: x
// (M, K), w (K, N)); `first` and `second` in that order.  Returns 0, or
// the error for what the planner must not have chosen.
template <int ROLE>
int tc_args(TcArgs* p, const void* first, const void* second, void* out,
            void* ws, int M, int K, int N, int g_dtype, int w_bytes,
            int out_dtype, int split, int kb_per, const VPFmt& f) {
  p->a = first;
  p->b = second;
  p->out = out;
  p->ws = static_cast<float*>(ws);
  p->R = ROLE == TC_DW ? K : M;
  p->C = ROLE == TC_DX ? K : N;
  p->S = ROLE == TC_DX ? N : ROLE == TC_DW ? M : K;
  const int g_bytes = g_dtype == VP_F32 ? 4 : 2;
  const int a_bytes = RoleOf<ROLE>::A_REAL ? g_bytes : w_bytes;
  const int b_bytes = RoleOf<ROLE>::A_REAL ? w_bytes : g_bytes;
  p->lda = ROLE == TC_DX ? N : K;
  p->ldb = N;
  p->kb_per = kb_per;
  p->vec = aligned16(first, p->lda, a_bytes) &&
           aligned16(second, p->ldb, b_bytes);
  p->out_bf16 = out_dtype == VP_BF16;
  p->f = f;
  const int nkb = (p->S + TC_BK - 1) / TC_BK;
  if ((g_dtype != VP_F32 && g_dtype != VP_BF16) ||
      (out_dtype != VP_F32 && out_dtype != VP_BF16) ||
      (w_bytes != 1 && w_bytes != 2) || split < 1 || kb_per < 1 ||
      (long long)split * kb_per < nkb ||
      (split > 1 && ((split - 1) * kb_per >= nkb || ws == nullptr)) ||
      f.K > VP_MAX_K)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace
