// Block-VP matmul: a (M, K) int8 significands with one exponent index per
// (row, k-tile), b (K, N) int8 with one per (k-tile, col), N contiguous.
//
// Replaces repro/kernels/vp_block_matmul.py:52 block_vp_matmul_pallas.  As
// there, each k-tile of width bk (the format's index block, taken at run
// time and never split across f32 accumulators) is an integer dot product
// summed in int32 (exact, in any order), and the tile's sum is then scaled
// into an f32 accumulator:
//
//     acc_f32 += (float)acc_i32 * 2^-f_a[a_i[row, t]] * 2^-f_b[b_i[t, col]]
//
// for t = 0 .. nk-1 in order.  Every scale is a power of two, so each term
// is exact, the additions round as the plain version's do, and every body
// below is bit-identical to ref.block_vp_matmul_ref in f32.
//
// Bound (chip_smoke.py's `bound`: bytes, each operand read once and the
// output written once, against int8 operations at 1,979 TOP/s): by bytes
// at every main-path shape, decode (M = 4) and prefill (M = 512) alike;
// at (512, 1024, 1024) the 3.7 MB moved take 1.1 us, the 1.07 G int8
// operations 0.54 us.
//
// Four bodies; the wrapper (kernels/vp_block_matmul.py:block_body) picks
// one from (M, K, N, bk) and the operands' alignment before the launch,
// and nothing falls back:
//
// 1. Skinny, for small M (decode and `lm_head`), bk = 256, N % 16 = 0:
//    block_vp_matmul_skinny_kernel.  Byte-bound and, at a few MB per
//    matmul, latency-bound: every weight byte is read once in 16-byte
//    loads along N (a thread owns 16 columns and 4 consecutive k rows of
//    each tile; a tile group of 128 threads 32 columns and the 256 rows
//    of a tile), two tiles' loads in flight before any is used; x's int8
//    rows come as one 32-bit word of 4 k's per row.  A 4 x 4 byte
//    transpose (__byte_perm) turns the 4 rows x 16 columns into __dp4a
//    layout, so each (row, column) takes one __dp4a per 4 k.  The 64 k
//    lanes of a tile are summed in int32 (a reduce-scatter over the
//    warp's 16 lanes by shuffles, then the group's 4 warps through shared
//    memory), and the tile's f32 term formed.  Where the column blocks
//    alone do not fill the SMs (every decode weight but lm_head), the
//    wrapper splits the tiles (never a tile) into runs: up to 4 tile
//    groups of one block, and up to 8 blocks that form one thread-block
//    cluster (w_down: 12 tiles, 3 blocks x 4 groups); each keeps its
//    tiles' terms in shared memory, and after a block or cluster barrier
//    the outputs are summed from the (cluster's) shared memory in tile
//    order.  No workspace, no atomics.  M above 8 runs in chunks of 8
//    rows.
//
// 2. Tensor cores, for large M (prefill), bk = 256, N % 16 = 0:
//    block_vp_matmul_tc_kernel, s8 x s8 -> s32 `wgmma` m64n64k32, 8 per
//    k-tile, into int32 registers that are folded into the f32
//    accumulators with the tile's scales at the end of each tile, in tile
//    order.  `wgmma` takes 8-bit operands K-major only: x (M, K) is, and
//    comes by TMA in its 128-byte swizzle; b (K, N) is N-major, so a
//    converter warpgroup transposes each TMA'd 256 x 64 tile into the
//    K-major swizzled layout by 4 x 4 byte permutes.  A warp-specialized
//    block (vp_tc_mm.cuh's ring, barriers and descriptors): a producer
//    warp, the converters, two consumer warpgroups of 64 rows; a 128 x 64
//    output tile per block.
//
// 3. dp4a, for what neither takes (bk other than 256, N % 16 != 0,
//    unaligned operands): block_vp_matmul_dp4a_kernel, the port's first
//    version.  A 64 x 64 output tile per block, 32-deep k slices of both
//    operands staged in shared memory as int8 with k contiguous (b
//    transposed byte by byte while it is staged), a 4 x 4 tile of int32
//    and f32 accumulators per thread, four products per __dp4a.
//
// 4. int16, for int16 significands (M 9-16) at any bk:
//    block_vp_matmul_i16_kernel, the dp4a body's tiling with int32
//    multiply-adds (below).
//
// Ragged M (and N on the dp4a and int16 bodies) are bounds-checked, not
// padded.
#include <cooperative_groups.h>

#include "vp_tc_mm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 256;  // the k-tile of the skinny and tensor-core bodies

// 4 rows of 4 bytes -> 4 columns of 4 bytes: c[j] byte r = w[r] byte j.
__device__ __forceinline__ void transpose4(uint32_t w0, uint32_t w1,
                                           uint32_t w2, uint32_t w3,
                                           uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
  const uint32_t t1 = __byte_perm(w0, w1, 0x7362);
  const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
  const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ void store_out(void* out, long long o, float v,
                                          int out_bf16) {
  if (out_bf16) {
    static_cast<__nv_bfloat16*>(out)[o] = vp_from_float<__nv_bfloat16>(v);
  } else {
    static_cast<float*>(out)[o] = v;
  }
}

// One round of a reduce-scatter over lanes l and l ^ o: of s[0 .. CUR),
// the lane with bit o set keeps the upper half, the other the lower, each
// summed with its partner's copy, into s[0 .. CUR / 2).
template <int CUR, int N>
__device__ __forceinline__ void halve(int (&s)[N], int lane, int o) {
  const bool up = (lane & o) != 0;
#pragma unroll
  for (int i = 0; i < CUR / 2; ++i) {
    const int give = up ? s[i] : s[i + CUR / 2];
    const int keep = up ? s[i + CUR / 2] : s[i];
    s[i] = keep + __shfl_xor_sync(0xffffffffu, give, o);
  }
}

struct BArgs {
  const int8_t* a;    // (M, K)
  const uint8_t* ai;  // (M, nk)
  const int8_t* b;    // (K, N)
  const uint8_t* bi;  // (nk, N)
  void* out;          // (M, N) of out_bf16 ? bf16 : f32
  int M, K, N, nk;
  int out_bf16;
  VPFmt fa, fb;
};

// ---------------------------------------------------------------------------
// 1. Skinny body
// ---------------------------------------------------------------------------

constexpr int SK_CT = 2;                    // column threads, 16 columns each
constexpr int SK_COLS = SK_CT * 16;         // 32 output columns per block
constexpr int SK_GT = SK_CT * 64;           // a tile group: 64 k lanes x 4 rows
constexpr int SK_GW = SK_GT / 32;           // warps of a tile group
constexpr int SK_MAX_SPLIT = 8;             // the portable cluster size
constexpr int SK_TERMS = 8;                 // tiles of a block that keeps terms

// The rounds of halve over lane bits O, 2 O, .. 16 (the k lanes of a
// warp whose low lane bits are its column threads).
template <int CUR, int O, int N>
__device__ __forceinline__ void scatter(int (&s)[N], int lane) {
  if constexpr (O <= 16) {
    halve<CUR>(s, lane, O);
    scatter<CUR / 2, 2 * O>(s, lane);
  }
}

// Block (x, y, z) of G tile groups: output columns [32 x, 32 x + 32),
// rows [MT y, MT y + MT), tiles [z nk / split, (z + 1) nk / split) of
// split = gridDim.z (the blocks of a column group form one cluster).  The
// split x G runs of whole tiles: group g of block z takes run r = z G +
// g, tiles [r nk / runs, (r + 1) nk / runs).  Thread t of a group:
// column thread ct = t % 2 (columns 16 ct .. 16 ct + 16), k lane L = t /
// 2 (rows 4 L .. 4 L + 4 of each tile); a warp holds 16 k lanes of each
// column thread.  A block of one group with no split adds its tiles'
// terms in registers; otherwise the terms go to shared memory and are
// added in tile order, across the cluster's blocks where split > 1.
template <int MT, int G>
__global__ void __launch_bounds__(G * SK_GT)
block_vp_matmul_skinny_kernel(const BArgs p) {
  constexpr int V = MT * 16;        // int32 sums of a thread: (row, column)
  constexpr int VR = V * SK_CT / 32;  // ... after the warp's reduce-scatter
  constexpr int OUT = MT * SK_COLS; // outputs of a block
  constexpr int EPT = (OUT + SK_GT - 1) / SK_GT;  // ... per group thread
  constexpr int THREADS = G * SK_GT;
  static_assert(VR >= 1, "a value per lane after the reduce-scatter");
  __shared__ int red[G][SK_GW][SK_CT][V];
  __shared__ float terms[SK_TERMS][OUT];
  __shared__ float tab_a[VP_MAX_K], tab_b[VP_MAX_K];

  const int t = threadIdx.x, g = t / SK_GT, tg = t % SK_GT;
  const int lane = t & 31, warp = tg >> 5;
  const int ct = tg % SK_CT, L = tg / SK_CT;
  const int n0 = blockIdx.x * SK_COLS, col = n0 + ct * 16;
  const int m0 = blockIdx.y * MT;
  const int split = gridDim.z, z = blockIdx.z, runs = split * G;
  const int r = z * G + g;
  const int t_lo = r * p.nk / runs, t_hi = (r + 1) * p.nk / runs;
  const int b_lo = z * p.nk / split;  // the block's first tile
  const bool keep = G > 1 || split > 1;
  const bool col_ok = col < p.N;
  if (t < VP_CHAIN_K) {
    tab_a[t] = p.fa.scale[t];
    tab_b[t] = p.fb.scale[t];
  } else if (t < VP_MAX_K) {   // E 5-7: the rest from device memory
    if (t < p.fa.K) tab_a[t] = __ldg(p.fa.wide + t);
    if (t < p.fb.K) tab_b[t] = __ldg(p.fb.wide + t);
  }
  // The group's barrier (named barrier 1 + g, its 4 warps).
  auto group_sync = [&]() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "n"(SK_GT) : "memory");
  };

  // Rows 4 L .. 4 L + 4 of `tile`, this thread's 16 columns of each.
  auto load = [&](uint4 (&w)[4], int tile) {
    const int8_t* src = p.b + ((long long)tile * BK + 4 * L) * p.N + col;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = col_ok ? __ldg(reinterpret_cast<const uint4*>(src +
                                                           (long long)q * p.N))
                    : make_uint4(0, 0, 0, 0);
  };
  float acc[EPT];
#pragma unroll
  for (int h = 0; h < EPT; ++h) acc[h] = 0.f;

  // One tile: int32 sums of this thread's 4 rows, the group's sums, and
  // the terms of the block's outputs (added in, or kept).
  auto step = [&](const uint4 (&w)[4], int tile) {
    int xw[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
      xw[m] = m0 + m < p.M
                  ? __ldg(reinterpret_cast<const int*>(
                        p.a + (long long)(m0 + m) * p.K + tile * BK + 4 * L))
                  : 0;
    float sa[EPT], sb[EPT];
#pragma unroll
    for (int h = 0; h < EPT; ++h) {
      const int e = tg + h * SK_GT;
      const int gm = m0 + e / SK_COLS, gn = n0 + e % SK_COLS;
      sa[h] = e < OUT && gm < p.M ? tab_a[p.ai[(long long)gm * p.nk + tile]]
                                  : 0.f;
      sb[h] = e < OUT && gn < p.N ? tab_b[p.bi[(long long)tile * p.N + gn]]
                                  : 0.f;
    }
    int s[V];
#pragma unroll
    for (int v = 0; v < V; ++v) s[v] = 0;
    const uint32_t u[4][4] = {{w[0].x, w[0].y, w[0].z, w[0].w},
                              {w[1].x, w[1].y, w[1].z, w[1].w},
                              {w[2].x, w[2].y, w[2].z, w[2].w},
                              {w[3].x, w[3].y, w[3].z, w[3].w}};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t c[4];
      transpose4(u[0][q], u[1][q], u[2][q], u[3][q], c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int m = 0; m < MT; ++m)
          s[m * 16 + 4 * q + j] =
              __dp4a(xw[m], (int)c[j], s[m * 16 + 4 * q + j]);
    }
    // Reduce-scatter over the warp's 16 k lanes (lane bits 1 .. 4).
    scatter<V, SK_CT>(s, lane);
    int base = 0;
#pragma unroll
    for (int o = SK_CT, cur = V; o <= 16; o <<= 1, cur >>= 1)
      if (lane & o) base += cur / 2;
#pragma unroll
    for (int j = 0; j < VR; ++j) red[g][warp][ct][base + j] = s[j];
    group_sync();
#pragma unroll
    for (int h = 0; h < EPT; ++h) {
      const int e = tg + h * SK_GT;
      if (e >= OUT) break;
      const int m = e / SK_COLS, c = e % SK_COLS;
      int isum = 0;
#pragma unroll
      for (int wp = 0; wp < SK_GW; ++wp)
        isum += red[g][wp][c / 16][m * 16 + c % 16];
      const float term = __fmul_rn(__fmul_rn((float)isum, sa[h]), sb[h]);
      if (keep) {
        terms[tile - b_lo][e] = term;
      } else {
        acc[h] = __fadd_rn(acc[h], term);
      }
    }
    group_sync();  // red is free for the next tile
  };

  uint4 w0[4], w1[4];
  load(w0, t_lo);
  if (t_lo + 1 < t_hi) load(w1, t_lo + 1);
  __syncthreads();  // the scale tables
  for (int tile = t_lo; tile < t_hi; tile += 2) {
    step(w0, tile);
    if (tile + 2 < t_hi) load(w0, tile + 2);
    if (tile + 1 < t_hi) {
      step(w1, tile + 1);
      if (tile + 3 < t_hi) load(w1, tile + 3);
    }
  }

  if (!keep) {
#pragma unroll
    for (int h = 0; h < EPT; ++h) {
      const int e = t + h * SK_GT;
      const int gm = m0 + e / SK_COLS, gn = n0 + e % SK_COLS;
      if (e < OUT && gm < p.M && gn < p.N)
        store_out(p.out, (long long)gm * p.N + gn, acc[h], p.out_bf16);
    }
    return;
  }
  // The terms in tile order (block zz holds tiles [zz nk / split, (zz +
  // 1) nk / split)); block z sums the outputs e = THREADS z + t (mod
  // THREADS split).
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1) {
    cluster.sync();  // every block's terms are complete
  } else {
    __syncthreads();
  }
  for (int e = z * THREADS + t; e < OUT; e += split * THREADS) {
    float sum = 0.f;
    for (int zz = 0; zz < split; ++zz) {
      const float* rt = split > 1 ? cluster.map_shared_rank(&terms[0][0], zz)
                                  : &terms[0][0];
      const int n = (zz + 1) * p.nk / split - zz * p.nk / split;
      for (int lt = 0; lt < n; ++lt) sum = __fadd_rn(sum, rt[lt * OUT + e]);
    }
    const int gm = m0 + e / SK_COLS, gn = n0 + e % SK_COLS;
    if (gm < p.M && gn < p.N)
      store_out(p.out, (long long)gm * p.N + gn, sum, p.out_bf16);
  }
  if (split > 1) cluster.sync();  // no block leaves while another reads
}

template <int MT, int G>
int sk_launch(const BArgs& p, int split, cudaStream_t s) {
  const dim3 grid((p.N + SK_COLS - 1) / SK_COLS, (p.M + MT - 1) / MT, split);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(G * SK_GT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;  // no cluster where nothing is split
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, block_vp_matmul_skinny_kernel<MT, G>, p);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Eight rows in four tile groups would spill (128 registers a thread at
// 512 threads): that pair is not built.
template <int G>
int sk_mt(const BArgs& p, int mt, int split, cudaStream_t s) {
  switch (mt) {
    case 1: return sk_launch<1, G>(p, split, s);
    case 2: return sk_launch<2, G>(p, split, s);
    case 4: return sk_launch<4, G>(p, split, s);
    case 8:
      if constexpr (G < 4) return sk_launch<8, G>(p, split, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// 2. Tensor-core body
// ---------------------------------------------------------------------------

constexpr int BT_BM = 128;             // output rows: 2 warpgroups x 64
constexpr int BT_BN = 64;              // output columns
constexpr int BT_CONSUMERS = 256;      // two warpgroups: wgmma
constexpr int BT_CONVERTERS = 128;     // one warpgroup: transpose b
constexpr int BT_THREADS = BT_CONSUMERS + BT_CONVERTERS + 32;  // + producer
constexpr int BT_STAGES = 4;           // tiles in flight in the copy ring
constexpr int BT_AH = BT_BM * 128;     // one 128-deep half of x's tile
constexpr int BT_A = 2 * BT_AH;        // x's tile, swizzled (32 KB)
constexpr int BT_BRAW = BK * BT_BN;    // b's tile as stored (16 KB)
constexpr int BT_SLOT = BT_A + BT_BRAW;
constexpr int BT_BH = BT_BN * 128;     // one 128-deep half of b^T's tile
constexpr int BT_CONV = 2 * BT_BH;     // b's tile K-major, swizzled (16 KB)
constexpr int BT_SMEM = 1024 + BT_STAGES * BT_SLOT + 2 * BT_CONV +
                        2 * VP_MAX_K * 4 + (2 * BT_STAGES + 4) * 8;
static_assert(BT_SMEM <= TC_SMEM_MAX, "shared memory of one block");

// Keep the compiler from moving reads or writes of the int32 accumulators
// across the asynchronous `wgmma`s.
__device__ __forceinline__ void fence_iregs(int (&d)[32]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) asm volatile("" : "+r"(d[k])::"memory");
}

// d (64 x 64 int32, this thread's 32) (+)= A (64 x 32 s8) . B (32 x 64
// s8), both K-major in shared memory in the 128-byte swizzle; scale_d = 0
// overwrites d.
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// One 128 x 64 output tile (blockIdx.y, blockIdx.x) over every k-tile.
__global__ void __launch_bounds__(BT_THREADS, 1)
block_vp_matmul_tc_kernel(const BArgs p, const __grid_constant__ TcMaps maps) {
  constexpr int S = BT_STAGES;
  extern __shared__ uint8_t bt_smem[];
  const uint32_t mis = smem_u32(bt_smem) & 1023;  // align to 1024 bytes
  uint8_t* ring = bt_smem + ((1024 - mis) & 1023);
  uint8_t* conv = ring + S * BT_SLOT;
  float* tab_a = reinterpret_cast<float*>(conv + 2 * BT_CONV);
  float* tab_b = tab_a + VP_MAX_K;
  uint64_t* full = reinterpret_cast<uint64_t*>(tab_b + VP_MAX_K);  // [S]
  uint64_t* empty = full + S;                                       // [S]
  uint64_t* cfull = empty + S;                                      // [2]
  uint64_t* cempty = cfull + 2;                                     // [2]

  const int tid = threadIdx.x;
  const int R0 = blockIdx.y * BT_BM, C0 = blockIdx.x * BT_BN;
  const int n = p.nk;

  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < VP_CHAIN_K; ++k) {
      tab_a[k] = p.fa.scale[k];
      tab_b[k] = p.fb.scale[k];
    }
    // E 5-7: the rest from device memory
#pragma unroll 1
    for (int k = VP_CHAIN_K; k < p.fa.K; ++k) tab_a[k] = __ldg(p.fa.wide + k);
#pragma unroll 1
    for (int k = VP_CHAIN_K; k < p.fb.K; ++k) tab_b[k] = __ldg(p.fb.wide + k);
#pragma unroll
    for (int st = 0; st < S; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, 3);  // both consumer warpgroups, converters
    }
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      mbar_init(cfull + b, 1);
      mbar_init(cempty + b, 2);  // both consumer warpgroups
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= BT_CONSUMERS + BT_CONVERTERS) {
    // ---- producer: tile j into ring slot j % S (x in two swizzled
    // halves, b as stored) ---------------------------------------------------
    if (tid % 32 != 0) return;
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&maps.a))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&maps.b))
                 : "memory");
    for (int j = 0; j < n; ++j) {
      const int st = j % S;
      mbar_wait(empty + st, ((j / S) & 1) ^ 1);
      uint8_t* slot = ring + st * BT_SLOT;
      mbar_expect(full + st, BT_SLOT);
      tma_load(slot, &maps.a, j * BK, R0, full + st);
      tma_load(slot + BT_AH, &maps.a, j * BK + 128, R0, full + st);
      tma_load(slot + BT_A, &maps.b, C0, j * BK, full + st);
    }
    return;
  }

  if (tid >= BT_CONSUMERS) {
    // ---- converters: b's tile i, (256 k) x (64 n) bytes as stored ->
    // K-major, 64 rows of n by 256 k in two 128-byte-swizzled halves, into
    // buffer i % 2.  A thread moves blocks of 16 k x 4 n: 16 32-bit words
    // read, four 4 x 4 transposes, four 16-byte stores. ----------------------
    const int c = tid - BT_CONSUMERS;
    for (int i = 0; i < n; ++i) {
      const int st = i % S, b = i % 2;
      mbar_wait(full + st, (i / S) & 1);
      mbar_wait(cempty + b, ((i / 2) & 1) ^ 1);
      const uint32_t* raw =
          reinterpret_cast<const uint32_t*>(ring + st * BT_SLOT + BT_A);
      uint8_t* dst = conv + b * BT_CONV;
#pragma unroll
      for (int h = 0; h < (BK / 16) * (BT_BN / 4) / BT_CONVERTERS; ++h) {
        const int blk = c + h * BT_CONVERTERS;
        const int ng = blk % (BT_BN / 4), kg = blk / (BT_BN / 4);
        uint32_t r[16];
#pragma unroll
        for (int q = 0; q < 16; ++q)
          r[q] = raw[(kg * 16 + q) * (BT_BN / 4) + ng];
        uint32_t col[4][4];  // col[g][j]: k 4 g .. 4 g + 4 of column j
#pragma unroll
        for (int g = 0; g < 4; ++g)
          transpose4(r[4 * g], r[4 * g + 1], r[4 * g + 2], r[4 * g + 3],
                     col[g]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = ng * 4 + j, chunk = (kg & 7) ^ (row & 7);
          *reinterpret_cast<uint4*>(dst + (kg >> 3) * BT_BH + row * 128 +
                                    chunk * 16) =
              make_uint4(col[0][j], col[1][j], col[2][j], col[3][j]);
        }
      }
      // Generic-proxy stores, read next by the async proxy (wgmma).
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, %0;\n" ::"n"(BT_CONVERTERS) : "memory");
      if (c == 0) {
        mbar_arrive(cfull + b);
        mbar_arrive(empty + st);
      }
    }
    return;
  }

  // ---- consumers: two warpgroups, 64 output rows each --------------------
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r_lo = R0 + wg * 64 + warp * 16 + lane / 4, r_hi = r_lo + 8;
  float acc[32];
  int iacc[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    acc[k] = 0.f;
    iacc[k] = 0;
  }
  for (int i = 0; i < n; ++i) {
    const int st = i % S, b = i % 2;
    // This tile's scales of the thread's 2 rows and 16 columns, fetched
    // before the waits.
    const float sa_lo = r_lo < p.M ? tab_a[p.ai[(long long)r_lo * n + i]]
                                   : 0.f;
    const float sa_hi = r_hi < p.M ? tab_a[p.ai[(long long)r_hi * n + i]]
                                   : 0.f;
    float sb[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int cc = C0 + (q / 2) * 8 + 2 * (lane % 4) + (q & 1);
      sb[q] = cc < p.N ? tab_b[p.bi[(long long)i * p.N + cc]] : 0.f;
    }
    mbar_wait(cfull + b, (i / 2) & 1);
    mbar_wait(full + st, (i / S) & 1);
    const uint8_t* at = ring + st * BT_SLOT + wg * 8192;
    const uint8_t* bt = conv + b * BT_CONV;
    wgmma_fence();
    fence_iregs(iacc);
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      const int hk = kk / 4, k4 = kk % 4;  // 32-byte steps in a 128-byte row
      wgmma_s8_n64(iacc, tile_desc<true>(at + hk * BT_AH, k4),
                   tile_desc<true>(bt + hk * BT_BH, k4), kk ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_iregs(iacc);
    if (tid % 128 == 0) {
      mbar_arrive(cempty + b);
      mbar_arrive(empty + st);
    }
    // Accumulator k: row r_lo (+ 8 for k % 4 >= 2), column 8 (k / 4) +
    // 2 (lane % 4) (+ 1 for odd k).
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const float term = __fmul_rn(
          __fmul_rn((float)iacc[k], (k & 2) ? sa_hi : sa_lo),
          sb[(k / 4) * 2 + (k & 1)]);
      acc[k] = __fadd_rn(acc[k], term);
    }
  }

#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int r = (k & 2) ? r_hi : r_lo;
    const int cc = C0 + (k / 4) * 8 + 2 * (lane % 4) + (k & 1);
    if (r < p.M && cc < p.N)
      store_out(p.out, (long long)r * p.N + cc, acc[k], p.out_bf16);
  }
}

int tc_launch_block(const BArgs& p, cudaStream_t s) {
  const auto kern = block_vp_matmul_tc_kernel;
  // Set on every launch: a setting made from one host thread was not seen
  // by launches from another.
  const int attr_err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, BT_SMEM);
  if (attr_err) return attr_err;
  const dim3 grid((p.N + BT_BN - 1) / BT_BN, (p.M + BT_BM - 1) / BT_BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  TcMaps maps;
  memset(&maps, 0, sizeof(maps));
  int err = make_map(&maps.a, p.a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.M,
                     p.K, p.K, BT_BM, 128, true);
  if (err) return err;
  err = make_map(&maps.b, p.b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.K, p.N,
                 p.N, BK, BT_BN, false);
  if (err) return err;
  kern<<<grid, BT_THREADS, BT_SMEM, s>>>(p, maps);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 3. dp4a body
// ---------------------------------------------------------------------------


constexpr int BM = 64, BN = 64, KC = 32, TM = 4, TN = 4;
constexpr int TX = BN / TN, TY = BM / TM;  // 16 x 16 threads
constexpr int THREADS = TX * TY;           // 256
constexpr int KW = KC / 4;                 // 32-bit words per staged row
constexpr int KPAD = KC + 4;               // row stride in bytes (odd words)

template <typename OT>
__global__ void __launch_bounds__(THREADS)
block_vp_matmul_dp4a_kernel(const int8_t* __restrict__ a,
                            const uint8_t* __restrict__ a_i,
                            const int8_t* __restrict__ b,
                            const uint8_t* __restrict__ b_i,
                            OT* __restrict__ out, int M, int K, int N, int bk,
                            VPFmt fa, VPFmt fb) {
  // Both operands with k contiguous: as[row][k], bs[col][k] (b transposed
  // while it is staged), so the dot loop reads four k's per word.
  __shared__ __align__(16) int8_t as[BM][KPAD];
  __shared__ __align__(16) int8_t bs[BN][KPAD];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = K / bk;

  float acc[TM][TN];
  int iacc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = 0.f;
      iacc[i][j] = 0;
    }

  for (int t = 0; t < nk; ++t) {
    const int k_end = (t + 1) * bk;
    for (int k0 = t * bk; k0 < k_end; k0 += KC) {
      const int kc = min(KC, k_end - k0);
      for (int e = tid; e < BM * KC; e += THREADS) {
        const int r = e / KC, c = e % KC;
        const int gm = m0 + r;
        as[r][c] = (gm < M && c < kc) ? a[(long long)gm * K + k0 + c] : 0;
      }
      for (int e = tid; e < KC * BN; e += THREADS) {
        const int r = e / BN, c = e % BN;
        const int gn = n0 + c;
        bs[c][r] = (gn < N && r < kc) ? b[(long long)(k0 + r) * N + gn] : 0;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < KW; ++q) {
        int av[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          av[i] = reinterpret_cast<const int*>(as[ty + i * TY])[q];
#pragma unroll
        for (int j = 0; j < TN; ++j)
          bv[j] = reinterpret_cast<const int*>(bs[tx + j * TX])[q];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            iacc[i][j] = __dp4a(av[i], bv[j], iacc[i][j]);
      }
      __syncthreads();
    }
    // Fold this k-tile into the f32 accumulator with its scales.  The
    // products are exact (powers of two); the add rounds once, as the
    // plain version's does.
    float sa[TM], sb[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + ty + i * TY;
      sa[i] = gm < M ? vp_scale_of_index((int)a_i[(long long)gm * nk + t], fa)
                     : 0.f;
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      sb[j] = gn < N ? vp_scale_of_index((int)b_i[(long long)t * N + gn], fb)
                     : 0.f;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float term =
            __fmul_rn(__fmul_rn((float)iacc[i][j], sa[i]), sb[j]);
        acc[i][j] = __fadd_rn(acc[i][j], term);
        iacc[i][j] = 0;
      }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * TY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn < N) out[(long long)gm * N + gn] = vp_from_float<OT>(acc[i][j]);
    }
  }
}

template <typename OT>
int dp4a_launch(const void* a_m, const void* a_i, const void* b_m,
                const void* b_i, void* out, int M, int K, int N, int bk,
                const VPFmt& fa, const VPFmt& fb, cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  block_vp_matmul_dp4a_kernel<OT><<<grid, THREADS, 0, s>>>(
      (const int8_t*)a_m, (const uint8_t*)a_i, (const int8_t*)b_m,
      (const uint8_t*)b_i, (OT*)out, M, K, N, bk, fa, fb);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// 4. int16 body
// ---------------------------------------------------------------------------

// int16 significands (M 9-16, where require_int_accum_safe admits the
// format at this bk: M 9-12 at bk 256, 9-14 at bk 16): the dp4a body's
// tiling with the staged rows in int16 (34 halves a row: 17 words, odd)
// and two int32 multiply-adds per 32-bit word of each operand.  A
// product needs up to 2M - 1 bits, neither dp4a's nor the s8 wgmma's.
// Each k-tile's int32 sum is folded into the f32 accumulator as on the
// other bodies, so it is bit-identical to ref.block_vp_matmul_ref in f32.
// Bound: operations on the CUDA cores (2 IMAD per 2 products, against
// the 1 dp4a per 4 of the int8 body); a simple right body first.
constexpr int KPAD16 = KC + 2;   // row stride in int16 (odd words)

template <typename OT>
__global__ void __launch_bounds__(THREADS)
block_vp_matmul_i16_kernel(const int16_t* __restrict__ a,
                           const uint8_t* __restrict__ a_i,
                           const int16_t* __restrict__ b,
                           const uint8_t* __restrict__ b_i,
                           OT* __restrict__ out, int M, int K, int N, int bk,
                           VPFmt fa, VPFmt fb) {
  __shared__ __align__(16) int16_t as[BM][KPAD16];
  __shared__ __align__(16) int16_t bs[BN][KPAD16];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = K / bk;

  float acc[TM][TN];
  int iacc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = 0.f;
      iacc[i][j] = 0;
    }

  for (int t = 0; t < nk; ++t) {
    const int k_end = (t + 1) * bk;
    for (int k0 = t * bk; k0 < k_end; k0 += KC) {
      const int kc = min(KC, k_end - k0);
      for (int e = tid; e < BM * KC; e += THREADS) {
        const int r = e / KC, c = e % KC;
        const int gm = m0 + r;
        as[r][c] = (gm < M && c < kc) ? a[(long long)gm * K + k0 + c] : 0;
      }
      for (int e = tid; e < KC * BN; e += THREADS) {
        const int r = e / BN, c = e % BN;
        const int gn = n0 + c;
        bs[c][r] = (gn < N && r < kc) ? b[(long long)(k0 + r) * N + gn] : 0;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < KC / 2; ++q) {
        int av[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          av[i] = reinterpret_cast<const int*>(as[ty + i * TY])[q];
#pragma unroll
        for (int j = 0; j < TN; ++j)
          bv[j] = reinterpret_cast<const int*>(bs[tx + j * TX])[q];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            // low halves sign-extended by the shift pair, high by >> 16
            iacc[i][j] += ((av[i] << 16) >> 16) * ((bv[j] << 16) >> 16);
            iacc[i][j] += (av[i] >> 16) * (bv[j] >> 16);
          }
      }
      __syncthreads();
    }
    float sa[TM], sb[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + ty + i * TY;
      sa[i] = gm < M ? vp_scale_of_index((int)a_i[(long long)gm * nk + t], fa)
                     : 0.f;
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      sb[j] = gn < N ? vp_scale_of_index((int)b_i[(long long)t * N + gn], fb)
                     : 0.f;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float term =
            __fmul_rn(__fmul_rn((float)iacc[i][j], sa[i]), sb[j]);
        acc[i][j] = __fadd_rn(acc[i][j], term);
        iacc[i][j] = 0;
      }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * TY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn < N) out[(long long)gm * N + gn] = vp_from_float<OT>(acc[i][j]);
    }
  }
}

template <typename OT>
int i16_launch(const void* a_m, const void* a_i, const void* b_m,
               const void* b_i, void* out, int M, int K, int N, int bk,
               const VPFmt& fa, const VPFmt& fb, cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  block_vp_matmul_i16_kernel<OT><<<grid, THREADS, 0, s>>>(
      (const int16_t*)a_m, (const uint8_t*)a_i, (const int16_t*)b_m,
      (const uint8_t*)b_i, (OT*)out, M, K, N, bk, fa, fb);
  return (int)cudaGetLastError();
}

int fill_args(BArgs* p, const void* a_m, const void* a_i, const void* b_m,
              const void* b_i, void* out, int M, int K, int N, int out_dtype,
              const VPFmt* fa, const VPFmt* fb) {
  if (out_dtype != VP_F32 && out_dtype != VP_BF16) {
    return (int)cudaErrorInvalidValue;
  }
  if (M < 0 || N < 0 || K <= 0 || K % BK || N % 16 ||
      fa->K > VP_MAX_K || fb->K > VP_MAX_K || !aligned16(b_m, N, 1) ||
      (uintptr_t)a_m % 4)
    return (int)cudaErrorInvalidValue;
  p->a = static_cast<const int8_t*>(a_m);
  p->ai = static_cast<const uint8_t*>(a_i);
  p->b = static_cast<const int8_t*>(b_m);
  p->bi = static_cast<const uint8_t*>(b_i);
  p->out = out;
  p->M = M;
  p->K = K;
  p->N = N;
  p->nk = K / BK;
  p->out_bf16 = out_dtype == VP_BF16;
  p->fa = *fa;
  p->fb = *fb;
  return 0;
}

}  // namespace

// The operands of every body: a_m (M, K) int8, a_i (M, K / bk) uint8,
// b_m (K, N) int8, b_i (K / bk, N) uint8, out (M, N) of out_dtype; all
// contiguous.  Each returns the CUDA error of its launch.

// Skinny body: bk = 256, N % 16 = 0, b_m 16-byte and a_m 4-byte aligned;
// rows in chunks of mt (1, 2, 4 or 8: M <= mt or mt = 8); the k-tiles in
// split x groups runs of whole tiles: `groups` (1, 2 or 4; 4 only for
// mt <= 4) tile groups in each of `split` thread blocks (1 to 8) of one
// cluster; a block that keeps terms (groups > 1 or split > 1) holds at
// most 8 tiles.
extern "C" int block_vp_matmul_skinny_launch(
    const void* a_m, const void* a_i, const void* b_m, const void* b_i,
    void* out, int M, int K, int N, int out_dtype, int mt, int groups,
    int split, const VPFmt* fa, const VPFmt* fb, void* stream) {
  BArgs p;
  const int err = fill_args(&p, a_m, a_i, b_m, b_i, out, M, K, N, out_dtype,
                            fa, fb);
  if (err) return err;
  if (split < 1 || split > SK_MAX_SPLIT || split * groups > p.nk ||
      ((split > 1 || groups > 1) && (p.nk + split - 1) / split > SK_TERMS) ||
      (mt < 8 && mt < M))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (groups) {
    case 1: return sk_mt<1>(p, mt, split, s);
    case 2: return sk_mt<2>(p, mt, split, s);
    case 4: return sk_mt<4>(p, mt, split, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Tensor-core body: bk = 256, N % 16 = 0, a_m and b_m 16-byte aligned.
extern "C" int block_vp_matmul_tc_launch(const void* a_m, const void* a_i,
                                         const void* b_m, const void* b_i,
                                         void* out, int M, int K, int N,
                                         int out_dtype, const VPFmt* fa,
                                         const VPFmt* fb, void* stream) {
  BArgs p;
  const int err = fill_args(&p, a_m, a_i, b_m, b_i, out, M, K, N, out_dtype,
                            fa, fb);
  if (err) return err;
  if (!aligned16(a_m, K, 1)) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  return tc_launch_block(p, (cudaStream_t)stream);
}

// dp4a body: any bk dividing K, any N, any alignment.
extern "C" int block_vp_matmul_dp4a_launch(const void* a_m, const void* a_i,
                                           const void* b_m, const void* b_i,
                                           void* out, int M, int K, int N,
                                           int bk, int out_dtype,
                                           const VPFmt* fa, const VPFmt* fb,
                                           void* stream) {
  if (bk <= 0 || K % bk) return (int)cudaErrorInvalidValue;
  if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidConfiguration;
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (out_dtype) {
    case VP_F32:
      return dp4a_launch<float>(a_m, a_i, b_m, b_i, out, M, K, N, bk, *fa,
                                *fb, s);
    case VP_BF16:
      return dp4a_launch<__nv_bfloat16>(a_m, a_i, b_m, b_i, out, M, K, N, bk,
                                        *fa, *fb, s);
  }
  return (int)cudaErrorInvalidValue;
}

// int16 body: a_m and b_m int16 (M 9-16); any bk dividing K, any N, any
// alignment.
extern "C" int block_vp_matmul_i16_launch(const void* a_m, const void* a_i,
                                          const void* b_m, const void* b_i,
                                          void* out, int M, int K, int N,
                                          int bk, int out_dtype,
                                          const VPFmt* fa, const VPFmt* fb,
                                          void* stream) {
  if (bk <= 0 || K % bk) return (int)cudaErrorInvalidValue;
  if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidConfiguration;
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (out_dtype) {
    case VP_F32:
      return i16_launch<float>(a_m, a_i, b_m, b_i, out, M, K, N, bk, *fa,
                               *fb, s);
    case VP_BF16:
      return i16_launch<__nv_bfloat16>(a_m, a_i, b_m, b_i, out, M, K, N, bk,
                                       *fa, *fb, s);
  }
  return (int)cudaErrorInvalidValue;
}
