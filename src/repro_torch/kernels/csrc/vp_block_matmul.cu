// Block-VP matmul: a (M, K) int8 significands with one exponent index per
// (row, k-tile), b (K, N) int8 with one per (k-tile, col).
//
// Replaces repro/kernels/vp_block_matmul.py:block_vp_matmul_pallas.  As
// there, each k-tile of width bk (the format's index block, taken at run
// time and never split across accumulators) is an integer dot product
// accumulated in int32, and the tile's sum is then scaled into an f32
// accumulator:
//
//     acc_f32 += (float)acc_i32 * 2^-f_a[a_i[row, t]] * 2^-f_b[b_i[t, col]]
//
// for t = 0 .. nk-1 in order.  Every scale is a power of two, so each term
// is exact, the additions round as the plain version's do, and the output
// is bit-identical to ref.block_vp_matmul_ref in f32.  The scales come
// from the format's table by the select chain (vp_scale_of_index).
//
// Bound: at the decode shape (M = batch) the kernel must read every int8
// weight once, so it is bound by bytes (1 byte per weight); at the
// prefill shape (M = 512) by operations (int8, 1,979 TOP/s dense on the
// tensor cores).  Design of this first version: a 64 x 64 output tile per
// block, 32-deep k slices of both operands staged in shared memory as
// int8 with k contiguous, so four k's are one 32-bit word; each thread
// holds a 4 x 4 tile of int32 and f32 accumulators and takes four
// products per __dp4a on the CUDA cores.  No tensor cores yet
// (mma.sync s8 / wgmma, TMA and split-K are later work).  Ragged M, N and
// k-slices are bounds-checked and zero-filled, not padded.
#include "vp_common.cuh"

namespace {

constexpr int BM = 64, BN = 64, KC = 32, TM = 4, TN = 4;
constexpr int TX = BN / TN, TY = BM / TM;  // 16 x 16 threads
constexpr int THREADS = TX * TY;           // 256
constexpr int KW = KC / 4;                 // 32-bit words per staged row
constexpr int KPAD = KC + 4;               // row stride in bytes (odd words)

template <typename OT>
__global__ void __launch_bounds__(THREADS)
block_vp_matmul_kernel(const int8_t* __restrict__ a,
                       const uint8_t* __restrict__ a_i,
                       const int8_t* __restrict__ b,
                       const uint8_t* __restrict__ b_i, OT* __restrict__ out,
                       int M, int K, int N, int bk, VPFmt fa, VPFmt fb) {
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
int launch(const void* a_m, const void* a_i, const void* b_m, const void* b_i,
           void* out, int M, int K, int N, int bk, const VPFmt& fa,
           const VPFmt& fb, cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  block_vp_matmul_kernel<OT><<<grid, THREADS, 0, s>>>(
      (const int8_t*)a_m, (const uint8_t*)a_i, (const int8_t*)b_m,
      (const uint8_t*)b_i, (OT*)out, M, K, N, bk, fa, fb);
  return (int)cudaGetLastError();
}

}  // namespace

// a_m (M, K) int8, a_i (M, K / bk) uint8, b_m (K, N) int8, b_i (K / bk, N)
// uint8, out (M, N) of out_dtype; all contiguous, K a multiple of bk.
// Returns the CUDA error of the launch.
extern "C" int block_vp_matmul_launch(const void* a_m, const void* a_i,
                                      const void* b_m, const void* b_i,
                                      void* out, int M, int K, int N, int bk,
                                      int out_dtype, const VPFmt* fa,
                                      const VPFmt* fb, void* stream) {
  if (bk <= 0 || K % bk) return (int)cudaErrorInvalidValue;
  if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  switch (out_dtype) {
    case VP_F32:
      return launch<float>(a_m, a_i, b_m, b_i, out, M, K, N, bk, *fa, *fb, s);
    case VP_BF16:
      return launch<__nv_bfloat16>(a_m, a_i, b_m, b_i, out, M, K, N, bk, *fa,
                                   *fb, s);
  }
  return (int)cudaErrorInvalidValue;
}
