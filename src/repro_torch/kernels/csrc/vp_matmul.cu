// VP x VP matmul: (G, M, K) x (G, K, N) -> (G, M, N) f32, each operand
// as packed VP words or as (significand, uint8 index) planes, with
// optional CSPADE tile-activity flags.
//
// Replaces repro/kernels/vp_matmul.py:vp_matmul_batched_pallas and, as
// its G = 1 launch, vp_matmul_pallas (both Pallas launches share
// _vp_matmul_kernel).  Three bodies in vp_common.cuh, and the caller
// names one (kernels/vp_matmul.py:vmm_body picks it): vp_mm_warp_kernel
// and vp_mm_tile_kernel with the dequantizing loader VPLoad on both
// sides, for small products of any layout and for one large product,
// and vp_mm_batch_kernel for many small products in the MIMO engine's
// two layouts, with the loaders VPLoadWords and VPLoadPlanes.  Each
// output's sum runs in the same order in all three, so they agree bit
// for bit; see there for the tilings, the mask semantics and that order.
//
// Bound.  Batched, at the MIMO engine's (16, 64) x (64, 2) per
// realization: bytes.  The kernel reads 1024 W words (2 bytes each), 128
// y words (1 byte) and writes 32 f32 sums for 4096 FLOPs: 2.7 FLOP per
// byte, far below the card's ratio.  The warp body (the first design,
// PERF.md row 9) gives each realization's 16 x 2 output one warp, reads
// each element with a 1- or 2-byte load and converts it by the select
// chain: 11.9-13.6 % of the byte bound.  The batch body gives a product
// one warp of a persistent grid, reads its bytes in 16-byte chunks two
// products ahead of the one it converts, and converts each element in
// O(1) from the block's scale table.  No tensor cores: a 16 x 64 x 2
// product is too small for them to pay.  G = 1, at the masked mode's (2048, 64) x (64, 256):
// f32 operations (67 MFLOP against 0.4 MB), under the launch floor at
// the card's rate, so latency: the load round trip, the conversions and
// the 64-long FMA chains.  There the warp body would stage each A word
// 32 times and each B word 512 times; the tile body stages each A word
// twice (once per cluster pair of 64 x 64 output tiles) and each B word
// 32 times, with 512 threads per block, and runs 16 FMAs per 8
// shared-memory values.  No tensor cores there either: they would sum in
// another order than the warp body.
#include "vp_common.cuh"

// a_m / b_m: significand planes (a_i / b_i: uint8 index planes) or
// packed words (a_i / b_i null), element sizes a_bytes / b_bytes; out:
// f32 (G, M, N); a_act (G, M/bm, K/bk) and b_act (G, K/bk, N/bn) int32
// flags, or both null; body: VP_MM_WARP, VP_MM_TILE or VP_MM_BATCH.  All
// contiguous.  The batch body takes two layouts, int16 words x int8
// words (the MIMO engine's unfused default) and int8 planes x int8
// planes (its CSPADE calls), every plane 16-byte aligned; it refuses
// any other layout or pointer with cudaErrorInvalidValue, as it does a
// shape it does not fit (vp_mm_batch_launch).  Returns the CUDA error.
extern "C" int vp_matmul_launch(const void* a_m, const void* a_i,
                                int a_bytes, const VPFmt* fa,
                                const void* b_m, const void* b_i,
                                int b_bytes, const VPFmt* fb, void* out,
                                const int* a_act, const int* b_act, int G,
                                int M, int K, int N, int bm, int bk, int bn,
                                int body, void* stream) {
  const bool a_ok = a_bytes == 1 || a_bytes == 2 || a_bytes == 4;
  const bool b_ok = b_bytes == 1 || b_bytes == 2 || b_bytes == 4;
  if (!a_ok || !b_ok) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (body == VP_MM_BATCH) {
    const bool words = !a_i && !b_i && a_bytes == 2 && b_bytes == 1;
    const bool planes = a_i && b_i && a_bytes == 1 && b_bytes == 1;
    if (((uintptr_t)a_m | (uintptr_t)a_i | (uintptr_t)b_m |
         (uintptr_t)b_i) % 16)
      return (int)cudaErrorInvalidValue;
    if (words)
      return vp_mm_batch_launch(
          VPLoadWords<int16_t>{(const int16_t*)a_m, *fa},
          VPLoadWords<int8_t>{(const int8_t*)b_m, *fb}, out, a_act, b_act,
          G, M, K, N, bm, bk, bn, 0, 0, 0, 0, st);
    if (planes)
      return vp_mm_batch_launch(
          VPLoadPlanes{(const int8_t*)a_m, (const uint8_t*)a_i, *fa},
          VPLoadPlanes{(const int8_t*)b_m, (const uint8_t*)b_i, *fb}, out,
          a_act, b_act, G, M, K, N, bm, bk, bn, 0, 0, 0, 0, st);
    return (int)cudaErrorInvalidValue;
  }
  const VPLoad la{a_m, (const uint8_t*)a_i, a_bytes, *fa};
  const VPLoad lb{b_m, (const uint8_t*)b_i, b_bytes, *fb};
  return vp_mm_launch(la, lb, out, a_act, b_act, G, M, K, N, bm, bk, bn,
                      body, st);
}
