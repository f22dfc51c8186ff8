// Fused quantize + VP matmul: float (G, M, K) x float (G, K, N) -> (G, M,
// N) f32, with optional CSPADE tile-activity flags.
//
// Replaces repro/kernels/vp_quant_matmul.py:
// vp_quant_matmul_batched_pallas and, as its G = 1 launch,
// vp_quant_matmul_pallas.  Each float operand element runs the Fig. 3
// cascade (vp_common.cuh:vp_quantize) and is dequantized in registers as
// it is staged, so no quantized plane reaches device memory.  The bodies
// are the two vp_matmul.cu runs (vp_common.cuh: vp_mm_warp_kernel for
// many small products, vp_mm_tile_kernel for one large one, named by
// the caller from kernels/vp_matmul.py:mm_body), with the quantizing
// loader VPQuantLoad: same tiling, same FMA order, same exact m * 2^-f
// values, so on one body the result is bit for bit the quantize kernel
// followed by vp_matmul, and the two bodies agree bit for bit.
//
// Bound.  Batched: bytes.  Per realization of the batched MVM it reads
// 1024 + 128 f32 operands and writes 32 f32 sums: 4096 FLOPs for 4736
// bytes, plus a few dozen integer operations per operand element for
// the cascade, still well below the card's integer rate; the warp body
// gives each realization's 16 x 2 output one warp, each operand element
// read and quantized once per warp.  G = 1, at (2048, 64) x (64, 256):
// f32 operations, and in practice the cascades: the warp body would run
// 12.6 M of them.  The tile body runs 262,144 for W (each element once
// per cluster pair) and looks the y operand's values up in a table of
// its FXP grid (512 cascades per block) after one FXP rounding each.
#include "vp_common.cuh"

// a (G, M, K), b (G, K, N) contiguous f32 with their quantizer formats;
// out, a_act, b_act and body as in vp_matmul_launch.  Returns the CUDA
// error.
extern "C" int vp_quant_matmul_launch(const void* a, const QuantFmt* qa,
                                      const void* b, const QuantFmt* qb,
                                      void* out, const int* a_act,
                                      const int* b_act, int G, int M, int K,
                                      int N, int bm, int bk, int bn,
                                      int body, void* stream) {
  const VPQuantLoad la{(const float*)a, *qa};
  const VPQuantLoad lb{(const float*)b, *qb};
  return vp_mm_launch(la, lb, out, a_act, b_act, G, M, K, N, bm, bk, bn,
                      body, (cudaStream_t)stream);
}
