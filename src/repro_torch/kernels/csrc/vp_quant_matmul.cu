// Fused quantize + VP matmul: float (G, M, K) x float (G, K, N) -> (G, M,
// N) f32, with optional CSPADE tile-activity flags.
//
// Replaces repro/kernels/vp_quant_matmul.py:
// vp_quant_matmul_batched_pallas and, as its G = 1 launch,
// vp_quant_matmul_pallas.  Each float operand element runs the Fig. 3
// cascade (vp_common.cuh:vp_quantize) and is dequantized in registers as
// it is staged, so no quantized plane reaches device memory.  The bodies
// are the two vp_matmul.cu runs (vp_common.cuh: vp_mm_warp_kernel for
// many small products, vp_mm_tile_kernel for one large one) and the
// batch body (vp_mm_batch_kernel, many small products quantized on load),
// named by the caller from kernels/vp_matmul.py:qmm_body, with the
// quantizing loader VPQuantLoad: every output summed in the same order
// over the same exact m * 2^-f values, so the result is bit for bit the
// quantize kernel followed by vp_matmul, and the bodies agree bit for
// bit.
//
// Bound.  Batched: bytes.  Per realization of the batched MVM it reads
// 1024 + 128 f32 operands and writes 32 f32 sums: 4096 FLOPs for 4736
// bytes.  The warp body (PERF.md row 11's first design) ran the select
// chain on each operand element, ~160 integer instructions, 19.6 G per
// launch at G = 100,000: issue-bound at 6.9x the byte bound.  Batched
// launches whose products fit it (kernels/vp_matmul.py:qmm_body) now run
// on the batch body (vp_common.cuh:vp_mm_batch_kernel): one FXP rounding
// and one table load per element, 16-byte loads one product ahead.  G =
// 1, at (2048, 64) x (64, 256): f32 operations, and in practice the
// cascades: the warp body would run 12.6 M of them.  The tile body runs
// 262,144 for W (each element once per cluster pair) and looks the y
// operand's values up in a table of its FXP grid (512 cascades per
// block) after one FXP rounding each.
#include "vp_common.cuh"

// a (G, M, K), b (G, K, N) contiguous f32 with their quantizer formats;
// out, a_act, b_act as in vp_matmul_launch; body: VP_MM_WARP,
// VP_MM_TILE or VP_MM_BATCH.  The batch body only: a_table / b_table,
// the formats' index tables are valid (q->idx_tab); each FXP grid at
// most VP_MB_LUT_MAX values; a and b 16-byte aligned.  Returns the CUDA
// error.
extern "C" int vp_quant_matmul_launch(const void* a, const QuantFmt* qa,
                                      const void* b, const QuantFmt* qb,
                                      void* out, const int* a_act,
                                      const int* b_act, int G, int M, int K,
                                      int N, int bm, int bk, int bn,
                                      int body, int a_table, int b_table,
                                      void* stream) {
  const VPQuantLoad la{(const float*)a, *qa};
  const VPQuantLoad lb{(const float*)b, *qb};
  cudaStream_t st = (cudaStream_t)stream;
  if (body != VP_MM_BATCH)
    return vp_mm_launch(la, lb, out, a_act, b_act, G, M, K, N, bm, bk, bn,
                        body, st);
  if ((uintptr_t)a % 16 || (uintptr_t)b % 16)
    return (int)cudaErrorInvalidValue;
  const double na = (double)qa->raw_hi - qa->raw_lo + 1.0;
  const double nb = (double)qb->raw_hi - qb->raw_lo + 1.0;
  if (na > VP_MB_LUT_MAX || nb > VP_MB_LUT_MAX)
    return (int)cudaErrorInvalidValue;
  return vp_mm_batch_launch(la, lb, out, a_act, b_act, G, M, K, N, bm, bk,
                            bn, (int)na, (int)nb, a_table, b_table, st);
}
