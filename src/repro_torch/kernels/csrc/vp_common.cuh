// Device helpers shared by every VP kernel of the port.
//
// Replaces the in-tile helpers of the JAX package's kernel substrate
// (repro/kernels/substrate.py, part (b)): unpack_cascade, scale_of_index,
// quantize_cascade, quantize_pack_cascade and quantize_dequant_cascade,
// and the batched matmul body that its VP x VP kernels share
// (vp_mm_kernel below).  Formats are not template parameters: they ride
// each launch as a small struct passed by value, so one compiled kernel
// serves every format with K <= VP_MAX_K.
//
// Built with nvcc for sm_90a and without --use_fast_math: rintf, expf
// and division must round as the plain PyTorch versions do.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define VP_MAX_K 16

// One VP(M, f) format.  Layout mirrors the ctypes structure in
// repro_torch/kernels/build.py: every field is 4 bytes, no padding.
struct VPFmt {
  int E;                   // exponent-index bits
  int K;                   // number of exponent options, 2^E
  int m_lo, m_hi;          // significand range [-2^(M-1), 2^(M-1) - 1]
  float scale[VP_MAX_K];   // 2^-f_k, exact powers of two
};

// An FXP(W, F) grid followed by its VP format (the quantizer's input).
struct QuantFmt {
  VPFmt vp;
  float two_f;             // 2^F
  float raw_lo, raw_hi;    // FXP raw range
  int shift[VP_MAX_K];     // s_k = F - f_k (negative: left shift)
};

// 2^-f_i by a select chain over the format's table (K dependent
// selects, no dynamically indexed parameter memory).
__device__ __forceinline__ float vp_scale_of_index(int i, const VPFmt& f) {
  float s = f.scale[0];
#pragma unroll
  for (int k = 1; k < VP_MAX_K; ++k) {
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

// float -> (significand m, index i) (paper Fig. 3): vp_fxp_raw, then the
// first exponent option whose shifted value fits in M signed bits,
// saturating at the last option.
__device__ __forceinline__ void vp_quantize(float x, const QuantFmt& q,
                                            int& m, int& i) {
  const int raw = vp_fxp_raw(x, q);
  int m_sel = 0, i_sel = 0;
  bool any = false;
  int s_last = q.shift[0];
#pragma unroll
  for (int k = 0; k < VP_MAX_K; ++k) {
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
  if (!any) {
    m_sel = min(max(vp_shift(raw, s_last), q.vp.m_lo), q.vp.m_hi);
    i_sel = q.vp.K - 1;
  }
  m = m_sel;
  i = i_sel;
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

// Size codes shared with the Python wrappers.
enum VPDtype { VP_F32 = 0, VP_BF16 = 1 };

// ---------------------------------------------------------------------------
// Batched VP x VP matmul body, shared by vp_matmul.cu and
// vp_quant_matmul.cu: (G, M, K) x (G, K, N) -> (G, M, N) f32.
//
// One warp computes a tm x tn = 32 tile of one batch element's output,
// one output per lane.  The k axis is walked in chunks of 32: the warp
// stages its A rows (tm x 32) and B columns (32 x tn) in shared memory,
// each element read and converted to its real value once by the
// operand's loader, then every lane runs an f32 FMA chain over the chunk
// in k order.  The loaders are the only difference between the kernels
// (words or planes -> dequant; floats -> quantize -> dequant), and every
// converted value is an exact m * 2^-f, so the fused kernel is bit for
// bit the quantize kernel followed by the plane or word matmul.
//
// CSPADE: with activity flags, the k-range of mask tile kt contributes
// to output (g, m, n) iff a_act[g, m / bm, kt] | b_act[g, kt, n / bn]
// (repro/kernels/ref.py:vp_matmul_batched_ref).  The mask grid (bm, bk,
// bn) is the caller's, not this kernel's tiling; a muted range is
// skipped in the FMA chain, so with every tile loud the sum is the
// unmasked one bit for bit.  Ragged M, N and K are bounds-checked.
// ---------------------------------------------------------------------------

constexpr int VP_MM_WARPS = 4;  // warps per block
constexpr int VP_MM_KC = 32;    // k chunk staged per step
constexpr int VP_MM_APAD = VP_MM_KC + 1;  // A row stride in shared memory
constexpr int VP_MM_BPAD = 9;             // B row stride (tn <= 8)

// Real value of element `idx` of a VP operand stored as packed words
// (i == nullptr) or as a significand plane plus a uint8 index plane.
// `bytes` is the element size of `m` (1, 2 or 4); the branches on it are
// uniform across the warp.
struct VPLoad {
  const void* m;
  const uint8_t* i;
  int bytes;
  VPFmt f;
  __device__ __forceinline__ float operator()(long long idx) const {
    const int v = bytes == 1 ? (int)((const int8_t*)m)[idx]
                : bytes == 2 ? (int)((const int16_t*)m)[idx]
                             : ((const int*)m)[idx];
    if (i == nullptr) return vp_dequant(v, f);
    return (float)v * vp_scale_of_index((int)i[idx], f);
  }
};

// Real value of element `idx` of a float operand after the Fig. 3
// quantizer: the VP-rounded m * 2^-f_i (substrate.quantize_dequant_cascade).
struct VPQuantLoad {
  const float* x;
  QuantFmt q;
  __device__ __forceinline__ float operator()(long long idx) const {
    int m, i;
    vp_quantize(x[idx], q, m, i);
    return (float)m * vp_scale_of_index(i, q.vp);
  }
};

struct VPMMGeom {
  int G, M, K, N;
  int bm, bk, bn;  // CSPADE mask grid
  int tm, tn;      // warp tile, tm * tn = 32
};

template <class LoadA, class LoadB>
__global__ void __launch_bounds__(VP_MM_WARPS * 32)
vp_mm_kernel(LoadA load_a, LoadB load_b, float* __restrict__ out,
             const int* __restrict__ a_act, const int* __restrict__ b_act,
             VPMMGeom g) {
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

// Launch vp_mm_kernel on the warp tiling for this shape: tn = the
// smallest power of two >= N, at most 8; tm = 32 / tn.  Both kernels
// pick the same tiling, so their sums run in the same order.
template <class LoadA, class LoadB>
int vp_mm_launch(const LoadA& load_a, const LoadB& load_b, void* out,
                 const int* a_act, const int* b_act, int G, int M, int K,
                 int N, int bm, int bk, int bn, cudaStream_t stream) {
  VPMMGeom g{G, M, K, N, bm, bk, bn, 0, 0};
  if ((a_act == nullptr) != (b_act == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (a_act && (bm <= 0 || bk <= 0 || bn <= 0 || M % bm || K % bk ||
                N % bn)) {
    return (int)cudaErrorInvalidValue;
  }
  g.tn = 1;
  while (g.tn < N && g.tn < 8) g.tn <<= 1;
  g.tm = 32 / g.tn;
  const long long warps = (long long)G * ((M + g.tm - 1) / g.tm) *
                          ((N + g.tn - 1) / g.tn);
  const long long blocks = (warps + VP_MM_WARPS - 1) / VP_MM_WARPS;
  if (blocks < 1) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  vp_mm_kernel<LoadA, LoadB><<<(unsigned)blocks, VP_MM_WARPS * 32, 0,
                               stream>>>(load_a, load_b, (float*)out, a_act,
                                         b_act, g);
  return (int)cudaGetLastError();
}

extern "C" const char* vp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
