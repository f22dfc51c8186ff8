// Device helpers shared by every VP kernel of the port.
//
// Replaces the in-tile helpers of the JAX package's kernel substrate
// (repro/kernels/substrate.py, part (b)): unpack_cascade, scale_of_index,
// quantize_cascade and quantize_pack_cascade.  Formats are not template
// parameters: they ride each launch as a small struct passed by value,
// so one compiled kernel serves every format with K <= VP_MAX_K.
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

// float -> packed VP word (paper Fig. 3): round half to even onto the
// FXP grid, clip, take the first exponent option whose shifted value
// fits in M signed bits, saturate at the last option, assemble
// (m << E) | i.
__device__ __forceinline__ int vp_quantize_pack(float x, const QuantFmt& q) {
  float r = rintf(x * q.two_f);
  r = fminf(fmaxf(r, q.raw_lo), q.raw_hi);
  const int raw = (int)r;
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
  return (int)(((unsigned)m_sel << q.vp.E) | (unsigned)i_sel);
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

extern "C" const char* vp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
