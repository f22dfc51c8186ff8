// Attention kernels of the serving path: decode over a packed VP KV cache,
// and flash prefill.
//
// vp_decode_attention_kernel replaces
// repro/kernels/vp_attention.py:vp_decode_attention_pallas.
//   One block per (batch, kv head) holds all G query rows of the group.
//   The loop runs only over the valid span [lo, hi) (length, sliding
//   window, or the rolling ring clamped to the real buffer length), in
//   tiles of DEC_T positions, so every position it touches is valid and
//   no mask is needed.  K/V words are dequantized to f32 in shared
//   memory; the per-position pow2 scales multiply the score columns (k_s)
//   and the probability columns (v_s), as in the TPU kernel.  Online
//   softmax in f32; the output is acc / max(l, 1e-30).
//   Bound: bytes (each valid cache word read once: 2 bytes per element,
//   ~4 FLOPs per element at G = 2).  With B * KV blocks (32 at batch 4)
//   the card is mostly idle at short caches; a split over positions is
//   later work.
//
// flash_prefill_kernel replaces
// repro/kernels/vp_attention.py:flash_prefill_pallas.
//   One block per (q tile of FQ rows, head, batch); kv head = h / G.
//   k tiles above the causal diagonal or wholly before the local window
//   are skipped by the loop bounds; inside a tile, keys past sk and the
//   causal/local masks are applied.  As in the TPU kernel the
//   probabilities are cast to v's dtype before the PV product (a bf16
//   rounding at bf16).  Inputs stay in the model's layout (B, S, H, dh),
//   so no transpose or padding copy is made.
//   Bound: operations at long prompts, bytes at short ones; this first
//   version uses CUDA-core FMAs from shared memory (no tensor cores).
#include "vp_common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// Decode
// ---------------------------------------------------------------------------

constexpr int DEC_T = 64;
constexpr int DEC_THREADS = 128;

template <typename WT>
__global__ void __launch_bounds__(DEC_THREADS)
vp_decode_attention_kernel(const float* __restrict__ q,
                           const WT* __restrict__ kw,
                           const WT* __restrict__ vw,
                           const float* __restrict__ ks,
                           const float* __restrict__ vs,
                           const int* __restrict__ lengths,
                           float* __restrict__ out, int KV, int G, int dh,
                           int smax, int window, int rolling, VPFmt f) {
  extern __shared__ float sm[];
  float* qs = sm;                   // (G, dh) pre-scaled queries
  float* kt = qs + G * dh;          // (DEC_T, dh + 1) dequantized keys
  float* vt = kt + DEC_T * (dh + 1);  // (DEC_T, dh) dequantized values
  float* st = vt + DEC_T * dh;      // (G, DEC_T) scores, then probabilities
  float* acc = st + G * DEC_T;      // (G, dh)
  float* mrow = acc + G * dh;       // (G) running max
  float* lrow = mrow + G;           // (G) running denominator
  float* arow = lrow + G;           // (G) this tile's correction

  const int b = blockIdx.x / KV, h = blockIdx.x % KV;
  const int tid = threadIdx.x;
  const long long qbase = ((long long)b * KV + h) * G * dh;
  for (int e = tid; e < G * dh; e += DEC_THREADS) {
    qs[e] = q[qbase + e];
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += DEC_THREADS) {
    mrow[g] = NEG_INF;
    lrow[g] = 0.f;
  }

  const int len = lengths[b];
  int lo = 0, hi = len;
  if (rolling) {
    hi = min(len, smax);
  } else if (window > 0) {
    lo = max(len - window, 0);
  }
  hi = min(hi, smax);
  __syncthreads();

  for (int t0 = lo; t0 < hi; t0 += DEC_T) {
    const int nt = min(DEC_T, hi - t0);
    for (int e = tid; e < nt * dh; e += DEC_THREADS) {
      const int t = e / dh, d = e % dh;
      const long long idx = (((long long)b * smax + t0 + t) * KV + h) * dh + d;
      kt[t * (dh + 1) + d] = vp_dequant((int)kw[idx], f);
      vt[t * dh + d] = vp_dequant((int)vw[idx], f);
    }
    __syncthreads();
    for (int e = tid; e < G * nt; e += DEC_THREADS) {
      const int g = e / nt, t = e % nt;
      float s = 0.f;
      for (int d = 0; d < dh; ++d)
        s = fmaf(qs[g * dh + d], kt[t * (dh + 1) + d], s);
      st[g * DEC_T + t] = s * ks[(long long)b * smax + t0 + t];
    }
    __syncthreads();
    for (int g = tid; g < G; g += DEC_THREADS) {
      float* row = st + g * DEC_T;
      float mc = NEG_INF;
      for (int t = 0; t < nt; ++t) mc = fmaxf(mc, row[t]);
      const float mp = mrow[g];
      const float mn = fmaxf(mp, mc);
      const float alpha = expf(mp - mn);
      float sum = 0.f;
      for (int t = 0; t < nt; ++t) {
        const float p = expf(row[t] - mn);
        sum += p;
        row[t] = p * vs[(long long)b * smax + t0 + t];
      }
      lrow[g] = alpha * lrow[g] + sum;
      mrow[g] = mn;
      arow[g] = alpha;
    }
    __syncthreads();
    for (int e = tid; e < G * dh; e += DEC_THREADS) {
      const int g = e / dh, d = e % dh;
      float pv = 0.f;
      for (int t = 0; t < nt; ++t)
        pv = fmaf(st[g * DEC_T + t], vt[t * dh + d], pv);
      acc[e] = acc[e] * arow[g] + pv;
    }
    __syncthreads();
  }

  for (int e = tid; e < G * dh; e += DEC_THREADS) {
    out[qbase + e] = acc[e] / fmaxf(lrow[e / dh], 1e-30f);
  }
}

template <typename WT>
int launch_decode(const void* q, const void* kw, const void* vw,
                  const void* ks, const void* vs, const void* lengths,
                  void* out, int B, int KV, int G, int dh, int smax,
                  int window, int rolling, const VPFmt& f, cudaStream_t s) {
  const size_t smem = sizeof(float) *
      (size_t)(2 * G * dh + DEC_T * (dh + 1) + DEC_T * dh + G * DEC_T + 3 * G);
  auto kern = vp_decode_attention_kernel<WT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<B * KV, DEC_THREADS, smem, s>>>(
      (const float*)q, (const WT*)kw, (const WT*)vw, (const float*)ks,
      (const float*)vs, (const int*)lengths, (float*)out, KV, G, dh, smax,
      window, rolling, f);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Prefill
// ---------------------------------------------------------------------------

constexpr int FQ = 64, FK = 64;
constexpr int FL_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(FL_THREADS)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int Sq,
                     int Sk, int H, int KV, int dh, int causal, int window) {
  extern __shared__ float sm[];
  const int ldk = dh + 1;              // pad: score reads walk kt rows
  float* qs = sm;                      // (FQ, dh)
  float* kt = qs + FQ * dh;            // (FK, dh + 1)
  float* vt = kt + FK * ldk;           // (FK, dh)
  float* st = vt + FK * dh;            // (FQ, FK) scores, then probabilities
  float* acc = st + FQ * FK;           // (FQ, dh)
  float* mrow = acc + FQ * dh;         // (FQ)
  float* lrow = mrow + FQ;             // (FQ)
  float* arow = lrow + FQ;             // (FQ)

  const int q0 = blockIdx.x * FQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;

  for (int e = tid; e < FQ * dh; e += FL_THREADS) {
    const int r = e / dh, d = e % dh;
    const int qp = q0 + r;
    qs[e] = qp < Sq ? vp_to_float(q[(((long long)b * Sq + qp) * H + h) * dh + d])
                    : 0.f;
    acc[e] = 0.f;
  }
  for (int r = tid; r < FQ; r += FL_THREADS) {
    mrow[r] = NEG_INF;
    lrow[r] = 0.f;
  }

  // Keys any row of this tile can see.
  const int q_last = min(q0 + FQ, Sq) - 1;
  int k_begin = 0, k_end = Sk;
  if (causal) {
    k_end = min(Sk, q_last + 1);
    if (window > 0) k_begin = max(0, q0 - window + 1);
  }
  __syncthreads();

  for (int k0 = k_begin; k0 < k_end; k0 += FK) {
    const int nk = min(FK, k_end - k0);
    for (int e = tid; e < nk * dh; e += FL_THREADS) {
      const int c = e / dh, d = e % dh;
      const long long idx = (((long long)b * Sk + k0 + c) * KV + kvh) * dh + d;
      kt[c * ldk + d] = vp_to_float(k[idx]);
      vt[c * dh + d] = vp_to_float(v[idx]);
    }
    __syncthreads();
    for (int e = tid; e < FQ * nk; e += FL_THREADS) {
      const int r = e / nk, c = e % nk;
      const int qp = q0 + r, kp = k0 + c;
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(qs[r * dh + d], kt[c * ldk + d], s);
      bool valid = true;
      if (causal) {
        valid = kp <= qp;
        if (window > 0) valid = valid && (qp - kp < window);
      }
      st[r * FK + c] = valid ? s : NEG_INF;
    }
    __syncthreads();
    for (int r = tid; r < FQ; r += FL_THREADS) {
      float* row = st + r * FK;
      float mc = NEG_INF;
      for (int c = 0; c < nk; ++c) mc = fmaxf(mc, row[c]);
      const float mp = mrow[r];
      const float mn = fmaxf(mp, mc);
      const float alpha = expf(mp - mn);
      float sum = 0.f;
      for (int c = 0; c < nk; ++c) {
        const float p = expf(row[c] - mn);
        sum += p;
        row[c] = vp_to_float(vp_from_float<T>(p));  // p.astype(v.dtype)
      }
      lrow[r] = alpha * lrow[r] + sum;
      mrow[r] = mn;
      arow[r] = alpha;
    }
    __syncthreads();
    for (int e = tid; e < FQ * dh; e += FL_THREADS) {
      const int r = e / dh, d = e % dh;
      float pv = 0.f;
      for (int c = 0; c < nk; ++c) pv = fmaf(st[r * FK + c], vt[c * dh + d], pv);
      acc[e] = acc[e] * arow[r] + pv;
    }
    __syncthreads();
  }

  for (int e = tid; e < FQ * dh; e += FL_THREADS) {
    const int r = e / dh, d = e % dh;
    const int qp = q0 + r;
    if (qp < Sq) {
      out[(((long long)b * Sq + qp) * H + h) * dh + d] =
          vp_from_float<T>(acc[e] / fmaxf(lrow[r], 1e-30f));
    }
  }
}

template <typename T>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 int B, int Sq, int Sk, int H, int KV, int dh, int causal,
                 int window, cudaStream_t s) {
  const size_t smem = sizeof(float) *
      (size_t)(FQ * dh + FK * (dh + 1) + FK * dh + FQ * FK + FQ * dh + 3 * FQ);
  auto kern = flash_prefill_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Sq + FQ - 1) / FQ, H, B);
  kern<<<grid, FL_THREADS, smem, s>>>((const T*)q, (const T*)k, (const T*)v,
                                      (T*)out, Sq, Sk, H, KV, dh, causal,
                                      window);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, KV, G, dh) f32 pre-scaled; k_w / v_w (B, smax, KV, dh) packed
// words of w_bytes; k_s / v_s (B, smax) f32; lengths (B,) int32;
// out (B, KV, G, dh) f32.  window <= 0 means no window.
extern "C" int vp_decode_attention_launch(
    const void* q, const void* kw, const void* vw, const void* ks,
    const void* vs, const void* lengths, void* out, int B, int KV, int G,
    int dh, int smax, int window, int rolling, int w_bytes, const VPFmt* f,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (w_bytes) {
    case 1:
      return launch_decode<int8_t>(q, kw, vw, ks, vs, lengths, out, B, KV, G,
                                   dh, smax, window, rolling, *f, s);
    case 2:
      return launch_decode<int16_t>(q, kw, vw, ks, vs, lengths, out, B, KV, G,
                                    dh, smax, window, rolling, *f, s);
    case 4:
      return launch_decode<int32_t>(q, kw, vw, ks, vs, lengths, out, B, KV, G,
                                    dh, smax, window, rolling, *f, s);
  }
  return (int)cudaErrorInvalidValue;
}

// q (B, Sq, H, dh) pre-scaled, k / v (B, Sk, KV, dh), out (B, Sq, H, dh),
// all of `dtype`.  causal = 0 is the full pattern; window <= 0 means none.
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* out, int B, int Sq,
                                    int Sk, int H, int KV, int dh, int causal,
                                    int window, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case VP_F32:
      return launch_flash<float>(q, k, v, out, B, Sq, Sk, H, KV, dh, causal,
                                 window, s);
    case VP_BF16:
      return launch_flash<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KV, dh,
                                         causal, window, s);
  }
  return (int)cudaErrorInvalidValue;
}
