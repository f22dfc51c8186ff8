"""The redesigned attention kernels' plans and arithmetic on the CPU.

  (a) `plan_decode` / `decode_runs`: the runs of the split decode body
      cover every valid cache position exactly once, in split order, in
      whole warp steps (lengths 0, 1, = smax and past it, windows wider
      than the span, the rolling ring's wrap; KV = 1 and KV = 4), and the
      plan of the serving shape gives >= 128 blocks at batch 4.  The plan
      takes no batch, so a row's bits do not depend on its batch.
  (b) `flash_body` picks the tensor-core body for bf16 with dh a
      multiple of 16 up to 128, the CUDA-core body for f32 or other dh.
  (c) A plain-PyTorch mirror of the split decode body's arithmetic (one
      online softmax per position slot with one exp per position, slots
      merged by scaled sums, then runs in split order) against
      `ref.vp_decode_attention_ref` and the JAX `ops.vp_decode_attention`
      (its oracle and its Pallas body in interpret mode) over 1, 3 and 8
      runs: rtol 1e-5, atol 1e-5 * max|out| (summation order only).
  (d) A mirror of the tensor-core prefill body's arithmetic (q scaled
      and rounded to bf16, f32 scores, online softmax by exp2 over 64-key
      tiles, p rounded to bf16 before PV, l from the f32 p) against
      `ref.flash_prefill_ref` in bf16 and the JAX `ops.flash_prefill`
      (oracle and interpret): within 1e-2 * max|out|, one bf16 rounding
      of the output (2^-8) plus p rounded against a running, not the
      final, row max.
  (e) The q scaling folded into the kernels rounds as the plain path's
      separate multiply: bit for bit on the CPU.

The kernels themselves run only on the card, where `chip_smoke.py`
holds them against the plain versions.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core.packing import dequant_words
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ops import _scale_in
from repro_torch.kernels.vp_attention import (
    DEC_MAX_CLUSTER, DEC_MAX_WARPS, DecodePlan, decode_runs, flash_body,
    flash_prefill_cuda, plan_decode, vp_decode_attention_cuda)
from test_torch_kernels import DECODE_CASES, JVP, TVP, _words, assert_close


# -- (a) the decode split -----------------------------------------------------

def _valid(length, smax, window, rolling):
    """Positions the plain version's mask admits."""
    pos = np.arange(smax)
    if rolling:
        return pos[pos < min(length, smax)]
    ok = pos < length
    if window:
        ok &= pos >= length - window
    return pos[ok]


@pytest.mark.parametrize("KV", [1, 4])
@pytest.mark.parametrize("smax,window,rolling", [
    (160, None, False), (160, 64, False), (160, 400, False),
    (160, 160, True), (24, None, False), (2048, None, False)])
def test_decode_runs_cover_the_span_once(KV, smax, window, rolling):
    plan = plan_decode(KV, smax, 2, 64)
    for length in (0, 1, 2, 5, smax - 1, smax, smax + 1, 2 * smax + 3):
        runs = decode_runs(plan, length, smax, window, rolling)
        assert len(runs) == plan.runs
        covered = [t for lo, hi in runs for t in range(lo, hi)]
        np.testing.assert_array_equal(
            covered, _valid(length, smax, window, rolling))
        full = [hi - lo for lo, hi in runs if hi > lo]
        assert all(n % plan.step == 0 for n in full[:-1])


@pytest.mark.parametrize("shape", [
    (4, 8, 160, 2, 64, 2), (1, 8, 160, 2, 64, 2), (4, 8, 4096, 2, 64, 2),
    (4, 8, 1024, 2, 64, 2), (2, 2, 24, 2, 16, 2), (4, 8, 160, 4, 64, 1),
    (4, 8, 160, 8, 128, 4), (3, 5, 7, 3, 40, 2)], ids=str)
def test_plan_decode_bounds(shape):
    _, KV, smax, G, dh, w_bytes = shape   # the batch does not enter
    plan = plan_decode(KV, smax, G, dh, w_bytes)
    assert 1 <= plan.cluster <= DEC_MAX_CLUSTER
    assert 1 <= plan.warps <= DEC_MAX_WARPS
    assert plan.lpp & (plan.lpp - 1) == 0
    assert plan.lpp * (16 // w_bytes) >= dh
    # no more runs than the buffer fills with two warp steps each, give
    # or take the rounding of warps to the cluster
    assert plan.runs < math.ceil(smax / (2 * plan.step)) + plan.cluster


def test_plan_decode_fills_the_card_at_serving_shapes():
    plan = plan_decode(8, 160, 2, 64)   # prompt 128 + 32 steps
    assert 4 * 8 * plan.cluster >= 128  # batch 4: 256 blocks
    assert plan == DecodePlan(cluster=8, warps=3, lpp=8)


@pytest.mark.parametrize("bad", [
    dict(dh=36), dict(dh=512), dict(G=9), dict(G=8, w_bytes=1),
    dict(w_bytes=3)], ids=str)
def test_plan_decode_refuses_shapes_it_does_not_take(bad):
    args = dict(KV=8, smax=160, G=2, dh=64, w_bytes=2) | bad
    with pytest.raises(ValueError):
        plan_decode(**args)


# -- (b) the prefill body -----------------------------------------------------

@pytest.mark.parametrize("dtype,dh,want", [
    (torch.bfloat16, 64, "tensor_core"), (torch.bfloat16, 128, "tensor_core"),
    (torch.bfloat16, 16, "tensor_core"), (torch.bfloat16, 112, "tensor_core"),
    (torch.float32, 64, "cuda_core"), (torch.float32, 128, "cuda_core"),
    (torch.bfloat16, 40, "cuda_core"), (torch.bfloat16, 144, "cuda_core")],
    ids=str)
def test_flash_body(dtype, dh, want):
    assert flash_body(dtype, dh) == want


def test_wrappers_refuse_cpu_tensors_and_unknown_bodies():
    with pytest.raises(ValueError):
        flash_body(torch.float16, 64)
    q = torch.zeros((1, 4, 2, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 4, 1, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_prefill_cuda(q, k, k, True, None, 0.125)
    w = torch.zeros((1, 4, 1, 64), dtype=torch.int16)
    s = torch.ones((1, 4))
    with pytest.raises(ValueError, match="CUDA"):
        vp_decode_attention_cuda(q[:, :1].reshape(1, 1, 2, 64).float(), w, w,
                                 s, s, torch.ones(1, dtype=torch.int32), TVP,
                                 None, False, 0.125)


# -- (c) mirror of the split decode body ----------------------------------------

def split_decode_mirror(q, k_w, v_w, k_s, v_s, lengths, fmt, window, rolling,
                        plan: DecodePlan):
    """The body's arithmetic in f32: per run, per position slot (t ≡ slot
    mod step within the run) one online softmax with one exp per position;
    the slots merged by the largest max; the runs merged in split order."""
    B, _, H, dh = q.shape
    smax, KV = k_w.shape[1], k_w.shape[2]
    G = H // KV
    qs = q.reshape(B, KV, G, dh).to(torch.float32) * np.float32(dh ** -0.5)
    k = dequant_words(k_w, fmt, torch.float32)
    v = dequant_words(v_w, fmt, torch.float32)
    ks, vs = k_s.reshape(B, smax), v_s.reshape(B, smax)
    neg = torch.full((G,), -1e30)
    out = torch.empty((B, KV, G, dh))
    for b in range(B):
        for h in range(KV):
            parts = []
            for lo, hi in decode_runs(plan, int(lengths[b]), smax, window,
                                      rolling):
                slots = []
                for slot in range(plan.step):
                    m, l, acc = neg.clone(), torch.zeros(G), torch.zeros(G, dh)
                    for t in range(lo + slot, hi, plan.step):
                        s = (qs[b, h] * k[b, t, h]).sum(-1) * ks[b, t]
                        e = torch.exp(-(s - m).abs())
                        up = s > m
                        alpha = torch.where(up, e, 1.0)
                        p = torch.where(up, 1.0, e)
                        m = torch.where(up, s, m)
                        l = l * alpha + p
                        acc = acc * alpha[:, None] + (p * vs[b, t])[:, None] \
                            * v[b, t, h]
                    slots.append((m, l, acc))
                parts.append(_merge(slots))
            m, l, acc = _merge(parts)
            out[b, h] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out.reshape(B, 1, H, dh)


def _merge(parts):
    """(m, l, acc) of several partials: scaled by exp(m_i - max m), summed
    in order (a neutral partial has l = 0, acc = 0)."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    l, acc = 0.0, 0.0
    for mi, li, ai in parts:
        sc = torch.exp(mi - m)
        l = l + li * sc
        acc = acc + ai * sc[:, None]
    return m, l, acc


@pytest.mark.parametrize("runs", [(1, 1), (1, 3), (2, 4)], ids=str)
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_split_decode_mirror_against_references(case, runs):
    c = DECODE_CASES[case]
    B, H, KV, dh, smax = 2, 4, 2, 16, c["smax"]
    rng = np.random.default_rng(len(case))
    q = rng.normal(size=(B, 1, H, dh)).astype(np.float32)
    k_w = _words(rng, (B, smax, KV, dh))
    v_w = _words(rng, (B, smax, KV, dh))
    k_s = (2.0 ** rng.integers(-3, 3, (B, smax, 1, 1))).astype(np.float32)
    v_s = (2.0 ** rng.integers(-3, 3, (B, smax, 1, 1))).astype(np.float32)
    lengths = np.asarray(c["lengths"], np.int32)
    args = (q, k_w, v_w, k_s, v_s, lengths)
    kw = dict(window=c["window"], rolling=c["rolling"])
    # lanes per position from the plan of this head dim, runs forced
    lpp = plan_decode(KV, smax, H // KV, dh).lpp
    plan = DecodePlan(cluster=runs[0], warps=runs[1], lpp=lpp)
    got = split_decode_mirror(*map(torch.from_numpy, args), TVP,
                              plan=plan, **kw).numpy()
    jargs = tuple(map(jnp.asarray, args))
    assert_close(got,
                 tref.vp_decode_attention_ref(
                     *map(torch.from_numpy, args), TVP, **kw).numpy(),
                 jops.vp_decode_attention(*jargs, JVP, **kw),
                 jops.vp_decode_attention(*jargs, JVP, interpret=True, **kw))


# -- (d) mirror of the tensor-core prefill body ---------------------------------

TC_BQ = TC_BK = 64
LOG2E = np.float32(1.4426950408889634)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def tc_prefill_mirror(q, k, v, pattern, window):
    """The body's arithmetic for bf16 q, k, v (B, S, *, dh): per q tile of
    64 rows, key tiles of 64 from the tile's first visible key, f32
    scores, exp2 of log2(e)-scaled scores against the running max, p
    rounded to bf16 for PV, l from the f32 p, out rounded to bf16."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    causal, win = pattern != "full", (window or 0) if pattern == "local" \
        else 0
    qs = _bf16(q.to(torch.float32) * _scale_in(dh, torch.bfloat16))
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    out = torch.empty((B, Sq, H, dh))
    for q0 in range(0, Sq, TC_BQ):
        rows = torch.arange(q0, min(q0 + TC_BQ, Sq))
        q_last = int(rows[-1])
        k_begin, k_end = 0, Sk
        if causal:
            k_end = min(Sk, q_last + 1)
            if win > 0:
                k_begin = max(0, q0 - win + 1)
        for h in range(H):
            qh = qs[:, rows, h]                          # (B, R, dh)
            m = torch.full((B, len(rows)), -1e30)
            l = torch.zeros((B, len(rows)))
            acc = torch.zeros((B, len(rows), dh))
            for k0 in range(k_begin, k_end, TC_BK):
                keys = torch.arange(k0, k0 + TC_BK)
                inb = keys < Sk
                kc = keys.clamp(max=Sk - 1)
                s = torch.einsum("brd,bkd->brk", qh, kf[:, kc, h // G])
                ok = inb[None, :].expand(len(rows), -1).clone()
                if causal:
                    ok &= keys[None, :] <= rows[:, None]
                    if win > 0:
                        ok &= rows[:, None] - keys[None, :] < win
                s = torch.where(ok, s * LOG2E, torch.tensor(-1e30))
                mn = torch.maximum(m, s.amax(-1))
                alpha = torch.exp2(m - mn)
                p = torch.exp2(s - mn[..., None])
                l = l * alpha + p.sum(-1)
                vt = torch.where(inb[:, None], vf[:, kc, h // G], 0.0)
                acc = acc * alpha[..., None] + torch.einsum(
                    "brk,bkd->brd", _bf16(p), vt)
                m = mn
            out[:, rows, h] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(torch.bfloat16)


PREFILL_CASES = {
    "causal": dict(S=100, pattern="causal", window=None),
    "local": dict(S=100, pattern="local", window=24),
    "ragged": dict(S=37, pattern="causal", window=None),
    "full": dict(S=70, pattern="full", window=None),
}


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_tc_prefill_mirror_against_references(case):
    c = PREFILL_CASES[case]
    B, H, KV, dh, S = 2, 4, 2, 16, c["S"]
    rng = np.random.default_rng(S + len(case))
    q, k, v = (rng.normal(size=(B, S, n, dh)).astype(np.float32)
               for n in (H, KV, KV))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    kw = dict(pattern=c["pattern"], window=c["window"])
    got = tc_prefill_mirror(tq, tk, tv, **kw).to(torch.float32).numpy()
    jq, jk, jv = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    wants = [tref.flash_prefill_ref(tq, tk, tv, **kw),
             jops.flash_prefill(jq, jk, jv, **kw),
             jops.flash_prefill(jq, jk, jv, interpret=True, **kw)]
    for want in wants:
        want = (want.to(torch.float32).numpy() if torch.is_tensor(want)
                else np.asarray(want.astype(jnp.float32)))
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


# -- (e) the folded q scaling --------------------------------------------------------

@pytest.mark.parametrize("dh", [16, 40, 64, 128])
def test_folded_scale_rounds_as_the_plain_multiply(dh):
    rng = np.random.default_rng(dh)
    x = torch.from_numpy(rng.normal(0, 3, (4096,)).astype(np.float32))
    qb = x.to(torch.bfloat16)
    # prefill: bf16(f32(q) * f32(bf16(scale))) == q * bf16 tensor(scale)
    want = qb * torch.tensor(dh ** -0.5, dtype=torch.bfloat16)
    got = (qb.to(torch.float32) * _scale_in(dh, torch.bfloat16)).to(
        torch.bfloat16)
    assert torch.equal(got, want)
    want32 = x * torch.tensor(dh ** -0.5, dtype=torch.float32)
    assert torch.equal(x * _scale_in(dh, torch.float32), want32)
    # decode: f32(q) * f32(scale), the scale a python float as ops passes
    f = torch.from_numpy(np.float32([dh ** -0.5]))
    for qd in (x, qb):
        assert torch.equal(qd.to(torch.float32) * dh ** -0.5,
                           qd.to(torch.float32) * f)


def test_cpu_ops_run_the_plain_versions():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, 1, 4, 16)).astype(np.float32))
    w = torch.from_numpy(_words(rng, (2, 8, 2, 16)))
    s = torch.ones((2, 8, 1, 1))
    n = torch.tensor([3, 8], dtype=torch.int32)
    assert torch.equal(tops.vp_decode_attention(q, w, w, s, s, n, TVP),
                       tref.vp_decode_attention_ref(q, w, w, s, s, n, TVP))
    x = torch.from_numpy(rng.normal(size=(2, 8, 4, 16)).astype(np.float32))
    kv = x[:, :, :2].contiguous()
    assert torch.equal(tops.flash_prefill(x, kv, kv),
                       tref.flash_prefill_ref(x, kv, kv))
