"""Chaos suite on the port's engine: the host-side resilience cases of
tests/test_chaos.py (tiny config, virtual clock, CPU).

For every fault class of `repro_torch.serving.faults`: the engine never
crashes, every request reaches a terminal outcome, UNAFFECTED requests
keep the fault-free run's tokens bit for bit, the page free list is
conserved and the dummy page 0 is never handed out or corrupted, and
deadlines keep being enforced.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.kernels import paged
from repro_torch.models.model import init_params, quantize_params
from repro_torch.serving import (
    SLO_CLASSES, FaultPlan, KVBitFlip, LogitPoison, PagePressure,
    ServingEngine, SlowStep, TransientFault, VirtualClock,
)

REQS = [([1, 2, 3, 4, 5], 4, 0.0),
        (list(range(7)), 5, 0.0),
        ([9, 8, 7], 3, 0.05)]
CAP, PAGE, SLOTS = 24, 8, 2
KV_LAYOUTS = ["float", "packed", "planes"]
OUTCOMES = {"ok", "retried", "quarantined", "degraded", "timeout", "shed"}

_PARAMS = {}


def _cfg(kv: str = "packed") -> ModelConfig:
    q = (QuantConfig(mode="vp") if kv == "float" else
         QuantConfig(mode="vp", quantize_kv_cache=True, kv_layout=kv))
    return ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
                       dtype="float32", quant=q)


def _params(cfg):
    key = cfg.quant.kv_layout if cfg.quant.quantize_kv_cache else "float"
    if key not in _PARAMS:
        _PARAMS[key] = quantize_params(
            init_params(cfg, seed=0, device="cpu"), cfg)
    return _PARAMS[key]


def _engine(params, cfg, **kw):
    kw.setdefault("max_slots", SLOTS)
    kw.setdefault("capacity", CAP)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("clock", VirtualClock())
    return ServingEngine(params, cfg, **kw)


def _submit_all(eng, reqs=REQS, **kw):
    for prompt, gen, at in reqs:
        eng.submit(prompt, gen, at, **kw)


_BASE = {}


def _baseline_tokens(params, cfg):
    """Fault-free engine run: the bit-exactness reference."""
    key = id(params)
    if key not in _BASE:
        eng = _engine(params, cfg)
        _submit_all(eng)
        _BASE[key] = {r["rid"]: r["tokens"] for r in eng.run()}
    return _BASE[key]


def _check_invariants(eng):
    """Free-list conservation and page 0 still reserved, after any run."""
    eng.kv.check_conservation()
    assert not eng.kv.slot_pages
    assert len(eng.kv.free_pages) == eng.kv.n_pages - 1
    assert 0 not in eng.kv.free_pages


def _run(eng):
    _submit_all(eng)
    return {r["rid"]: r for r in eng.run()}


# ---------------------------------------------------------------------------
# flip_bit: exactly one bit of one word, never page 0


@pytest.mark.parametrize("dtype,bit", [(torch.int16, 4), (torch.int8, 7),
                                       (torch.float32, 31),
                                       (torch.bfloat16, 3)])
def test_flip_bit_touches_exactly_one_word(dtype, bit):
    gen = torch.Generator().manual_seed(0)
    pool = (torch.randn((2, 5, 4, 3), generator=gen) * 100).to(dtype)
    before = pool.clone()
    out = paged.flip_bit(pool, page=3, offset=2, bit=bit)
    assert out is pool                                  # in place
    width = {1: torch.int8, 2: torch.int16, 4: torch.int32}[
        pool.element_size()]
    diff = (before.view(width) != pool.view(width)).nonzero().tolist()
    assert diff == [[0, 3, 2, 0]]
    xor = (int(before.view(width)[0, 3, 2, 0])
           ^ int(pool.view(width)[0, 3, 2, 0]))
    assert xor & ((1 << pool.element_size() * 8) - 1) == 1 << bit
    paged.flip_bit(pool, 3, 2, bit)                     # an involution
    assert torch.equal(before.view(width), pool.view(width))


# ---------------------------------------------------------------------------
# logit poisoning -> per-slot quarantine, retry, degrade


@pytest.mark.parametrize("value", [math.nan, math.inf])
def test_logit_poison_quarantines_only_victim(value):
    cfg = _cfg()
    params = _params(cfg)
    base = _baseline_tokens(params, cfg)
    eng = _engine(params, cfg, check_finite=True, faults=FaultPlan(
        [LogitPoison(rid=1, phase="decode", value=value)]))
    recs = _run(eng)
    assert recs[1]["outcome"] == "quarantined" and recs[1]["tokens"] == []
    for rid in (0, 2):
        assert recs[rid]["outcome"] == "ok"
        assert recs[rid]["tokens"] == base[rid]
    assert eng.stats["quarantined"] == 1
    assert eng.stats["fault_logit_poisons"] >= 1
    _check_invariants(eng)


def test_logit_poison_prefill_phase_and_raise_mode():
    cfg = _cfg()
    params = _params(cfg)
    eng = _engine(params, cfg, check_finite=True,
                  faults=FaultPlan([LogitPoison(rid=0, phase="prefill")]))
    recs = _run(eng)
    assert recs[0]["outcome"] == "quarantined"
    assert recs[1]["outcome"] == recs[2]["outcome"] == "ok"
    _check_invariants(eng)
    # on_nonfinite="raise": the same kind of poison stops the engine.
    eng = _engine(params, cfg, check_finite=True, on_nonfinite="raise",
                  faults=FaultPlan([LogitPoison(rid=1)]))
    _submit_all(eng)
    with pytest.raises(FloatingPointError):
        eng.run()


@pytest.mark.parametrize("times,outcome", [(1, "ok"), (1_000_000,
                                                        "degraded")])
def test_quarantine_retry_or_degrade(times, outcome):
    """Poisoned once, the request is requeued and re-runs clean; poisoned
    every pass, it lands on the static oracle path, flagged degraded.
    Either way its tokens are the fault-free run's."""
    cfg = _cfg()
    params = _params(cfg)
    base = _baseline_tokens(params, cfg)
    eng = _engine(params, cfg, check_finite=True, degrade=True,
                  degrade_after=2,
                  faults=FaultPlan([LogitPoison(rid=0, times=times)]))
    recs = _run(eng)
    assert recs[0]["outcome"] == outcome
    assert recs[1]["outcome"] == recs[2]["outcome"] == "ok"
    for rid in (0, 1, 2):
        assert recs[rid]["tokens"] == base[rid]
    assert eng.stats["quarantine_requeues"] == 1
    assert eng.stats["degraded"] == (outcome == "degraded")
    _check_invariants(eng)


# ---------------------------------------------------------------------------
# KV bit flips: silent corruption stays inside the victim's pages


@pytest.mark.parametrize("kv", KV_LAYOUTS)
def test_kv_bitflip_isolated_to_victim(kv):
    cfg = _cfg(kv)
    params = _params(cfg)
    base = _baseline_tokens(params, cfg)
    eng = _engine(params, cfg, check_finite=True, faults=FaultPlan(
        [KVBitFlip(rid=0, page_index=0, offset=1, bit=3)]))
    fp0 = eng.kv.page0_fingerprint()
    recs = _run(eng)
    assert eng.stats["fault_kv_bit_flips"] == 1
    assert recs[0]["outcome"] in OUTCOMES
    assert len(recs[0]["tokens"]) <= REQS[0][1]
    for rid in (1, 2):
        assert recs[rid]["outcome"] == "ok"
        assert recs[rid]["tokens"] == base[rid]
    assert eng.kv.page0_fingerprint() == fp0
    _check_invariants(eng)


# ---------------------------------------------------------------------------
# page pressure, transient failures


def test_page_pressure_delays_then_completes():
    cfg = _cfg()
    params = _params(cfg)
    base = _baseline_tokens(params, cfg)
    eng = _engine(params, cfg, faults=FaultPlan(
        [PagePressure(at=0.0, release=0.25, pages=10_000)]))
    recs = _run(eng)
    assert eng.stats["fault_page_spikes"] == 1
    for rid in (0, 1, 2):
        assert recs[rid]["outcome"] == "ok"
        assert recs[rid]["admitted_time"] >= 0.25
        assert recs[rid]["tokens"] == base[rid]
    _check_invariants(eng)


def test_page_pressure_with_bounded_queue_sheds():
    cfg = _cfg()
    eng = _engine(_params(cfg), cfg, max_queue=1, faults=FaultPlan(
        [PagePressure(at=0.0, release=0.25, pages=10_000)]))
    outcomes = sorted(r["outcome"] for r in _run(eng).values())
    assert outcomes.count("shed") == 1 and eng.stats["shed"] == 1
    assert all(o in OUTCOMES for o in outcomes)
    _check_invariants(eng)


def test_transient_decode_step_retries():
    cfg = _cfg()
    params = _params(cfg)
    base = _baseline_tokens(params, cfg)
    eng = _engine(params, cfg, faults=FaultPlan(
        [TransientFault(kind="decode", times=2)]))
    recs = _run(eng)
    assert eng.stats["transient_faults"] == 2
    for rid in (0, 1, 2):
        assert recs[rid]["outcome"] in ("ok", "retried")
        assert recs[rid]["tokens"] == base[rid]
    assert any(r["outcome"] == "retried" for r in recs.values())
    _check_invariants(eng)


def test_transient_prefill_exhaustion_quarantines():
    cfg = _cfg()
    params = _params(cfg)
    base = _baseline_tokens(params, cfg)
    eng = _engine(params, cfg, max_retries=1, faults=FaultPlan(
        [TransientFault(kind="prefill", rid=0, times=100)]))
    recs = _run(eng)
    assert recs[0]["outcome"] == "quarantined"
    for rid in (1, 2):
        assert recs[rid]["outcome"] == "ok"
        assert recs[rid]["tokens"] == base[rid]
    _check_invariants(eng)


# ---------------------------------------------------------------------------
# slow steps, deadlines, EDF, preemption, shedding


def test_slow_step_forces_timeout_under_slo():
    cfg = _cfg()
    eng = _engine(_params(cfg), cfg, faults=FaultPlan(
        [SlowStep(at=0.0, extra_s=30.0)]))
    _submit_all(eng, slo=SLO_CLASSES["interactive"])
    recs = {r["rid"]: r for r in eng.run()}
    assert eng.stats["fault_slow_steps"] == 1
    assert all(r["outcome"] == "timeout" for r in recs.values())
    assert all(not r["slo_met"] for r in recs.values())
    _check_invariants(eng)


def test_deadline_timeout_waiting():
    cfg = _cfg()
    eng = _engine(_params(cfg), cfg, max_slots=1)
    eng.submit(REQS[0][0], 4, 0.0)
    eng.submit(REQS[1][0], 5, 0.0, deadline=1e-9)       # expires waiting
    recs = {r["rid"]: r for r in eng.run()}
    assert recs[0]["outcome"] == "ok"
    assert recs[1]["outcome"] == "timeout" and recs[1]["tokens"] == []
    assert recs[1]["deadline_met"] is False
    _check_invariants(eng)


def test_edf_admits_tightest_deadline_first():
    cfg = _cfg()
    eng = _engine(_params(cfg), cfg, max_slots=1, policy="edf")
    eng.submit(REQS[0][0], 4, 0.0, deadline=1e9)
    eng.submit(REQS[1][0], 5, 0.0, deadline=1e6)
    recs = {r["rid"]: r for r in eng.run()}
    assert recs[0]["outcome"] == recs[1]["outcome"] == "ok"
    assert recs[1]["first_token_time"] < recs[0]["first_token_time"]


def test_preemption_resume_is_bit_exact():
    """A tight-deadline arrival evicts the running request; the victim
    re-prefills prompt + generated on re-admission and ends with the
    tokens of an uncontended run."""
    cfg = _cfg()
    params = _params(cfg)
    solo = {}
    for prompt, gen, _ in REQS[:2]:
        eng = _engine(params, cfg, max_slots=1)
        eng.submit(prompt, gen, 0.0)
        solo[prompt[0]] = eng.run()[0]["tokens"]
    eng = _engine(params, cfg, max_slots=1, policy="edf", preempt=True)
    eng.submit(REQS[0][0], REQS[0][1], 0.0)
    eng.submit(REQS[1][0], REQS[1][1], 1e-4, deadline=100.0)
    recs = {r["rid"]: r for r in eng.run()}
    assert recs[0]["outcome"] == recs[1]["outcome"] == "ok"
    assert recs[0]["preemptions"] == 1 and eng.stats["preemptions"] == 1
    assert recs[0]["tokens"] == solo[REQS[0][0][0]]
    assert recs[1]["tokens"] == solo[REQS[1][0][0]]
    _check_invariants(eng)


def test_bounded_queue_sheds_newest():
    cfg = _cfg()
    eng = _engine(_params(cfg), cfg, max_slots=1, max_queue=1)
    for i in range(4):
        eng.submit([1 + i, 2, 3], 3, 0.0)
    recs = {r["rid"]: r for r in eng.run()}
    outcomes = [recs[i]["outcome"] for i in range(4)]
    assert outcomes.count("shed") == 2 and outcomes[0] == "ok"
    assert eng.stats["shed"] == 2 and eng.stats["submitted"] == 4
    _check_invariants(eng)


# ---------------------------------------------------------------------------
# every fault at once, and the bookkeeping


@pytest.mark.parametrize("kv", KV_LAYOUTS)
def test_chaos_matrix_combined(kv):
    cfg = _cfg(kv)
    params = _params(cfg)
    base = _baseline_tokens(params, cfg)
    eng = _engine(params, cfg, check_finite=True, degrade=True,
                  degrade_after=2, faults=FaultPlan([
                      LogitPoison(rid=1, phase="decode"),
                      KVBitFlip(rid=0, page_index=0, offset=2, bit=1),
                      PagePressure(at=0.0, release=0.1, pages=10_000),
                      TransientFault(kind="decode", times=1),
                      # at the spike's release: a CPU run can end within
                      # 0.05 virtual seconds of it
                      SlowStep(at=0.1, extra_s=0.05)]))
    fp0 = eng.kv.page0_fingerprint()
    recs = _run(eng)
    assert set(recs) == {0, 1, 2}
    assert all(r["outcome"] in OUTCOMES for r in recs.values())
    assert recs[1]["outcome"] == "degraded"
    assert recs[2]["tokens"] == base[2]
    assert recs[1]["tokens"] == base[1]     # the oracle == the engine
    assert eng.kv.page0_fingerprint() == fp0
    for stat in ("fault_page_spikes", "fault_slow_steps", "transient_faults",
                 "fault_kv_bit_flips"):
        assert eng.stats[stat] == 1, stat
    _check_invariants(eng)


def test_fault_plan_reset_rearms():
    plan = FaultPlan([LogitPoison(rid=0, times=1),
                      TransientFault(kind="decode", times=1)])
    assert plan.take_transient("decode", None) is True
    assert plan.take_transient("decode", None) is False
    logits = np.zeros((4,), np.float32)
    assert plan.poison("decode", 0, 0, logits) is not None
    assert plan.poison("decode", 0, 1, logits) is None
    plan.reset()
    assert plan.take_transient("decode", None) is True
    assert plan.poison("decode", 0, 0, logits) is not None


def test_conservation_detects_double_free():
    cfg = _cfg()
    eng = _engine(_params(cfg), cfg)
    eng.kv.check_conservation()
    eng.kv.free_pages.append(eng.kv.free_pages[-1])
    with pytest.raises(AssertionError):
        eng.kv.check_conservation()
