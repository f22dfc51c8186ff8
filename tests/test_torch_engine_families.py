"""The engine's family rows against the JAX package: the four configs of
the reference's `test_engine_family_parity` (zamba2-7b: Mamba2 state
rows and a paged shared attention block; rwkv6-3b: state rows only, no
pages; mixtral-8x22b: sliding-window dense rings and MoE; qwen3-moe:
paged layers and MoE) and the VLM internvl2-1b (served text-only, as the
reference's engine serves it: no patches reach its runner) on their
SMOKE configs, float weights as that test serves them.  Both engines
refuse the encoder-decoder whisper-tiny for the same reason.

Both engines get the same parameters (the reference's tree carried
across as numpy) and the same requests (`REQS`: ragged prompts and
budgets, one late arrival, 2 slots so that a slot is reused, capacity
24, pages of 8).  The port's engine tokens equal the reference engine's,
and the static oracle's as the reference's test asserts.  Chunked
prefill (chunks of 4) on zamba2 and rwkv6 is held against the reference
engine's chunked run: the reference's Mamba2 prompt chunk zero-pads its
conv and drops the conv history it is given, so zamba2's chunked tokens
are not its static oracle's, on both sides (ROADMAP, notes on the
reference side).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import init_params as jinit_params
from repro.serving import ServingEngine as JEngine
from repro.serving import VirtualClock as JClock
from repro_torch.configs import registry as tregistry
from repro_torch.models.weights import params_from_numpy
from repro_torch.serving import (PagedKVCache, ServingEngine, VirtualClock,
                                 oracle_generate)
from repro_torch.serving.page_cache import DENSE, PAGED, STATE, plan_cache

REQS = [([1, 2, 3, 4, 5], 4, 0.0),
        (list(range(7)), 5, 0.0),
        ([9, 8, 7], 3, 0.05)]
CAP, PAGE, SLOTS = 24, 8, 2
ARCHS = ("zamba2-7b", "rwkv6-3b", "mixtral-8x22b", "qwen3-moe-30b-a3b",
         "internvl2-1b")

_TREES = {}


def trees(arch):
    """(reference params, port params, reference cfg, port cfg)."""
    if arch not in _TREES:
        jc = jregistry.get_smoke_config(arch)
        tc = tregistry.get_smoke_config(arch)
        jp = jinit_params(jax.random.PRNGKey(0), jc)
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc,
                               "cpu")
        _TREES[arch] = (jp, tp, jc, tc)
    return _TREES[arch]


def run(cls, clock, params, cfg, **kw):
    eng = cls(params, cfg, max_slots=SLOTS, capacity=CAP, page_size=PAGE,
              clock=clock(), **kw)
    for prompt, gen, at in REQS:
        eng.submit(prompt, gen, at)
    return eng, [r["tokens"] for r in eng.run()]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_family_matches_reference_engine(arch):
    """Whole-prompt prefill: the port's tokens are the reference
    engine's, request by request, and the port's static oracle's."""
    jp, tp, jc, tc = trees(arch)
    _, want = run(JEngine, JClock, jp, jc)
    eng, got = run(ServingEngine, VirtualClock, tp, tc)
    assert got == want
    for (prompt, gen, _), toks in zip(REQS, got):
        assert len(toks) == gen
        assert toks == oracle_generate(tp, tc, prompt, gen, CAP)
    eng.kv.check_conservation()


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-3b"])
def test_chunked_prefill_matches_reference_engine(arch):
    """Chunks of 4 (prompts of 5, 7 and 3: a last chunk of one token
    takes the one-step recurrence): the reference engine's chunked
    tokens.  rwkv6's equal its static oracle too; zamba2's second request
    does not on either side (the conv history is dropped per chunk)."""
    jp, tp, jc, tc = trees(arch)
    _, want = run(JEngine, JClock, jp, jc, prefill_chunk=4)
    _, got = run(ServingEngine, VirtualClock, tp, tc, prefill_chunk=4)
    assert got == want
    static = [oracle_generate(tp, tc, p, g, CAP) for p, g, _ in REQS]
    if arch == "rwkv6-3b":
        assert got == static
    else:
        assert got[1] != static[1] and got[0] == static[0]


def test_engine_refuses_encdec_as_the_reference():
    """whisper-tiny: the cross-attention source is request-specific; both
    engines raise a ValueError that says so before serving anything."""
    jc = jregistry.get_smoke_config("whisper-tiny")
    tc = tregistry.get_smoke_config("whisper-tiny")
    jp = jinit_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc, "cpu")
    with pytest.raises(ValueError) as want:
        JEngine(jp, jc, max_slots=SLOTS, capacity=CAP, page_size=PAGE,
                clock=JClock())
    with pytest.raises(ValueError) as got:
        ServingEngine(tp, tc, max_slots=SLOTS, capacity=CAP, page_size=PAGE,
                      clock=VirtualClock())
    reason = ("paged serving does not support encoder-decoder models (the "
              "cross-attention source is request-specific")
    assert str(got.value).startswith(reason)
    assert str(want.value).startswith(reason)


def test_mixtral_chunked_prefill_is_refused():
    _, tp, _, tc = trees("mixtral-8x22b")
    with pytest.raises(ValueError, match="full-causal"):
        ServingEngine(tp, tc, max_slots=SLOTS, capacity=CAP, page_size=PAGE,
                      prefill_chunk=4)


@pytest.mark.parametrize("arch,kinds", [
    ("zamba2-7b", {("mamba", STATE), ("shared_attn", PAGED)}),
    ("rwkv6-3b", {("rwkv", STATE)}),
    ("mixtral-8x22b", {("moe_swa", DENSE)}),
    ("qwen3-moe-30b-a3b", {("moe", PAGED)}),
    ("internvl2-1b", {("causal", PAGED)})])
def test_cache_plan_kinds(arch, kinds):
    """Each sub-layer's storage kind; state rows have no sequence axis
    and cost no page bytes; rwkv6 (states) and mixtral (rings) have no
    pages at all."""
    tc = tregistry.get_smoke_config(arch)
    specs = plan_cache(tc, CAP)
    assert {(s.pattern, s.kind) for s in specs} == kinds
    kv = PagedKVCache(tc, SLOTS, CAP, PAGE, device="cpu")
    for s in specs:
        if s.kind == STATE:
            assert s.buf_len == 0 and not s.has_len
            for name, tail, _ in s.bufs:
                assert kv.dense[f"g{s.gi}.{s.sub}.{name}"].shape == (
                    s.reps, SLOTS) + tail
    assert kv.has_paged == (arch in ("zamba2-7b", "qwen3-moe-30b-a3b",
                                     "internvl2-1b"))
    if not kv.has_paged:
        assert kv.pages_needed(CAP) == 0 and kv.bytes_per_page == 0
        assert not kv.pools and kv.can_admit(CAP)


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-3b"])
def test_reused_slot_starts_from_a_zeroed_state(arch):
    """A request's state rows are left behind on eviction; the next
    tenant of the slot gets them zeroed at admission, with the other
    slot's rows untouched."""
    tc = tregistry.get_smoke_config(arch)
    kv = PagedKVCache(tc, SLOTS, CAP, PAGE, device="cpu")
    a = kv.alloc(12)
    b = kv.alloc(12)
    for t in kv.dense.values():
        t.fill_(3.0)
    kv.free(a)
    again = kv.alloc(16)
    assert again == a
    for key, t in kv.dense.items():
        assert torch.all(t[:, again] == 0), key
        assert torch.all(t[:, b] == 3.0), key
    kv.free(again)
    kv.free(b)
    kv.check_conservation()
