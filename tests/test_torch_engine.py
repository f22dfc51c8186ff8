"""The port's paged continuous-batching engine on the CPU (tiny config of
tests/test_serving_engine.py: 2 layers, d_model 64).

The engine is a scheduler, not a second model: its greedy tokens must be
the port's static per-request oracle's (`serving.oracle_generate`: B = 1,
max_len = the engine capacity) for every quant mode x KV layout, with
ragged prompts, a late arrival, slot reuse, chunked prefill and decode
run-ahead.  Beside parity: the allocator's properties (disjoint pages,
eviction returns them, free pages never read), the rejections, and the
sampling noise.  A few cases hold the port's engine against the JAX
package's static oracle on the same (numpy-converted) weights.  The
CUDA-graph decode step runs only on the card (chip_smoke.py).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import QuantConfig as JQuantConfig
from repro.models import init_params as jinit_params
from repro.models import quantize_params as jquantize_params
from repro.serving.runner import oracle_generate as joracle_generate
from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.launch import serve
from repro_torch.models.model import init_params, quantize_params
from repro_torch.models.weights import params_from_numpy
from repro_torch.serving import (PagedKVCache, ServingEngine, VirtualClock,
                                 oracle_generate)
from repro_torch.serving.runner import gumbel_noise

# Ragged prompts, ragged budgets, one late arrival; max_slots=2 forces
# queueing, eviction and slot reuse with 3 requests.
REQS = [([1, 2, 3, 4, 5], 4, 0.0),
        (list(range(7)), 5, 0.0),
        ([9, 8, 7], 3, 0.05)]
CAP, PAGE, SLOTS = 24, 8, 2

MATRIX = [(mode, kv)
          for mode in ("none", "fxp", "vp", "vp_block")
          for kv in ("float", "packed", "planes")]


def _quant_kw(mode: str, kv: str) -> dict:
    kw = dict(mode=mode)
    if mode == "vp_block":
        kw["block"] = 16
    if kv != "float":
        kw.update(quantize_kv_cache=True, kv_layout=kv)
    return kw


def _tiny(quant_kw: dict, cls=ModelConfig, qcls=QuantConfig):
    return cls(name="tiny", family="dense", n_layers=2, d_model=64,
               n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
               dtype="float32", quant=qcls(**quant_kw))


def _setup(mode="vp", kv="packed"):
    cfg = _tiny(_quant_kw(mode, kv))
    return quantize_params(init_params(cfg, seed=0, device="cpu"), cfg), cfg


def _engine(params, cfg, **kw):
    kw.setdefault("max_slots", SLOTS)
    kw.setdefault("capacity", CAP)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("clock", VirtualClock())
    return ServingEngine(params, cfg, **kw)


def _engine_tokens(params, cfg, reqs=REQS, **kw):
    eng = _engine(params, cfg, **kw)
    for prompt, gen, at in reqs:
        eng.submit(prompt, gen, at)
    return eng, [r["tokens"] for r in eng.run()]


def _oracle(params, cfg, reqs=REQS):
    return [oracle_generate(params, cfg, p, g, CAP) for p, g, _ in reqs]


# -- engine == static, over the quant x KV matrix -------------------------


@pytest.mark.parametrize("mode,kv", MATRIX)
def test_engine_static_parity_matrix(mode, kv):
    """vp_block quantizes each activation tensor over ONE pow2 scale
    (as the reference does), so requests decoded in one batch can move
    each other's quantization: there the per-request oracle holds when
    each request decodes alone (one slot; ROADMAP.md queue 3)."""
    params, cfg = _setup(mode, kv)
    slots = 1 if mode == "vp_block" else SLOTS
    _, got = _engine_tokens(params, cfg, max_slots=slots)
    assert [len(t) for t in got] == [g for _, g, _ in REQS]
    assert got == _oracle(params, cfg)


@pytest.mark.parametrize("mode,kv", [("none", "float"), ("vp", "packed"),
                                     ("vp", "planes")])
def test_chunked_prefill_token_match(mode, kv):
    """Chunked prefill reassociates the prompt's attention, so the
    contract is token agreement, not bit identity."""
    params, cfg = _setup(mode, kv)
    _, got = _engine_tokens(params, cfg, prefill_chunk=4)
    assert got == _oracle(params, cfg)


def test_decode_lookahead_parity():
    """Run-ahead amortizes the gather and the commit; any lookahead gives
    the same tokens, over-generation trimmed to each budget."""
    params, cfg = _setup()
    outs = [_engine_tokens(params, cfg, decode_lookahead=la)[1]
            for la in (1, 3, 4)]
    assert outs[0] == outs[1] == outs[2] == _oracle(params, cfg)


# -- against the JAX package's static oracle ------------------------------


@pytest.mark.parametrize("mode,kv", [("vp", "packed"), ("fxp", "planes")])
def test_engine_matches_jax_static_oracle(mode, kv):
    """The port's engine on the reference's own weights (exported by the
    JAX package, carried across as numpy) gives the JAX static path's
    greedy tokens."""
    jcfg = _tiny(_quant_kw(mode, kv), JModelConfig, JQuantConfig)
    cfg = _tiny(_quant_kw(mode, kv))
    jp = jquantize_params(jinit_params(jax.random.PRNGKey(0), jcfg), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                               "cpu")
    _, got = _engine_tokens(params, cfg, decode_lookahead=4)
    want = [joracle_generate(jp, jcfg, p, g, CAP) for p, g, _ in REQS]
    assert got == want


# -- allocator / isolation properties --------------------------------------


def test_poisoned_free_pages_never_read():
    """Garbage in the dummy page 0 and in every free page must be
    invisible: pages are handed out as they are, so any read past a
    request's committed span, or from a page freed and reused, would
    change tokens."""
    params, cfg = _setup()
    _, clean = _engine_tokens(params, cfg)
    eng = _engine(params, cfg)
    pages = torch.tensor([0] + list(eng.kv.free_pages))
    for pool in eng.kv.pools.values():
        poison = (torch.iinfo(pool.dtype).max if not pool.is_floating_point()
                  else 1e30)
        pool[:, pages] = poison
    for prompt, gen, at in REQS:
        eng.submit(prompt, gen, at)
    assert [r["tokens"] for r in eng.run()] == clean


def test_allocated_page_sets_disjoint():
    _, cfg = _setup()
    kv = PagedKVCache(cfg, max_slots=3, capacity=CAP, page_size=PAGE,
                      device="cpu")
    total = kv.n_pages - 1
    owned = {}
    for total_len in (5, 16, 24):
        slot = kv.alloc(total_len)
        used = kv.block_table[slot].numpy()[:kv.pages_needed(total_len)]
        assert (used > 0).all(), "allocated the dummy page"
        owned[slot] = set(used.tolist())
    sets = list(owned.values())
    for i in range(len(sets)):
        for j in range(i + 1, len(sets)):
            assert not (sets[i] & sets[j]), "page aliasing across slots"
    assert len(kv.free_pages) == total - sum(len(s) for s in sets)
    # The pools are (layers, pages, page size, ...), one per buffer.
    assert sorted(k.split(".")[-1] for k in kv.pools) == [
        "k_s", "k_w", "v_s", "v_w"]
    assert all(p.shape[:3] == (2, kv.n_pages, PAGE)
               for p in kv.pools.values())


def test_eviction_returns_pages():
    params, cfg = _setup()
    eng, _ = _engine_tokens(params, cfg)
    assert len(eng.kv.free_pages) == eng.kv.n_pages - 1
    assert not eng.scheduler.running and not eng.scheduler.waiting
    assert eng.kv.lengths.tolist() == [0] * SLOTS


def test_oversized_request_rejected():
    params, cfg = _setup()
    eng = _engine(params, cfg)
    eng.submit(list(range(CAP)), 8, 0.0)   # prompt + gen > capacity
    with pytest.raises(ValueError, match="capacity"):
        eng.run()


def test_check_finite_raises_on_overflow():
    params, cfg = _setup("none", "float")
    params = dict(params)
    params["lm_head"] = torch.full_like(params["lm_head"], float("inf"))
    eng = _engine(params, cfg, check_finite=True, on_nonfinite="raise")
    eng.submit([1, 2, 3], 4, 0.0)
    with pytest.raises(FloatingPointError):
        eng.run()


@pytest.mark.parametrize("what", ["windowed", "encdec", "mesh"])
def test_engine_rejections(what):
    params, cfg = _setup()
    if what == "windowed":
        cfg = dataclasses.replace(cfg, sliding_window=8)
        with pytest.raises(ValueError, match="full-causal"):
            _engine(params, cfg, prefill_chunk=4)
    elif what == "encdec":
        with pytest.raises(ValueError, match="encoder-decoder"):
            _engine(params, dataclasses.replace(cfg, family="encdec"))
    else:
        with pytest.raises(ValueError, match="DeviceMesh"):
            _engine(params, cfg, mesh=object())


# -- sampling ----------------------------------------------------------------


def test_engine_temperature_draws_advance():
    """Sampled decoding draws fresh noise for every unit from one
    generator seeded by `seed`; greedy decoding draws nothing."""
    params, cfg = _setup("none", "float")
    eng = _engine(params, cfg, temperature=0.7, seed=3)
    g1, g2 = eng._next_key(), eng._next_key()
    a = gumbel_noise(g1, (4, 128), "cpu")
    b = gumbel_noise(g2, (4, 128), "cpu")
    assert not torch.equal(a, b)
    again = _engine(params, cfg, temperature=0.7, seed=3)
    assert torch.equal(gumbel_noise(again._next_key(), (4, 128), "cpu"), a)
    greedy = _engine(params, cfg)
    assert greedy._next_key() is None and greedy._next_key() is None
    # A sampled run is reproducible from its seed and differs from greedy.
    runs = [_engine_tokens(params, cfg, temperature=1.5, seed=s)[1]
            for s in (3, 3, 4)]
    assert runs[0] == runs[1] != runs[2]
    assert [len(t) for t in runs[0]] == [g for _, g, _ in REQS]


def test_engine_cli_runs_on_cpu(tmp_path):
    report = serve.main([
        "--smoke", "--device", "cpu", "--quant", "vp", "--kv-quant",
        "--engine", "--batch", "3", "--max-slots", "2", "--page-size", "8",
        "--prompt-len", "8", "--gen", "4", "--ragged-gen",
        "--lookahead", "2", "--prefill-chunk", "4"])
    assert report["mode"] == "engine"
    assert report["outcomes"] == {"ok": 3}
    assert report["decode_graphs"] == 0            # graphs: the card only
    assert [len(t) for t in report["tokens"]] == serve._ragged_gens(4, 3)
