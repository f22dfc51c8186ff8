"""The port's plan cache and its policy (`repro_torch.kernels.autotune`),
the Hopper launch-limit model (`repro_torch.analysis.smem`) and the
serving profile helpers (`repro_torch.serving.profile`, `--tune-decode`),
on the CPU.

  * `make_key` gives the reference's key string for the same arguments;
    the cache round-trips through a file (the path set with monkeypatch),
    and writers in several processes keep every entry;
  * `tune` on fake bench functions and a fake clock: the minimum wins,
    the earliest candidate within the margin of the fastest is kept, a
    winner that does not beat the heuristic timed in turns with it
    loses, a candidate that raises loses, all failing raises, and a
    candidate the limit model rejects is never timed;
  * the resolution policy of the two tuned planners: an explicit plan,
    then a cache entry (on a CUDA device only), then the heuristic, which
    is all a launch sees with no cache file; `record` and `clear_cache`
    drop the planners' memos;
  * the limit model admits every heuristic plan of every config the port
    serves, rejects what passes the card's limits, and reads registers
    from a build report, the same one in the process that compiled the
    library and in one that finds it built;
  * `quantized_bytes`, `weight_panels` and `attn_cache_geometries` equal
    to the reference's on SMOKE qwen3, gemma3 (local and global layers),
    mixtral (sliding window) and whisper (encoder-decoder);
  * `--tune-decode --device cpu` prints the skip line and serves as
    before.
"""
import contextlib
import io
import json
import multiprocessing as mp
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import formats as jfmt
from repro.kernels import autotune as jat
from repro.models import model as jmodel
from repro.serving import profile as jprofile
from repro_torch.analysis import smem
from repro_torch.configs import registry as tregistry
from repro_torch.configs.base import QuantConfig
from repro_torch.core import formats as tfmt
from repro_torch.kernels import autotune, build
from repro_torch.kernels.vp_attention import (
    DEC_MAX_CLUSTER, DEC_MAX_WARPS, DECODE_KERNEL, decode_candidates,
    plan_decode)
from repro_torch.kernels.vp_dequant_matmul import (
    SKINNY_KERNEL, SKINNY_MAX_M, SKINNY_MAX_M_WIDE, plan_skinny,
    skinny_candidates, valid_split)
from repro_torch.launch import serve
from repro_torch.models.weights import params_from_numpy
from repro_torch.serving import profile as tprofile

CARD = 0   # a CUDA device index; nothing launches on it
VP7 = tfmt.VPFormat(7, (11, 9, 8, 6))
SMS = 132


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A fresh cache file, a fixed device name, no memoised plans."""
    path = tmp_path / "plans" / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    monkeypatch.setattr(autotune, "backend_name", lambda device: "FakeCard")
    autotune.clear_cache()
    yield path
    autotune.clear_cache()


# -- keys and the file ---------------------------------------------------------

@pytest.mark.parametrize("args", [
    ("vp_dqmm_skinny", (1024, 3072), "vp", "NVIDIA H100 80GB HBM3"),
    ("vp_dec_split", (8, 160, 2, 64, 2, 0, 0), "vp", "NVIDIA H100 80GB HBM3"),
    ("vp_dequant_matmul", (4, 1024, 151936), "both", "cpu"),
    ("vp_matmul", (1, 16, 64, 2), "fxp", "ref"),
])
def test_make_key_is_the_references(args):
    kernel, shape, which, backend = args
    fmts = {"vp": lambda p: (p.VPFormat(7, (11, 9, 8, 6)),),
            "both": lambda p: (p.FXPFormat(12, 11), p.VPFormat(7, (1, -1))),
            "fxp": lambda p: (p.FXPFormat(9, 1),)}[which]
    want = jat.make_key(kernel, shape, fmts(jfmt), backend, mesh="1")
    assert autotune.make_key(kernel, shape, fmts(tfmt), backend) == want
    assert want.endswith("|mesh=1")


def test_cache_round_trips_through_the_file(cache):
    assert autotune.entries() == {} and not cache.exists()
    k1 = autotune.make_key(SKINNY_KERNEL, (1024, 3072), (VP7,), "FakeCard")
    k2 = autotune.make_key(DECODE_KERNEL, (8, 160, 2, 64, 2, 0, 0), (VP7,),
                           "FakeCard")
    autotune.record(k1, (3, 352))
    autotune.record(k2, [4, 2])
    assert json.loads(cache.read_text()) == {k1: [3, 352], k2: [4, 2]}
    autotune._caches.clear()            # a new process reads the file
    assert autotune.entries() == {k1: (3, 352), k2: (4, 2)}
    assert autotune.get_cached(k1) == (3, 352)
    autotune.clear_cache()
    assert not cache.exists() and autotune.get_cached(k1) is None


def test_corrupt_or_foreign_entries_are_ignored(cache):
    cache.parent.mkdir(parents=True)
    cache.write_text("{not json")
    assert autotune.entries() == {}
    autotune._caches.clear()
    cache.write_text(json.dumps({"a": [1, 2], "b": "x", "c": [1.5],
                                 "d": [], "e": [True]}))
    assert autotune.entries() == {"a": (1, 2)}


def _record_worker(path, tag, n):
    import os

    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = path
    from repro_torch.kernels import autotune as at

    for i in range(n):
        at.record(f"{tag}|{i}", (i, i + 1))


def test_writers_in_several_processes_keep_every_entry(cache):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_record_worker, args=(str(cache), f"p{j}", 20))
             for j in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs)
    got = json.loads(cache.read_text())
    assert got == {f"p{j}|{i}": [i, i + 1] for j in range(4)
                   for i in range(20)}


# -- tune -------------------------------------------------------------------------

class FakeClock:
    """bench_fn(plan) sets the plan; the timer returns its time."""

    def __init__(self, times, fail=()):
        self.times, self.fail = times, set(fail)
        self.current, self.timed, self.calls = None, [], []

    def bench(self, plan):
        self.calls.append(plan)
        if plan in self.fail:
            raise RuntimeError(f"launch failed for {plan}")
        self.current = plan

    def timer(self, fn):
        fn()
        self.timed.append(self.current)
        return self.times[self.current]


def _tune(clock, cands, repeats=3):
    return autotune.tune(SKINNY_KERNEL, (1024, 3072), (VP7,), "FakeCard",
                         clock.bench, cands, repeats=repeats,
                         timer=clock.timer)


def test_tune_picks_the_minimum_and_records_it(cache):
    cands = skinny_candidates(1024, 3072, SMS)
    times = {c: 1.0 + 0.1 * n for n, c in enumerate(cands)}
    times[cands[3]] = 0.5
    clock = FakeClock(times)
    assert _tune(clock, cands) == cands[3]
    rounds = 1 + autotune.CONFIRM_ROUNDS             # the pass, then turns
    assert clock.timed.count(cands[3]) == 3 * rounds  # repeats, after warm-up
    assert clock.calls.count(cands[3]) == 1 + 3 * rounds
    assert clock.timed[:3] == [cands[0]] * 3         # in a row
    assert clock.timed[-6:] == [cands[0]] * 3 + [cands[3]] * 3  # in turns
    key = autotune.make_key(SKINNY_KERNEL, (1024, 3072), (VP7,), "FakeCard")
    assert autotune.get_cached(key) == cands[3]
    again = FakeClock(times)
    assert _tune(again, cands) == cands[3] and again.calls == []


def test_tune_keeps_the_first_candidate_within_the_margin(cache):
    cands = skinny_candidates(1024, 3072, SMS)
    times = {c: 1.0 for c in cands}
    times[cands[2]] = 1.0 - autotune.MARGIN / 2      # faster, not enough
    assert _tune(FakeClock(times), cands) == cands[0]


def test_tune_keeps_the_earliest_within_the_margin_of_the_fastest(cache):
    cands = skinny_candidates(1024, 3072, SMS)
    times = {c: 1.0 for c in cands}
    times[cands[1]] = 0.80                           # within 3 % of 0.79
    times[cands[4]] = 0.79
    times[cands[5]] = 0.795
    assert _tune(FakeClock(times), cands) == cands[1]
    autotune.clear_cache()
    times[cands[1]] = 0.79 * (1 + autotune.MARGIN) + 1e-6
    assert _tune(FakeClock(times), cands) == cands[4]


def test_tune_keeps_the_heuristic_when_a_lucky_reading_fails_in_turns(cache):
    cands = skinny_candidates(1024, 3072, SMS)[:4]

    class Lucky(FakeClock):
        """cands[2] reads fast only in the first pass."""
        def timer(self, fn):
            t = super().timer(fn)
            if self.current == cands[2] and self.timed.count(cands[2]) <= 3:
                return 0.5
            return t

    clock = Lucky({c: 1.0 for c in cands})
    assert _tune(clock, cands) == cands[0]
    assert clock.timed.count(cands[2]) == 3 * (1 + autotune.CONFIRM_ROUNDS)
    key = autotune.make_key(SKINNY_KERNEL, (1024, 3072), (VP7,), "FakeCard")
    assert autotune.get_cached(key) == cands[0]


def test_tune_skips_a_failing_candidate_and_raises_when_all_fail(cache):
    cands = skinny_candidates(1024, 3072, SMS)[:3]
    clock = FakeClock({c: 1.0 for c in cands} | {cands[0]: 0.1},
                      fail=[cands[0]])
    assert _tune(clock, cands) == cands[1]           # ties: the first
    with pytest.raises(RuntimeError, match="all 3 feasible"):
        autotune.tune(SKINNY_KERNEL, (3072, 1024), (VP7,), "FakeCard",
                      FakeClock({}, fail=cands).bench, cands,
                      timer=FakeClock({}).timer)


def test_tune_never_times_a_candidate_the_model_rejects(cache):
    cands = [(16, 64), (8, 128), (4, 256)]           # a cluster of 16 first
    clock = FakeClock({(16, 64): 0.01, (8, 128): 1.0, (4, 256): 2.0})
    assert _tune(clock, cands) == (8, 128)
    assert (16, 64) not in clock.calls
    with pytest.raises(RuntimeError, match="exceeds the card's limits"):
        autotune.tune(SKINNY_KERNEL, (3072, 1024), (VP7,), "FakeCard",
                      clock.bench, [(16, 64)], timer=clock.timer)


# -- the planners' policy -------------------------------------------------------

def test_skinny_policy_explicit_then_cache_then_heuristic(cache):
    K, N = 3072, 1024

    def split(M, K=K, N=N, device=CARD, explicit=None):
        p = plan_skinny(M, K, N, SMS, explicit, VP7, device)
        return p.split, p.k_per

    h = plan_skinny(1, K, N, SMS)
    assert split(1) == (h.split, h.k_per)              # no file: heuristic
    key = autotune.make_key(SKINNY_KERNEL, (K, N), (VP7,), "FakeCard")
    autotune.record(key, (6, 512))
    assert split(1) == (6, 512)                       # `record` drops the memo
    for M in (1, 2, 3, 4):
        assert split(M) == (6, 512)
        assert plan_skinny(M, K, N, SMS, None, VP7, CARD).mt == \
            plan_skinny(M, K, N, SMS).mt               # rows follow M
    assert split(4, device=None) == (h.split, h.k_per)  # off the card
    assert split(4, explicit=(3, 1024)) == (3, 1024)
    assert split(1, N=N + 1) == (plan_skinny(1, K, N + 1, SMS).split,
                                 plan_skinny(1, K, N + 1, SMS).k_per)
    autotune.record(key, (9, 352))                     # not a split of K
    assert split(1) == (h.split, h.k_per)
    autotune.record(key, (6, 512))
    autotune.clear_cache()
    assert split(1) == (h.split, h.k_per)
    assert (h.split, h.k_per) == (plan_skinny(4, K, N, SMS).split,
                                  plan_skinny(4, K, N, SMS).k_per)


def test_decode_policy_explicit_then_cache_then_heuristic(cache):
    shape = (8, 160, 2, 64, 2)
    h = plan_decode(*shape)

    def plan(window=None, rolling=False, device=CARD, explicit=None):
        return plan_decode(*shape, explicit, window, rolling, VP7, device)

    assert plan() == h
    key = autotune.make_key(DECODE_KERNEL, shape + (0, 0), (VP7,), "FakeCard")
    autotune.record(key, (3, 5))
    got = plan()
    assert (got.cluster, got.warps) == (3, 5)
    assert (got.lpp, got.lane_bytes, got.slices) == (h.lpp, h.lane_bytes,
                                                     h.slices)
    assert plan(64, True) == h                        # another ring
    assert plan(device=None) == h                     # off the card
    assert autotune.cuda_index(torch.device("cpu")) is None
    assert autotune.cuda_index(torch.device("cuda", 1)) == 1
    explicit = plan(explicit=(1, 1))
    assert (explicit.cluster, explicit.warps) == (1, 1)
    autotune.record(key, (DEC_MAX_CLUSTER + 1, 1))    # refused: heuristic
    assert plan() == h


def test_candidates_start_with_the_heuristic():
    for K, N in ((1024, 3072), (3072, 1024), (1024, 151936), (96, 24)):
        cands = skinny_candidates(K, N, SMS)
        h = plan_skinny(1, K, N, SMS)
        assert cands[0] == (h.split, h.k_per)
        assert len(set(cands)) == len(cands)
        assert all(valid_split(K, c) for c in cands)
    cands = decode_candidates(8, 160, 2, 64, 2)
    h = plan_decode(8, 160, 2, 64, 2)
    assert cands[0] == (h.cluster, h.warps)
    assert sorted(cands) == [(c, w) for c in range(1, DEC_MAX_CLUSTER + 1)
                             for w in range(1, DEC_MAX_WARPS + 1)]


# -- the limit model --------------------------------------------------------------

FORMATS = {"int8": (6, 2), "int16": (7, 2), "int16 wide": (10, 2),
           "int32": (13, 4)}


def _panels(cfg):
    d, dh = cfg.d_model, cfg.head_dim
    q, kv = cfg.n_heads * dh, cfg.n_kv_heads * dh
    return {(d, q), (d, kv), (q, d), (d, cfg.d_ff), (cfg.d_ff, d),
            (d, cfg.vocab)}


@pytest.mark.parametrize("arch", tregistry.ARCH_NAMES)
def test_model_admits_every_heuristic_plan(arch):
    cfg = tregistry.get_config(arch)
    fxp = tfmt.FXPFormat(12, 11)
    for M, E in FORMATS.values():
        fmt = tfmt.default_vp_format(fxp, M, E)
        max_m = SKINNY_MAX_M if M <= 9 else SKINNY_MAX_M_WIDE
        for K, N in _panels(cfg):
            for m in range(1, max_m + 1):
                p = plan_skinny(m, K, N, SMS)
                ok, launch = smem.plan_feasible(
                    SKINNY_KERNEL, (p.split, p.k_per), (K, N), (fmt,))
                assert ok and launch is not None, (K, N, m, launch)
    KV, dh = cfg.n_kv_heads, cfg.head_dim
    G = cfg.n_heads // KV
    lens = {16, 144, 160, 1024, 4096, cfg.local_window,
            cfg.sliding_window or 16}
    for w_bytes in (1, 2, 4):
        for smax in lens:
            try:
                h = plan_decode(KV, smax, G, dh, w_bytes)
            except ValueError:        # a shape the body refuses
                continue
            ok, launch = smem.plan_feasible(
                DECODE_KERNEL, (h.cluster, h.warps),
                (KV, smax, G, dh, w_bytes, 0, 0), (VP7,))
            assert ok and launch.threads == 32 * h.warps, (smax, w_bytes)


def test_model_rejects_what_passes_the_limits():
    big = smem.skinny_launch(4, 16, 2)
    assert smem.problems(big) == ["a cluster of 16 blocks outside 1..8"]
    wide = smem.decode_launch(8, 8, 8, 256, 4, 32)
    assert wide.dynamic_smem == 4 * 9 * 8 * 256
    assert smem.problems(wide, limit=wide.dynamic_smem) != []
    assert smem.problems(wide) == []
    assert smem.problems(smem.Launch("k<1>", 50_000, 0, 1024, 1)) == [
        "50000 bytes of static shared memory > 49152"]
    assert smem.problems(smem.skinny_launch(1, 1, 2), registers=257) != []
    assert smem.problems(smem.skinny_launch(1, 1, 2), registers=255) == []
    assert smem.plan_feasible("vp_matmul", (1,), (1, 2, 3), ()) == (True,
                                                                    None)


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_131vp_dequant_matmul_skinny_kernelILi4EsEEvNS_6SkArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_131vp_dequant_matmul_skinny_kernelILi4EsEEvNS_6SkArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 300 registers, used 1 barriers, 9728 bytes smem, 720 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_132vp_decode_attention_split_kernelIaLi8ELi8EEEvNS_7DecArgsENS_5VPFmtEi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_132vp_decode_attention_split_kernelIaLi8ELi8EEEvNS_7DecArgsENS_5VPFmtEi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 1088 bytes smem, 912 bytes cmem[0]
"""


def test_model_reads_registers_from_the_build_report(tmp_path, monkeypatch):
    assert smem.parse_build_log(PTXAS) == {
        "vp_dequant_matmul_skinny_kernel<4,int16>": (300, 9728),
        "vp_decode_attention_split_kernel<int8,8,8>": (96, 1088)}
    launch = smem.skinny_launch(4, 2, 2)
    assert launch.instance == "vp_dequant_matmul_skinny_kernel<4,int16>"
    assert launch.static_smem == 9728
    assert smem.decode_launch(1, 1, 8, 168, 1, 8).instance == \
        "vp_decode_attention_split_kernel<int8,8,8>"
    assert smem.demangle(
        "_ZN48_GLOBAL__N__22d3d3d2_15_vp_attention_cu_44adabfb32vp_decode_"
        "attention_split_kernelIsLi2ELi16EEEvNS_7DecArgsENS_5VPFmtEi") == \
        "vp_decode_attention_split_kernel<int16,2,16>"
    assert smem.demangle("_ZN48_GLOBAL__N__22d3d3d2_15_vp_attention_cu_44ada"
                         "bfb23flash_prefill_cc_kernelIfEEvNS_9FlashArgsE") \
        is None
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_LOGS", {})
    assert smem.problems(launch) == []               # no build report
    monkeypatch.setattr(build, "BUILD_LOGS", {"vp_dequant_matmul": PTXAS})
    assert smem.problems(launch) == ["300 registers x 256 threads > 65536"]


FAKE_NVCC = '''#!{python}
import sys
args = sys.argv[1:]
open(args[args.index("-o") + 1], "w").write("built")
sys.stdout.write(open({log!r}).read())
'''


def test_build_report_is_the_same_in_a_warm_process(tmp_path, monkeypatch):
    """A process that compiles a library keeps nvcc's report beside it;
    one that finds the library built reads that report, compiles nothing
    and sees the same registers."""
    report = tmp_path / "ptxas.txt"
    report.write_text(PTXAS)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(report)))
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "BUILD_LOGS", {})
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    launch = smem.skinny_launch(4, 2, 2)
    want = ["300 registers x 256 threads > 65536"]
    assert build.build_all(["vp_dequant_matmul"]) == {
        "vp_dequant_matmul": PTXAS}                   # cold: compiled
    target = build._target("vp_dequant_matmul")
    assert target.read_text() == "built"
    assert target.with_suffix(".log").read_text() == PTXAS
    assert smem.problems(launch) == want

    def no_nvcc():
        raise AssertionError("a built library was compiled again")

    monkeypatch.setattr(build, "BUILD_LOGS", {})      # a new process
    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    assert build.build_all(["vp_dequant_matmul"]) == {}
    assert build.build_log("vp_dequant_matmul") == PTXAS
    assert smem.build_registers(launch.instance) == 300
    assert smem.problems(launch) == want
    assert build.build_log("vp_attention") is None    # not built
    os.remove(target.with_suffix(".log"))             # built without one
    monkeypatch.setattr(build, "BUILD_LOGS", {})
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    assert build.build_all(["vp_dequant_matmul"]) == {
        "vp_dequant_matmul": PTXAS}
    assert build.build_log("vp_dequant_matmul") == PTXAS


# -- the serving profile ------------------------------------------------------------

PROFILE_ARCHS = {"qwen3-0.6b": 40, "gemma3-27b": 20, "mixtral-8x22b": 24,
                 "whisper-tiny": 16}


@pytest.fixture(scope="module", params=sorted(PROFILE_ARCHS))
def quantized(request):
    """The reference's exported SMOKE tree (packed words, VP KV cache)
    and its port, carried across as numpy."""
    arch = request.param
    jq = JQuantConfig(mode="vp", quantize_kv_cache=True)
    jcfg = jregistry.get_smoke_config(arch, jq)
    tcfg = tregistry.get_smoke_config(
        arch, QuantConfig(mode="vp", quantize_kv_cache=True))
    jp = jmodel.quantize_params(jmodel.init_params(jax.random.PRNGKey(0),
                                                   jcfg), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           device="cpu")
    return arch, jcfg, tcfg, jp, tp


def test_profile_helpers_equal_the_references(quantized):
    arch, jcfg, tcfg, jp, tp = quantized
    assert tprofile.quantized_bytes(tp) == jprofile.quantized_bytes(jp)
    assert tprofile.weight_panels(tp) == jprofile.weight_panels(jp)
    for max_len in (PROFILE_ARCHS[arch], 7, 4096):
        assert tprofile.attn_cache_geometries(tcfg, max_len) == \
            jprofile.attn_cache_geometries(jcfg, max_len)


def test_tune_decode_on_the_cpu_skips_and_serves_as_before(cache):
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--quant", "vp", "--kv-quant",
            "--batch", "2", "--prompt-len", "8", "--gen", "3",
            "--device", "cpu"]
    plain = serve.main(argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tuned = serve.main(argv + ["--tune-decode"])
    assert "[serve] decode autotune profile skipped:" in out.getvalue()
    assert tuned["tokens"] == plain["tokens"]
    assert tuned["tune_decode"]["entries"] == 0
    assert not cache.exists()
