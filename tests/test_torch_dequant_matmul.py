"""The bodies of `vp_dequant_matmul` on the CPU: the planner, and mirrors
of the skinny and tensor-core bodies' arithmetic against the JAX package.

The bodies run only on the card; these tests hold their plain statements:
  (a) `fwd_body` picks the skinny body for decode widths, the tensor
      cores for large M where the words are exact in bf16, else the CUDA
      cores;
  (b) the skinny body's grid (`plan_skinny`, by the kernel's own index
      arithmetic) reads every k row of every output exactly once, and its
      split fills the card as far as a cluster of 8 blocks allows (w_down:
      128 blocks on 132 SMs);
  (c) the skinny body's fixed summation order (an FMA chain per k lane,
      the four lanes of a warp pairwise, the eight warps in order, the
      splits in order) and the tensor-core body's (exact products of bf16
      terms; an f32 x through the truncating three-term split, summed per
      64-deep slice) agree with the JAX function on the same numpy-made
      inputs: f32 within 1e-5 of max|reference|, bf16 within one bf16
      rounding, for int8, int16 and int32 words and ragged shapes.
The JAX side runs as its own tests run it on the CPU: its Pallas body at
`interpret=True`, or its oracle, both through `repro.kernels.ops`, which
pads as it does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import QuantConfig as JQuantConfig
from repro.core.formats import VPFormat as JVPFormat
from repro.kernels import ops as jops
from repro.mimo.equalizer import table1_specs as j_table1
from repro.models.layers import canonical_formats as j_canonical
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.core.formats import VPFormat
from repro_torch.core.packing import pack_vp, storage_dtype
from repro_torch.kernels import ref as tref
from repro_torch.kernels.vp_bwd_matmul import TC_BK
from repro_torch.kernels.vp_dequant_matmul import (
    SK_COLS, SK_KL, SK_MAX_SPLIT, SKINNY_MAX_M, SKINNY_MAX_M_WIDE,
    SkinnyPlan, fwd_body, plan_skinny, vp_dequant_matmul_cuda)
from repro_torch.mimo.equalizer import table1_specs as t_table1
from repro_torch.models.layers import canonical_formats as t_canonical
from test_torch_bwd_tc import split_bf16

_, TVP = t_canonical(TQuantConfig(mode="vp"))
_, JVP = j_canonical(JQuantConfig(mode="vp"))
# words of each width: the canonical int16 format, Table I's y format
# VP(7,[1,-1]) in int8, and VP(16,[18,14]) in int32
FORMATS = {"int16": (TVP, JVP),
           "int8": (t_table1()[2].y_vp, j_table1()[2].y_vp),
           "int32": (VPFormat(16, (18, 14)), JVPFormat(16, (18, 14)))}
SMS = 132   # the H100 SXM the port is measured on
# (M, K, N) of qwen3-0.6b's decode (batch 4): w_up/w_gate, w_down, q/o,
# k/v, lm_head
DECODE = [(4, 1024, 3072), (4, 3072, 1024), (4, 1024, 1024), (4, 1024, 512),
          (4, 1024, 151936)]
BF16_ULP = 2.0 ** -7   # one bf16 rounding apart, relative to the value


# -- (a) the body ---------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 4, 8, 16, 17, 32, 64, 65, 512, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_body_by_width_and_format(M, dtype):
    """Decode at batch 4 on the skinny body, prefill (512) and the train
    forward (1024) on the tensor cores; a format not exact in bf16 on the
    CUDA cores at large M."""
    wide = VPFormat(10, (12, 8))          # M > 9: not exact in bf16
    assert fwd_body(M, dtype, TVP) == ("skinny" if M <= SKINNY_MAX_M
                                       else "tensor_core")
    for fmt in (wide, FORMATS["int32"][0]):
        assert fwd_body(M, dtype, fmt) == (
            "skinny" if M <= SKINNY_MAX_M_WIDE else "cuda_core")
    assert fwd_body(4, dtype, TVP) == "skinny"
    assert fwd_body(512, dtype, TVP) == fwd_body(1024, dtype, TVP) \
        == "tensor_core"
    assert fwd_body(1024, dtype, wide) == "cuda_core"


def test_fwd_body_rejects_other_dtypes():
    with pytest.raises(ValueError):
        fwd_body(4, torch.float16, TVP)


def test_kernel_wrapper_takes_cuda_tensors_only():
    x = torch.zeros((4, 8))
    w = torch.zeros((8, 8), dtype=storage_dtype(TVP))
    with pytest.raises(ValueError):
        vp_dequant_matmul_cuda(x, w, TVP, torch.float32)


# -- (b) the skinny grid ----------------------------------------------------------

def skinny_blocks(plan: SkinnyPlan, M: int, K: int, N: int):
    """(output rows, output columns, {k lane: its k rows in order}) of
    every block of the plan's grid, by the kernel's index arithmetic
    (csrc/vp_dequant_matmul.cu: vp_dequant_matmul_skinny_kernel)."""
    for z in range(plan.split):
        kb, ke = z * plan.k_per, min(K, (z + 1) * plan.k_per)
        lanes = {L: list(range(kb + L, ke, SK_KL)) for L in range(SK_KL)}
        for y in range(plan.m_chunks):
            for x in range(plan.groups):
                yield (range(y * plan.mt, min(M, (y + 1) * plan.mt)),
                       range(x * SK_COLS, min(N, (x + 1) * SK_COLS)), lanes)


@pytest.mark.parametrize("mkn", DECODE[:4] + [
    (1, 1024, 1024), (16, 1024, 3072), (5, 1000, 3000), (33, 96, 24),
    (64, 3072, 1024), (3, 7, 5)])
def test_skinny_plan_reads_every_k_once(mkn):
    M, K, N = mkn
    plan = plan_skinny(M, K, N, SMS)
    assert plan.mt >= min(M, 16) and plan.mt * plan.m_chunks >= M
    assert plan.k_per % SK_KL == 0
    tiles = np.zeros((M, N), dtype=np.int32)   # blocks per output
    ks = {}                                    # k rows read per tile
    for rows, cols, lanes in skinny_blocks(plan, M, K, N):
        run = [k for L in range(SK_KL) for k in lanes[L]]
        assert len(rows) and len(cols) and run
        assert all(r == sorted(r) for r in lanes.values())
        tiles[rows.start:rows.stop, cols.start:cols.stop] += 1
        ks.setdefault((rows.start, cols.start), []).extend(run)
    assert (tiles == plan.split).all()
    for run in ks.values():
        assert sorted(run) == list(range(K))


def test_skinny_plan_fills_the_card():
    """Where the column groups alone leave SMs idle, K is split until
    every SM has a block or a cluster holds no more: w_up runs 288
    blocks; w_down, q/o and k/v (16, 16 and 8 column groups) split 8 ways,
    the portable cluster size (w_down: 128 blocks on 132 SMs); lm_head's
    2374 column groups need no split."""
    for M, K, N in DECODE[:4]:
        plan = plan_skinny(M, K, N, SMS)
        blocks = plan.groups * plan.m_chunks * plan.split
        assert blocks >= SMS or plan.split == SK_MAX_SPLIT, (M, K, N)
    assert plan_skinny(4, 1024, 3072, SMS).split == 6
    w_down = plan_skinny(4, 3072, 1024, SMS)
    assert (w_down.groups, w_down.split) == (16, SK_MAX_SPLIT)
    lm_head = plan_skinny(*DECODE[4], SMS)
    assert lm_head.split == 1 and lm_head.groups == 2374


# -- (c) the bodies' arithmetic against the JAX function ------------------------

def skinny_emulate(x: torch.Tensor, w_real: torch.Tensor,
                   plan: SkinnyPlan) -> torch.Tensor:
    """x (M, K) f32 @ w_real (K, N) f32 in the skinny body's order: per
    split, each k lane's FMA chain over its rows, the 4 lanes of a warp
    pairwise, the warps in order; then the splits in order (an FMA
    emulated in f64: the product is exact there)."""
    M, K = x.shape
    x64, w64 = x.double(), w_real.double()
    out = None
    for z in range(plan.split):
        kb, ke = z * plan.k_per, min(K, (z + 1) * plan.k_per)
        lanes = torch.zeros((SK_KL, M, w_real.shape[1]), dtype=torch.float32)
        for r0 in range(kb, ke, SK_KL):
            rows = torch.arange(r0, min(ke, r0 + SK_KL))
            n = len(rows)
            prod = x64[:, rows].t()[:, :, None] * w64[rows][:, None, :]
            lanes[:n] = (lanes[:n].double() + prod).float()
        while len(lanes) > 8:       # lanes (L, L + 1), then pairs of pairs
            lanes = lanes.reshape(-1, 2, *lanes.shape[1:])
            lanes = lanes[:, 0] + lanes[:, 1]
        warps = list(lanes)
        block = warps[0]
        for w in warps[1:]:
            block = block + w
        out = block if out is None else out + block
    return out


def tc_fwd_emulate(x: torch.Tensor, w_real: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w_real (K, N) as the tensor-core body sums it: a bf16 x
    times the bf16-exact words, exact products in an f32 sum; an f32 x as
    its three truncated bf16 terms, each 64-deep slice's products summed
    in f32 and the slices' partials added in order."""
    if x.dtype == torch.bfloat16:
        return x.float() @ w_real
    acc = torch.zeros((x.shape[0], w_real.shape[1]), dtype=torch.float32)
    for s0 in range(0, x.shape[1], TC_BK):
        w_s = w_real[s0:s0 + TC_BK]
        acc += sum(t.float() @ w_s for t in split_bf16(x[:, s0:s0 + TC_BK]))
    return acc


def _words(rng, shape, fmt: VPFormat) -> torch.Tensor:
    """Packed words of uniform significands and indices of `fmt`."""
    m = rng.integers(fmt.raw_min, fmt.raw_max + 1, shape)
    i = rng.integers(0, fmt.K, shape)
    return pack_vp(torch.from_numpy(m), torch.from_numpy(i), fmt)


def _jax(x: np.ndarray, w: torch.Tensor, jfmt, dtype, interpret):
    jx = jnp.asarray(x)
    if dtype == torch.bfloat16:
        jx = jx.astype(jnp.bfloat16)
    got = jops.vp_dequant_matmul(jx, jnp.asarray(w.numpy()), jfmt,
                                 interpret=interpret)
    return np.asarray(got.astype(jnp.float32))


def assert_within(got: torch.Tensor, want: np.ndarray, dtype):
    """f32: within 1e-5 of max|want|; bf16: within one bf16 rounding of
    each value, plus the f32 order's 1e-5 of max|want|."""
    got = got.float().numpy()
    assert got.shape == want.shape
    rtol = BF16_ULP if dtype == torch.bfloat16 else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-5 * float(np.abs(want).max()))


CASES = [  # (words, (M, K, N), JAX Pallas body at interpret=True)
    ("int16", (4, 320, 136), True),
    ("int16", (3, 100, 77), False),       # ragged: N not a multiple of 8
    ("int8", (4, 96, 130), False),
    # Pallas body: the oracle would round these words to a bf16 x's dtype
    ("int32", (5, 200, 72), True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_skinny_order_against_jax(case, dtype):
    name, (M, K, N), interpret = case
    tfmt, jfmt = FORMATS[name]
    rng = np.random.default_rng(M * 1000 + K + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = _words(rng, (K, N), tfmt)
    assert w.dtype == storage_dtype(tfmt)
    xt = torch.from_numpy(x).to(dtype).float()
    w_real = tref.vp_dequant_packed_ref(w, tfmt, torch.float32)
    plan = plan_skinny(M, K, N, SMS)
    assert fwd_body(M, dtype, tfmt) == "skinny"
    got = skinny_emulate(xt, w_real, plan).to(dtype)
    assert_within(got, _jax(x, w, jfmt, dtype, interpret), dtype)


def test_skinny_split_order_against_jax():
    """A plan that splits K (as at w_down), in M chunks of 16: the skinny
    body at an M that the planner gives it for formats not exact in bf16,
    and that chip_smoke.py's M sweep forces for this one."""
    tfmt, jfmt = FORMATS["int16"]
    rng = np.random.default_rng(7)
    M, K, N = 20, 300, 40
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = _words(rng, (K, N), tfmt)
    plan = plan_skinny(M, K, N, SMS)
    assert plan.split > 1 and plan.m_chunks == 2
    assert fwd_body(M, torch.float32, tfmt) == "tensor_core"   # M > 4
    w_real = tref.vp_dequant_packed_ref(w, tfmt, torch.float32)
    got = skinny_emulate(torch.from_numpy(x), w_real, plan)
    assert_within(got, _jax(x, w, jfmt, torch.float32, False), torch.float32)


TC_CASES = [  # (words, (M, K, N), interpret): large-M shapes, cut down
    ("int16", (40, 192, 72), True),
    ("int16", (33, 96, 24), False),       # ragged
    ("int8", (24, 130, 64), False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", TC_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_tensor_core_forward_against_jax(case, dtype):
    name, (M, K, N), interpret = case
    tfmt, jfmt = FORMATS[name]
    rng = np.random.default_rng(M * 1000 + K + N + 1)
    x = rng.normal(size=(M, K)).astype(np.float32)
    # heavy-tailed columns: the split's mid and lo terms carry weight
    x *= np.exp2(rng.integers(-20, 20, (1, K))).astype(np.float32)
    w = _words(rng, (K, N), tfmt)
    w_real = tref.vp_dequant_packed_ref(w, tfmt, torch.float32)
    assert torch.equal(w_real.to(torch.bfloat16).float(), w_real)
    got = tc_fwd_emulate(torch.from_numpy(x).to(dtype), w_real).to(dtype)
    assert_within(got, _jax(x, w, jfmt, dtype, interpret), dtype)
