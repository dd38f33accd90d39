"""Kernel B as three launches (B1 ``ln_gemm``, A, B2 ``block_tail``): what a
CPU run can hold of it.

- the chain of plain versions ``ln_gemm_ref -> flash_attention_ref ->
  block_tail_ref`` against the JAX package's Pallas kernel in interpret
  mode and against the seven-launch chain of plain LayerNorm and GEMM
  versions it replaced, with and without a (B, T, T) bias: 2e-5 in f32, one
  bf16 rounding step in bf16;
- the tail's splits in its plain version (the out-projection over K and
  the FF hidden over 1, 4 and 8 ranks) against the unsplit sums, 2e-5;
- the plans (``_ln_gemm_plan``, ``_tail_plan``) at the main path's shapes,
  and the shared-memory budget of every plan the kernels have against the
  227 KB a block may use;
- a numpy emulation of 3xTF32 (mantissa cut to 10 bits, three products, f32
  sums in the tail's split order) through the whole tail at the estimator's
  widths: inside the f32 tolerance where single-pass TF32 is not;
- the wrappers' refusals, of inputs that require a gradient among them.

The kernels themselves run only on the card, where ``chip_smoke.py`` holds
them against these plain versions."""

import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cosy_tpu.ops.fused_block import fused_transformer_block as j_fused
from cosy_tpu_torch import ops
from cosy_tpu_torch.ops import _cuda
from cosy_tpu_torch.ops import fused_block as tfb
from cosy_tpu_torch.ops.flash_attention import flash_attention_ref
from test_torch_common import assert_close, t
from test_torch_kernel_plans import _matmul_tf32, _within
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=2e-5, rtol=2e-5)
CSRC = Path(tfb.__file__).resolve().parent.parent / "csrc"
F32, BF16 = torch.float32, torch.bfloat16


def _weights(rng, C, inner, ff):
    """The block's 13 weights as numpy f32: norms near 1, the rest ~0.05."""
    def mk(*shape, one=False):
        w = rng.standard_normal(shape).astype(np.float32) * 0.05
        return w + 1.0 if one else w

    return [mk(C, one=True), mk(C), mk(inner, C), mk(inner, C), mk(inner, C), mk(C, inner),
            mk(C), mk(C, one=True), mk(C), mk(ff, C), mk(ff), mk(C, ff), mk(C)]


def _seven_launch_ref(x, bias, W, heads, scale):
    """The block as the seven-launch chain's plain versions (LN, QKV GEMM,
    attention, out-projection GEMM, LN, FF1 GEMM, FF2 GEMM), the form the
    block had before B1 and B2."""
    n1w, n1b, wq, wk, wv, wo, bo, n3w, n3b, w1, b1, w2, b2 = W
    B, T, C = x.shape
    cd, inner = x.dtype, wq.shape[0]
    x2 = x.reshape(B * T, C)
    h = tfb.layer_norm_rows_ref(x2, n1w, n1b, cd)
    qkv = tfb.gemm_ref(h, (wq, wk, wv), out_dtype=cd).view(B, T, 3, heads, inner // heads)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    a = flash_attention_ref(q, k, v, bias, scale).permute(0, 2, 1, 3).reshape(B * T, inner)
    x1 = tfb.gemm_ref(a, (wo,), bo, x2, out_dtype=F32)
    f = tfb.gemm_ref(tfb.layer_norm_rows_ref(x1, n3w, n3b, cd), (w1,), b1, out_dtype=cd,
                     gelu="tanh")
    return tfb.gemm_ref(f, (w2,), b2, x1, out_dtype=cd).view(B, T, C)


# ---------------------------------------------------------------------------
# the chain of plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
def test_three_launch_chain_matches_pallas_and_seven_launch_chain(with_bias, dtype):
    rng = np.random.default_rng(10 + with_bias)
    B, T, C, heads, d, ff = 2, 16, 32, 2, 16, 64
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    W = _weights(rng, C, heads * d, ff)
    bias = None
    if with_bias:
        bias = np.zeros((B, T, T), np.float32)
        bias[1, :, -5:] = -1e10
    jd = jnp.float32 if dtype == F32 else jnp.bfloat16
    want_pallas = j_fused(jnp.asarray(x, jd), None if bias is None else jnp.asarray(bias, jd),
                          *(jnp.asarray(w, jd) for w in W), heads=heads, scale=d ** -0.5,
                          interpret=True)
    tx, tW = t(x).to(dtype), [t(w).to(dtype) for w in W]
    tb = None if bias is None else t(bias).to(dtype)
    got = tfb.fused_transformer_block_ref(tx, tb, *tW, heads=heads, scale=d ** -0.5)
    chain = _seven_launch_ref(tx, tb, tW, heads, d ** -0.5)
    assert got.dtype == dtype and got.shape == (B, T, C)
    if dtype == F32:
        assert_close(got, want_pallas, **TOL, name="vs pallas interpret")
        assert_close(got, chain, **TOL, name="vs the seven-launch chain")
    else:
        # the same rounding points; f32 sums in another order can move an
        # intermediate by one bf16 step, which reaches y as a few of its steps
        want = torch.from_numpy(np.array(want_pallas.astype(jnp.float32)))
        assert_close(got.float(), want, atol=6e-2, rtol=2e-2, name="vs pallas interpret")
        assert_close(got.float(), chain.float(), atol=6e-2, rtol=2e-2,
                     name="vs the seven-launch chain")
    # the CPU wrapper is the plain version
    assert torch.equal(tfb.fused_transformer_block(tx, tb, *tW, heads=heads, scale=d ** -0.5), got)


@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
def test_chain_of_kernel_plain_versions_in_their_split_order(with_bias):
    """The wrapper-level chain with each plain version in the split order
    its kernel would use (A's keys over 2 splits, B2 over 4 ranks) against
    the unsplit block: 2e-5."""
    rng = np.random.default_rng(20 + with_bias)
    B, T, C, heads, d, ff = 2, 24, 256, 4, 16, 128
    x = t(rng.standard_normal((B, T, C)).astype(np.float32))
    W = [t(w) for w in _weights(rng, C, heads * d, ff)]
    bias = None
    if with_bias:
        bias = torch.zeros((B, T, T))
        bias[0, :, -3:] = -1e10
    n1w, n1b, wq, wk, wv, wo, bo, n3w, n3b, w1, b1, w2, b2 = W
    x2 = x.reshape(B * T, C)
    qkv = tfb.ln_gemm_ref(x2, n1w, n1b, (wq, wk, wv)).view(B, T, 3, heads, d)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    a = flash_attention_ref(q, k, v, bias, d ** -0.5, kv_splits=2)
    a = a.permute(0, 2, 1, 3).reshape(B * T, heads * d)
    y = tfb.block_tail_ref(a, x2, wo, bo, n3w, n3b, w1, b1, w2, b2, ranks=4).view(B, T, C)
    assert_close(y, tfb.fused_transformer_block_ref(x, bias, *W, heads=heads, scale=d ** -0.5),
                 **TOL)


# ---------------------------------------------------------------------------
# the splits of the plain versions
# ---------------------------------------------------------------------------


def _tail_inputs(seed, M, C, inner, ff, dtype=F32):
    rng = np.random.default_rng(seed)
    W = _weights(rng, C, inner, ff)
    a = rng.standard_normal((M, inner)).astype(np.float32)
    x = rng.standard_normal((M, C)).astype(np.float32)
    # wo, bo, n3w, n3b, w1, b1, w2, b2
    tail = [W[i] for i in (5, 6, 7, 8, 9, 10, 11, 12)]
    return [t(v).to(dtype) for v in [a, x] + tail]


@pytest.mark.parametrize("ranks", [1, 4, 8])
@pytest.mark.parametrize("widths", [(32, 32, 64), (256, 512, 1024)], ids=["small", "estimator"])
def test_block_tail_ref_ranks_equal_the_unsplit_sum(widths, ranks):
    C, inner, ff = widths
    args = _tail_inputs(ranks, 19, C, inner, ff)
    a, x, wo, bo, n3w, n3b, w1, b1, w2, b2 = args
    # the unsplit sums, as the seven-launch chain's plain versions take them
    x1 = tfb.gemm_ref(a, (wo,), bo, x, out_dtype=F32)
    f = tfb.gemm_ref(tfb.layer_norm_rows_ref(x1, n3w, n3b, F32), (w1,), b1, gelu="tanh")
    want = tfb.gemm_ref(f, (w2,), b2, x1, out_dtype=F32)
    got = tfb.block_tail_ref(*args, ranks=ranks)
    assert_close(got, want, **TOL, name=f"ranks={ranks}")
    if ranks == 1:
        assert torch.equal(got, tfb.block_tail(*args))  # the CPU wrapper


@pytest.mark.parametrize("ranks", [4, 8])
def test_block_tail_ref_bf16_rounds_where_the_kernel_rounds(ranks):
    """bf16: h2 and f rounded to bf16, x1 and the sums f32, y rounded once;
    the split order moves y by at most one bf16 step."""
    args = _tail_inputs(ranks, 24, 256, 512, 1024, BF16)
    got = tfb.block_tail_ref(*args, ranks=ranks)
    one = tfb.block_tail_ref(*args, ranks=1)
    assert got.dtype == BF16
    step = 2.0 ** (torch.floor(torch.log2(one.float().abs().clamp(min=2 ** -20))) - 7)
    assert bool(((got.float() - one.float()).abs() <= step + 1e-6).all())


def test_block_tail_ref_refuses_ranks_that_do_not_divide():
    args = _tail_inputs(0, 4, 32, 32, 64)
    with pytest.raises(ValueError, match="ranks do not divide"):
        tfb.block_tail_ref(*args, ranks=3)


@pytest.mark.parametrize("rows", [1, 37, 64])
@pytest.mark.parametrize("x_dtype", [F32, BF16], ids=["x_f32", "x_bf16"])
def test_ln_gemm_ref_is_layer_norm_then_gemm(x_dtype, rows):
    """B1's plain version: LN (f32 statistics) rounded to the weights' type,
    then the product in f32."""
    rng = np.random.default_rng(rows)
    x = t(rng.standard_normal((rows, 256)).astype(np.float32)).to(x_dtype)
    w, b = (t(rng.standard_normal(256).astype(np.float32)).to(BF16) for _ in range(2))
    ws = [t(rng.standard_normal((24, 256)).astype(np.float32) * 0.05).to(BF16) for _ in range(3)]
    h = tfb.layer_norm_rows_ref(x, w, b, BF16)
    want = tfb.gemm_ref(h, ws, out_dtype=F32)
    got = tfb.ln_gemm_ref(x, w, b, ws, out_dtype=F32)
    assert torch.equal(got, want)
    assert tfb.ln_gemm(x, w, b, ws).dtype == BF16  # the CPU wrapper: the weights' type


# ---------------------------------------------------------------------------
# the plans and their shared memory
# ---------------------------------------------------------------------------

MAIN_ROWS = [312, 624, 2558, 5116]  # B*T at T = 156, 312, 1279, 2558


def test_tail_plans_are_the_kernels_instantiations():
    """_TAIL_PLANS names exactly the plans csrc/block_tail.cu instantiates,
    and the budget's limit is the source's."""
    src = (CSRC / "block_tail.cu").read_text()
    built = {tuple(int(v) for v in m) for m in
             re.findall(r"COSY_TAIL\((\d+), (\d+), (\d+)\)\n", src)}
    assert built == set(tfb._TAIL_PLANS)
    assert f"kSmemLimit = {tfb.SMEM_LIMIT};" in src
    assert f"kC = {tfb.TAIL_C};" in src


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("plan", tfb._TAIL_PLANS, ids=str)
def test_every_tail_plan_fits_shared_memory(plan, dtype):
    bm, cluster, sub = plan
    need = tfb._tail_smem_bytes(bm, cluster, sub, dtype)
    assert need <= tfb.SMEM_LIMIT
    # at least the two-stage ring of the stream's largest slice
    assert need >= (bm + tfb.TAIL_C) * 2 * 144 + bm * (tfb.TAIL_C + 4) * 4
    assert bm % 16 == 0 and cluster in (4, 8) and tfb.TAIL_C % (32 * cluster) == 0


# what the sweep on the card chose (PERF.md), spelt out
TAIL_PLANS = {312: (32, 8, 128), 624: (64, 8, 128), (2558, F32): (64, 8, 128),
              (2558, BF16): (64, 4, 128), 5116: (64, 4, 128)}


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M", MAIN_ROWS)
def test_tail_plan_on_the_main_path(M, dtype):
    bm, cluster, sub = tfb._tail_plan(M, 256, 512, 1024, dtype)
    assert (bm, cluster, sub) == TAIL_PLANS.get(M, TAIL_PLANS.get((M, dtype)))
    assert (bm, cluster, sub) in tfb._TAIL_PLANS
    assert 1024 % (cluster * sub) == 0 and 512 % (8 * cluster) == 0
    blocks = -(-M // bm) * cluster
    # one wave (a plan holds one block an SM) wherever a plan gives one;
    # past that f32 takes up to 2.5 waves of clusters of 8
    assert blocks <= _cuda.SMS or -(-M // 64) * 8 > _cuda.SMS
    if blocks > _cuda.SMS and cluster == 8:
        assert dtype == F32 and blocks <= 2.5 * _cuda.SMS


LN_GEMM_TILES = {(t_[0], t_[1]) for t_ in tfb._GEMM_TILES + tfb._GEMM_TILES_F32}


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M", MAIN_ROWS)
def test_ln_gemm_plan_on_the_main_path(M, dtype):
    bm, bn, cluster = tfb._ln_gemm_plan(M, 1536, 256, dtype)
    tiles = tfb._GEMM_TILES_F32 if dtype == F32 else tfb._GEMM_TILES
    assert (bm, bn) in [t_[:2] for t_ in tiles]  # an instantiation the kernel has
    # the blocks of a row tile share its LayerNorm: the cluster divides the
    # N tiles and deals the tile's rows out whole, and is as large as that allows
    n_tiles = -(-1536 // bn)
    assert cluster in (1, 2, 4, 8) and n_tiles % cluster == 0 and bm % cluster == 0
    assert cluster == 8 or n_tiles % (2 * cluster)
    assert tfb._ln_gemm_smem_bytes(bm, bn, 256, dtype) <= tfb.SMEM_LIMIT


LN_PLANS = {(312, F32): (64, 64, 8), (624, F32): (128, 64, 8), (5116, F32): (128, 64, 8),
            (312, BF16): (64, 64, 8), (624, BF16): (64, 64, 8), (2558, BF16): (128, 128, 4)}


@pytest.mark.parametrize("case", sorted(LN_PLANS, key=str), ids=str)
def test_ln_gemm_plan_choices(case):
    M, dtype = case
    assert tfb._ln_gemm_plan(M, 1536, 256, dtype) == LN_PLANS[case]


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("K", [64, 128, 192, 256])
def test_every_ln_gemm_tile_fits_shared_memory(K, dtype):
    tiles = tfb._GEMM_TILES_F32 if dtype == F32 else tfb._GEMM_TILES
    for bm, bn, _ in tiles:
        assert tfb._ln_gemm_smem_bytes(bm, bn, K, dtype) <= tfb.SMEM_LIMIT


# ---------------------------------------------------------------------------
# 3xTF32 through the tail
# ---------------------------------------------------------------------------


def _tail_np(a, x, W, ranks, mm):
    """The tail in numpy with every product through ``mm`` in the kernel's
    split order: out-projection partials over K ranges, FF hidden chunks,
    partial sums in rank order (f32); LayerNorm and GELU in f32."""
    wo, bo, n3w, n3b, w1, b1, w2, b2 = W
    kr, fr = a.shape[1] // ranks, w1.shape[0] // ranks
    s = np.zeros((a.shape[0], wo.shape[0]), np.float32)
    for r in range(ranks):
        s = s + mm(a[:, r * kr:(r + 1) * kr], np.ascontiguousarray(wo[:, r * kr:(r + 1) * kr].T))
    x1 = x + (s + bo)
    mu = x1.mean(-1, keepdims=True, dtype=np.float32)
    var = np.square(x1 - mu).mean(-1, keepdims=True, dtype=np.float32)
    h2 = ((x1 - mu) / np.sqrt(var + np.float32(1e-5)) * n3w + n3b).astype(np.float32)
    ff = np.zeros_like(s)
    for r in range(ranks):
        cols = slice(r * fr, (r + 1) * fr)
        f = mm(h2, np.ascontiguousarray(w1[cols].T)) + b1[cols]
        f = (0.5 * f * (1 + np.tanh(0.7978845608 * (f + 0.044715 * f ** 3)))).astype(np.float32)
        ff = ff + mm(f, np.ascontiguousarray(w2[:, cols].T))
    return x1 + (ff + b2)


@pytest.mark.parametrize("ranks", [4, 8])
def test_3xtf32_holds_the_tail_tolerance(ranks):
    """chip_smoke's tail inputs at the estimator's widths (inner 512, FF
    1024: out-projection chains of 128 / 64 a rank, FF1 256, FF2 256 / 128
    a rank): 3xTF32 is inside atol = rtol = 1e-4 of the f64 tail, single-pass
    TF32 is not."""
    rng = np.random.default_rng(ranks)
    W = [w.astype(np.float32) for w in _weights(rng, 256, 512, 1024)]
    tail = [W[i] for i in (5, 6, 7, 8, 9, 10, 11, 12)]
    a = rng.standard_normal((32, 512)).astype(np.float32)
    x = rng.standard_normal((32, 256)).astype(np.float32)
    want = _tail_np(a.astype(np.float64), x.astype(np.float64),
                    [w.astype(np.float64) for w in tail], ranks, lambda p, q: p @ q)
    assert _within(_tail_np(a, x, tail, ranks, lambda p, q: _matmul_tf32(p, q, 3)), want, 1e-4)
    assert not _within(_tail_np(a, x, tail, ranks, lambda p, q: _matmul_tf32(p, q, 1)), want,
                       1e-4)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def _ln_args(K=256, dtype=F32):
    return (torch.zeros((8, K), dtype=dtype), torch.zeros(K, dtype=dtype),
            torch.zeros(K, dtype=dtype), [torch.zeros((16, K), dtype=dtype) for _ in range(3)])


LN_REFUSALS = {
    "k_not_multiple_of_64": (lambda: _ln_args(K=96), ValueError),
    "k_over_256": (lambda: _ln_args(K=320), ValueError),
    "fp16": (lambda: _ln_args(dtype=torch.float16), TypeError),
    "bf16_x_f32_weights": (lambda: (torch.zeros((8, 256), dtype=BF16),) + _ln_args()[1:],
                           TypeError),
    "norm_weight_shape": (lambda: (_ln_args()[0], torch.zeros(128), torch.zeros(128),
                                   _ln_args()[3]), ValueError),
    "segment_rows_not_multiple_of_4": (lambda: _ln_args()[:3] + ([torch.zeros((6, 256))],),
                                       ValueError),
    "four_segments": (lambda: _ln_args()[:3] + ([torch.zeros((16, 256))] * 4,), ValueError),
    "misaligned_x": (lambda: (torch.zeros(8 * 256 + 1)[1:].view(8, 256),) + _ln_args()[1:],
                     ValueError),
    "non_contiguous_x": (lambda: (torch.zeros((256, 8)).t(),) + _ln_args()[1:], ValueError),
}


@pytest.mark.parametrize("case", sorted(LN_REFUSALS))
def test_ln_gemm_argument_checks(case):
    x, w, b, ws = _ln_args()
    assert tfb.check_ln_gemm_args(x, w, b, ws, F32) == tfb._ln_gemm_plan(8, 48, 256, F32)
    make, exc = LN_REFUSALS[case]
    n0 = tfb.ln_gemm.launches
    with pytest.raises(exc):
        tfb.check_ln_gemm_args(*make(), F32)
    assert tfb.ln_gemm.launches == n0


def _tail_args(M=8, C=256, inner=512, ff=1024, dtype=F32):
    shapes = [(M, inner), (M, C), (C, inner), (C,), (C,), (C,), (ff, C), (ff,), (C, ff), (C,)]
    return [torch.zeros(s, dtype=dtype) for s in shapes]


def _swap(i, v):
    args = _tail_args()
    args[i] = v
    return args


TAIL_REFUSALS = {
    "width_128": (lambda: _tail_args(C=128), ValueError),
    "fp16": (lambda: _tail_args(dtype=torch.float16), TypeError),
    "mixed_dtypes": (lambda: _swap(6, torch.zeros((1024, 256), dtype=BF16)), TypeError),
    "wo_shape": (lambda: _swap(2, torch.zeros((256, 256))), ValueError),
    "w2_shape": (lambda: _swap(8, torch.zeros((256, 512))), ValueError),
    "rows_of_a_and_x": (lambda: _swap(0, torch.zeros((9, 512))), ValueError),
    "inner_not_whole_chunks_a_rank": (lambda: _tail_args(inner=200), ValueError),
    "ff_not_whole_sub_tiles_a_rank": (lambda: _tail_args(ff=1000), ValueError),
    "misaligned_x": (lambda: _swap(1, torch.zeros(8 * 256 + 1)[1:].view(8, 256)), ValueError),
    "non_contiguous_w1": (lambda: _swap(6, torch.zeros((256, 1024)).t()), ValueError),
}


@pytest.mark.parametrize("case", sorted(TAIL_REFUSALS))
def test_block_tail_argument_checks(case):
    assert tfb.check_tail_args(*_tail_args()) == tfb._tail_plan(8, 256, 512, 1024, F32)
    make, exc = TAIL_REFUSALS[case]
    n0 = tfb.block_tail.launches
    with pytest.raises(exc):
        tfb.check_tail_args(*make())
    assert tfb.block_tail.launches == n0


@pytest.mark.parametrize("kernel", ["ln_gemm", "block_tail", "fused_transformer_block"])
def test_inputs_that_require_a_gradient_are_refused(kernel):
    if kernel == "ln_gemm":
        x, w, b, ws = _ln_args()
        call = lambda: tfb.ln_gemm(x.requires_grad_(True), w, b, ws)  # noqa: E731
    elif kernel == "block_tail":
        args = _tail_args()
        args[6].requires_grad_(True)
        call = lambda: tfb.block_tail(*args)  # noqa: E731
    else:
        rng = np.random.default_rng(0)
        W = [t(w) for w in _weights(rng, 32, 32, 64)]
        W[9].requires_grad_(True)
        call = lambda: tfb.fused_transformer_block(  # noqa: E731
            torch.zeros((1, 4, 32)), None, *W, heads=2, scale=0.25)
    counts = ops.launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    assert ops.launch_counts() == counts


def test_meta_tensors_never_reach_the_plain_versions(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("plain version reached")

    for name in ("ln_gemm_ref", "block_tail_ref"):
        monkeypatch.setattr(tfb, name, boom)
    x, w, b, ws = (v if isinstance(v, list) else v.to("meta") for v in _ln_args())
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfb.ln_gemm(x, w, b, [v.to("meta") for v in ws])
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfb.block_tail(*(v.to("meta") for v in _tail_args()))


def test_launch_counts_name_the_three_launches_of_a_block():
    counts = ops.launch_counts()
    assert {"fused_transformer_block", "ln_gemm", "flash_attention", "block_tail",
            "layer_norm_rows", "gemm", "banded_attention"} == set(counts)
    tfb.ln_gemm.launches, tfb.block_tail.launches = 3, 4
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# exact (erf) GELU: the estimator's gelu_approximate=False
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
def test_erf_chain_matches_pallas(with_bias):
    """The chain of plain versions with B2's erf GELU against the Pallas
    kernel's gelu_approximate=False in interpret mode: 2e-5."""
    rng = np.random.default_rng(30 + with_bias)
    B, T, C, heads, d, ff = 2, 16, 32, 2, 16, 64
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    W = _weights(rng, C, heads * d, ff)
    bias = None
    if with_bias:
        bias = np.zeros((B, T, T), np.float32)
        bias[0, :, -4:] = -1e10
    want = j_fused(jnp.asarray(x), None if bias is None else jnp.asarray(bias),
                   *(jnp.asarray(w) for w in W), heads=heads, scale=d ** -0.5,
                   gelu_approximate=False, interpret=True)
    tb = None if bias is None else t(bias)
    got = tfb.fused_transformer_block(t(x), tb, *(t(w) for w in W), heads=heads,
                                      scale=d ** -0.5, gelu_approximate=False)
    assert_close(got, want, **TOL)
    tanh = tfb.fused_transformer_block_ref(t(x), tb, *(t(w) for w in W), heads=heads,
                                           scale=d ** -0.5)
    assert not torch.equal(got, tanh)  # the two GELUs differ


@pytest.mark.parametrize("ranks", [1, 8])
def test_block_tail_ref_erf_ranks_equal_the_unsplit_sum(ranks):
    args = _tail_inputs(40 + ranks, 19, 256, 512, 1024)
    a, x, wo, bo, n3w, n3b, w1, b1, w2, b2 = args
    x1 = tfb.gemm_ref(a, (wo,), bo, x, out_dtype=F32)
    f = tfb.gemm_ref(tfb.layer_norm_rows_ref(x1, n3w, n3b, F32), (w1,), b1, gelu="erf")
    want = tfb.gemm_ref(f, (w2,), b2, x1, out_dtype=F32)
    got = tfb.block_tail_ref(*args, gelu="erf", ranks=ranks)
    assert_close(got, want, **TOL)
    if ranks == 1:
        assert torch.equal(got, tfb.block_tail(*args, gelu="erf"))  # the CPU wrapper


def test_gelu_codes_are_the_kernels_act_codes():
    """``_GELU_CODE`` against ``enum Act`` of csrc/mma.cuh, and the C
    entries' checks of the codes they take."""
    src = (CSRC / "mma.cuh").read_text()
    enum = dict((name, int(v)) for name, v in
                re.findall(r"(k\w+) = (\d+)", re.search(r"enum Act[^}]*}", src).group(0)))
    assert enum == {"kNone": 0, "kGeluTanh": 1, "kGeluErf": 2}
    assert tfb._GELU_CODE == {None: 0, "tanh": 1, "erf": 2}
    assert "erff(v * 0.70710678f)" in src
    tail = (CSRC / "block_tail.cu").read_text()
    assert "(act != kGeluTanh && act != kGeluErf)" in tail
    assert "kGeluTanh)" not in tail.split("block_tail_kernel(const TailArgs p)")[1]
    assert "act > kGeluErf" in (CSRC / "fused_block.cu").read_text()


@pytest.mark.parametrize("gelu", [None, "sigmoid", "none"])
def test_block_tail_refuses_a_gelu_the_kernels_lack(gelu):
    counts = ops.launch_counts()
    with pytest.raises(ValueError, match="'tanh' or 'erf'"):
        tfb.block_tail(*_tail_args(), gelu=gelu)
    with pytest.raises(ValueError, match="gelu None, 'tanh' or 'erf'"):
        tfb.check_gemm_args(torch.zeros(8, 64), [torch.zeros(8, 64)], None, None, F32, "none")
    assert ops.launch_counts() == counts


@pytest.fixture(scope="module")
def erf_flow():
    import dataclasses

    from cosy_tpu.config import tiny_model_config as j_tiny
    from cosy_tpu_torch.models import flow as TF
    from test_torch_common import port_config, port_init, torch_params

    jcfg = j_tiny().flow
    est = dataclasses.replace(jcfg.estimator, gelu_approximate=False)
    params = port_init(TF.init_flow_params, jcfg)
    return est, {k: jnp.asarray(v) for k, v in params.items()}, torch_params(params), \
        port_config(est)


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
def test_erf_estimator_matches_jax(erf_flow, masked):
    """The estimator with ``gelu_approximate=False`` (exact GELU in every
    transformer block) against JAX ``conditional_decoder``: 2e-4."""
    from cosy_tpu.ctx import EVAL
    from cosy_tpu.layers.unet import conditional_decoder as j_decoder
    from cosy_tpu.params import P as JP
    from cosy_tpu_torch.layers.unet import conditional_decoder as t_decoder

    jest, jp, tp, test = erf_flow
    assert not test.gelu_approximate
    rng = np.random.default_rng(50 + masked)
    B, T = 2, 24
    x, mu, cond = (rng.standard_normal((B, 80, T)).astype(np.float32) for _ in range(3))
    spks = rng.standard_normal((B, 80)).astype(np.float32)
    tt = rng.uniform(size=(B,)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((B, 1, T), np.float32)
        mask[1, :, 19:] = 0.0
    want = jax.jit(lambda p, x, m, *a: j_decoder(JP(p).sub("decoder.estimator"), jest, x, m,
                                                 *a, EVAL))(
        jp, jnp.asarray(x), None if mask is None else jnp.asarray(mask), jnp.asarray(mu),
        jnp.asarray(tt), jnp.asarray(spks), jnp.asarray(cond))
    got = t_decoder(tp.sub("decoder.estimator"), test, t(x), None if mask is None else t(mask),
                    t(mu), t(tt), t(spks), t(cond))
    assert_close(got, np.asarray(want), atol=2e-4, rtol=2e-4)


# ---------------------------------------------------------------------------
# the early refusal of widths the kernels are not built for
# ---------------------------------------------------------------------------


def _widths_message():
    return re.escape(tfb.KERNEL_WIDTHS)


@pytest.mark.parametrize("device", ["cuda", "cuda:0", "cpu"])
@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "full"])
def test_kernel_widths_are_required_on_cuda_only(tiny, device):
    from cosy_tpu_torch.config import ModelConfig, tiny_model_config

    est = (tiny_model_config() if tiny else ModelConfig()).flow.estimator
    if tiny and device != "cpu":
        with pytest.raises(ValueError, match=_widths_message()):
            tfb.require_kernel_widths(est, device)
    else:
        tfb.require_kernel_widths(est, device)
    assert tfb.KERNEL_WIDTHS == "channels 256 at every level, 8 heads x 64, FF 4 x 256"


def test_infer_cli_refuses_tiny_on_cuda_before_any_weight(monkeypatch, tmp_path):
    """``--tiny --device cuda`` exits with the one message, before a weight
    is built or the device resolved (so it shows without a card)."""
    from cosy_tpu_torch.infer import __main__ as cli

    def boom(*a, **kw):
        raise AssertionError("weights were built")

    monkeypatch.setattr(cli, "load_models", boom)
    with pytest.raises(SystemExit) as exc:
        cli.main(["--text", "ab", "--tiny", "--device", "cuda", "--output",
                  str(tmp_path / "x.wav")])
    assert tfb.KERNEL_WIDTHS in str(exc.value.code)


def test_pipeline_refuses_a_tiny_estimator_on_cuda():
    """``TTSPipeline`` construction checks the widths on its modules' device
    first (a stand-in module reports a CUDA device; no card is needed)."""
    from types import SimpleNamespace

    from cosy_tpu_torch.config import tiny_model_config
    from cosy_tpu_torch.infer.pipeline import TTSPipeline

    class OnCuda:
        def parameters(self):
            yield SimpleNamespace(device=torch.device("cuda"))

    with pytest.raises(ValueError, match=_widths_message()):
        TTSPipeline(tiny_model_config(), None, OnCuda(), None)
