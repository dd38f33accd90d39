"""Kernel B as three launches (B1 ``ln_gemm``, A, B2 ``block_tail``): what a
CPU run can hold of it.

- the chain of plain versions ``ln_gemm_ref -> flash_attention_ref ->
  block_tail_ref`` against the JAX package's Pallas kernel in interpret
  mode and against the seven-launch chain of plain LayerNorm and GEMM
  versions it replaced, with and without a (B, T, T) bias: 2e-5 in f32, one
  bf16 rounding step in bf16;
- the tail's split in its plain version (the FF hidden over the 1, 2, 4
  and 8 ranks of B2's plans, the partials summed in rank order; the
  out-projection unsplit) against the unsplit sums, 2e-5, on rows whose x1
  lies far from zero mean or holds an outlier;
- the plans (``_ln_gemm_plan``, ``_tail_plan``) at the main path's shapes,
  the tiles and plans ``csrc/ln_gemm.cu`` and ``csrc/block_tail.cu``
  dispatch (B1 without a cluster; B2's R = 1 plan without one, and no pull
  read of a peer's memory), and the shared-memory budget of every plan the
  kernels have against the 227 KB a block may use;
- a numpy emulation of B1's arithmetic (statistics merged by Chan's rule
  slice by slice and across the quad, the operand normalised by two fused
  multiply-adds, 3xTF32 with the kernel's split rules and per-slice partial
  sums, or bf16) at 312 x 256 x 1536, with rows far from zero mean and rows
  with an outlier in column 0: inside ``ln_gemm_ref``'s tolerances and,
  through the plain chain, the Pallas kernel's;
- a numpy emulation of 3xTF32 (mantissa cut to 10 bits, three products, f32
  sums in the tail kernel's order: the out-projection's chains of 256 of K,
  LN3's statistics by Chan's rule, the FF partials in rank order) through
  the whole tail at the estimator's widths for every R of B2's plans:
  inside the f32 tolerance where single-pass TF32 is not;
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
from test_torch_kernel_plans import _matmul_tf32, _tf32, _within
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


def _tail_x(rng, M, C):
    """The tail's x: every fifth row shifted to a mean of 12 and every
    seventh to -20, so that their x1 sits at |mean| / std of ~10-30, and every
    eleventh with 40 added to column 7 (a cancelling LN3, or statistics
    shifted by one of the row's values, would show there)."""
    x = rng.standard_normal((M, C)).astype(np.float32)
    x[::5] = x[::5] * 0.5 + 12.0
    x[1::7] = x[1::7] * 0.4 - 20.0
    x[3::11, 7] += 40.0
    return x


def _tail_inputs(seed, M, C, inner, ff, dtype=F32):
    rng = np.random.default_rng(seed)
    W = _weights(rng, C, inner, ff)
    a = rng.standard_normal((M, inner)).astype(np.float32)
    x = _tail_x(rng, M, C)
    # wo, bo, n3w, n3b, w1, b1, w2, b2
    tail = [W[i] for i in (5, 6, 7, 8, 9, 10, 11, 12)]
    return [t(v).to(dtype) for v in [a, x] + tail]


TAIL_RANKS = sorted({plan[1] for plan in tfb._TAIL_PLANS})  # 1, 2, 4, 8, 16


@pytest.mark.parametrize("ranks", TAIL_RANKS)
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


@pytest.mark.parametrize("ranks", TAIL_RANKS[1:])
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
    """_TAIL_PLANS names exactly the plans csrc/block_tail.cu dispatches,
    the budget's constants are the source's, and the kernel is the Hopper
    one: products on wgmma from TMA stages, no mma.sync and no cp.async
    ring, exchanges by pushes that complete on the receiver's mbarrier (no
    pull read of a peer's memory, no cluster.sync()), and a launch that
    sets the cluster attribute only for R > 1."""
    src = (CSRC / "block_tail.cu").read_text()
    dispatch = src[src.index("cudaError_t dispatch_tail("):src.index("#undef COSY_TAIL")]
    built = {tuple(int(v) for v in m) for m in
             re.findall(r"COSY_TAIL\((\d+), (\d+), (\d+)\)\n", dispatch)}
    assert built == set(tfb._TAIL_PLANS)
    for const in (f"kSmemLimit = {tfb.SMEM_LIMIT};", f"kC = {tfb.TAIL_C};", "kBM = 64;",
                  "kFS = 128;", "kFH = 64;", f"kWRows = {tfb._TAIL_W_ROWS};",
                  "e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);",
                  f"kSlice = {tfb._LN_SLICE};",
                  "kStages = kF32 ? {} : {};".format(tfb._TAIL_STAGES[F32],
                                                      tfb._TAIL_STAGES[BF16])):
        assert const in src
    assert {bm for bm, _, _ in tfb._TAIL_PLANS} == {64}
    assert all(sub == (64 if cluster == 16 else 128) for _, cluster, sub in tfb._TAIL_PLANS)
    launch = src[src.index("cudaError_t launch_tail("):src.index("cudaError_t dispatch_tail(")]
    assert src.count("cudaLaunchAttributeClusterDimension") == 1
    gated = launch[launch.index("if constexpr (R > 1) {  // R = 1: no cluster attribute"):]
    assert "cudaLaunchAttributeClusterDimension" in gated[:gated.index("}")]
    for gone in ("mma.sync", "slice_product", "stream_slices", "cp_async", "cluster.sync",
                 "map_shared_rank", "cooperative_groups", "Mma<"):
        assert gone not in src
    for used in ("Wgmma<T, ", "TmaRing<", "tma_load_2d(", "bulk_push(", "mbar_arrive_remote(",
                 "mbar_wait_cluster(", "fence_proxy_async()"):
        assert used in src
    wg = (CSRC / "wgmma.cuh").read_text()
    assert "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes" in wg
    assert "mbarrier.arrive.release.cluster.shared::cluster" in wg


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("plan", tfb._TAIL_PLANS, ids=str)
def test_every_tail_plan_fits_shared_memory(plan, dtype):
    bm, cluster, sub = plan
    need = tfb._tail_smem_bytes(bm, dtype)
    assert need <= tfb.SMEM_LIMIT
    # at least the ring, the f32 x1 tile and the f32 FF2 sum of its shape
    # (the pushed FF2 partials go out of the sum and land in the other
    # ranks' x1 columns: whole 128-byte slices of 32 f32 columns a rank)
    ring = tfb._TAIL_STAGES[dtype] * tfb._TAIL_W_ROWS * 128 * (2 if dtype == F32 else 1)
    x1 = bm * tfb.TAIL_C * 4
    assert need >= ring + 2 * x1
    # a stage holds a's 64 rows, and every W item (64 rows, and its lo)
    assert tfb._TAIL_W_ROWS == bm
    assert bm == 64 and sub == (64 if cluster == 16 else 128) and cluster in (1, 2, 4, 8, 16)
    assert tfb.TAIL_C % (32 * min(cluster, 8)) == 0  # chunks of whole 32-column slices


# what the sweep on the card chose (PERF.md), spelt out
TAIL_PLANS = {150: (64, 16, 64), 156: (64, 16, 64), 312: (64, 16, 64), 440: (64, 16, 64),
              500: (64, 8, 128), 624: (64, 8, 128),
              (2558, F32): (64, 8, 128), (2558, BF16): (64, 2, 128),
              (5116, F32): (64, 4, 128), (5116, BF16): (64, 1, 128)}


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M", [150, 156, 440, 500] + MAIN_ROWS)
def test_tail_plan_on_the_main_path(M, dtype):
    bm, cluster, sub = tfb._tail_plan(M, 256, 512, 1024, dtype)
    assert (bm, cluster, sub) == TAIL_PLANS.get(M, TAIL_PLANS.get((M, dtype)))
    assert (bm, cluster, sub) in tfb._TAIL_PLANS
    assert 1024 % (cluster * sub) == 0 and 512 % 128 == 0
    blocks = -(-M // bm) * cluster
    # bf16: a split in one wave where row tiles alone leave SMs idle, none
    # at 5116 rows (80 row tiles: no cluster, no exchange); f32's 3xTF32
    # products take more blocks, up to 2.5 waves
    tiles = -(-M // 64)
    assert blocks <= (_cuda.SMS if dtype == BF16 else 2.5 * _cuda.SMS)
    assert (cluster == 1) == (dtype == BF16 and tiles * 2 > _cuda.SMS)


B1_ROWS = [150, 156, 312, 624, 2558, 5116]  # CosyVoice2's and MeanFlow's T/2 levels, MAIN_ROWS


def test_ln_gemm_tiles_are_the_kernels_instantiations():
    """_LN_GEMM_TILES names exactly the tiles csrc/ln_gemm.cu dispatches,
    the budget's constants are the source's, and B1 has no cluster: no
    launch attribute, no cluster barrier, no distributed shared memory; the
    GEMM kernel keeps no LayerNorm branch."""
    src = (CSRC / "ln_gemm.cu").read_text()
    dispatch = src[src.index("cudaError_t dispatch("):src.index("bool valid_dtype")]
    built = {(64, int(v)) for v in re.findall(r"launch<T, TX, (\d+)>", dispatch)}
    assert set(tfb._LN_GEMM_TILES[F32]) == set(tfb._LN_GEMM_TILES[BF16]) == built
    assert "if (block_m != 64) return cudaErrorInvalidValue;" in dispatch
    for const in (f"kSmemLimit = {tfb.SMEM_LIMIT};", f"kStages = {tfb._LN_STAGES};",
                  f"kSlice = {tfb._LN_SLICE};", f"kLnMaxK = {tfb.LN_MAX_K};"):
        assert const in src
    for what in ("cudaLaunchAttributeClusterDimension", "cluster.sync", "map_shared_rank"):
        assert what not in src
    assert "wgmma.mma_async" in (CSRC / "wgmma.cuh").read_text()
    gemm_src = (CSRC / "fused_block.cu").read_text()
    assert "bool kLn" not in gemm_src and "ln_stats" not in gemm_src
    assert "cosy_ln_gemm" not in gemm_src and "cosy_ln_gemm" in src


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M", B1_ROWS)
def test_ln_gemm_plan_on_the_main_path(M, dtype):
    plan = tfb._ln_gemm_plan(M, 1536, 256, dtype)
    assert plan in tfb._LN_GEMM_TILES[dtype]  # an instantiation the kernel has
    bm, bn = plan
    # a tile never ends past its 512-row weight segment: y goes out by TMA
    assert 512 % bn == 0
    # 64x64 tiles while their grid fits the SMs in one wave, else 64x128
    assert (bn == 64) == (-(-M // 64) * (1536 // 64) <= _cuda.SMS)
    for x_dtype in (dtype, F32):
        assert tfb._ln_gemm_smem_bytes(bm, bn, 256, dtype, x_dtype) <= tfb.SMEM_LIMIT


# what the sweep on the card chose (PERF.md), spelt out
LN_PLANS = {(M, dt): (64, 64) if M <= 312 else (64, 128) for M in B1_ROWS for dt in (F32, BF16)}


@pytest.mark.parametrize("case", sorted(LN_PLANS, key=str), ids=str)
def test_ln_gemm_plan_choices(case):
    M, dtype = case
    assert tfb._ln_gemm_plan(M, 1536, 256, dtype) == LN_PLANS[case]


@pytest.mark.parametrize("x_dtype", [None, F32], ids=["x_weights", "x_f32"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("K", [64, 128, 192, 256])
def test_every_ln_gemm_tile_fits_shared_memory(K, dtype, x_dtype):
    es, xs = (torch.finfo(d).bits // 8 for d in (dtype, x_dtype or dtype))
    for bm, bn in tfb._LN_GEMM_TILES[dtype]:
        need = tfb._ln_gemm_smem_bytes(bm, bn, K, dtype, x_dtype)
        assert need <= tfb.SMEM_LIMIT
        # at least the ring (a hi and, f32, a lo slice a stage) and the x tile
        ring = tfb._LN_STAGES * bn * tfb._LN_SLICE * (2 if es == 4 else 1)
        assert need >= ring + bm * K * xs
        # the epilogue stages the 64 x bn y tile (f32 at most) in the ring
        assert 64 * bn * 4 <= ring


# ---------------------------------------------------------------------------
# B1's arithmetic in numpy
# ---------------------------------------------------------------------------


def _rna_tf32(x):
    """cvt.rna.tf32.f32: x rounded to TF32's 10 mantissa bits, ties away
    from zero (the low 13 bits of the f32 word then zero)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF16).float().numpy()


def _chan_stats(x, tx):
    """Each row's (mean, M2 = sum (x - mean)^2) as csrc/ln_gemm.cu takes
    them, in f32: thread t of a row's quad holds, in x slice j (128 bytes),
    the values at 32 j + 4 c + t (f32 x) or 64 j + 8 c + 2 t + e (bf16 x);
    it sums them about their own mean and merges them into its running
    (mean, M2) by Chan's rule, then the quad merges in two shuffles (lanes
    t ^ 1, then t ^ 2), each side holding n values."""
    f32 = np.float32
    M, K = x.shape
    if tx == F32:
        v = x.reshape(M, K // 32, 8, 4).transpose(0, 1, 3, 2)
    else:
        v = x.reshape(M, K // 64, 8, 4, 2).transpose(0, 1, 3, 2, 4).reshape(M, K // 64, 4, 16)
    vps = v.shape[-1]
    m = np.zeros((M, 4), f32)
    m2 = np.zeros((M, 4), f32)
    for j in range(v.shape[1]):
        blk = v[:, j]
        s = np.zeros((M, 4), f32)
        for e in range(vps):
            s = s + blk[..., e]
        bm = s * f32(1.0 / vps)
        q = np.zeros((M, 4), f32)
        for e in range(vps):
            d = blk[..., e] - bm
            q = _fma(d, d, q)
        share = f32(1.0) / f32(j + 1)
        d = bm - m
        m = _fma(d, share, m)
        m2 = m2 + _fma(d * d, f32(vps * j) * share, q)
    n = f32(K // 4)
    for lanes in (1, 2):
        om, om2 = m[:, np.arange(4) ^ lanes], m2[:, np.arange(4) ^ lanes]
        d = om - m
        m = f32(0.5) * (m + om)
        m2 = _fma(d * d, f32(0.5) * n, m2 + om2)
        n = n * f32(2)
    assert (m == m[:, :1]).all() and (m2 == m2[:, :1]).all()  # the lanes agree
    return m[:, :1], m2[:, :1]


def _fma(a, b, c):
    """fmaf in f32: the product exact in f64, one rounding of the sum."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def _ln_gemm_kernel_np(x, w, b, W, dtype, passes=3, eps=1e-5):
    """y = LN(x) W^T as csrc/ln_gemm.cu computes it, in numpy: the row
    statistics in f32 merged by Chan's rule (``_chan_stats``), rstd =
    1 / sqrt(M2 / K + eps); h = fma(fma(x, rstd, -mean rstd), w, b), each
    fused multiply-add rounded once to f32.  bf16: h rounded to bf16, the
    product in f32, y rounded to bf16.  f32: 3xTF32 over K slices of 32
    values: A split hi = rna(h), lo = h - hi read as its top 19 bits; W
    split by truncation, hi and lo = W - hi; a slice's a_lo W_hi + a_hi
    W_lo + a_hi W_hi summed in f32 and added to the running sum
    (``passes=1``: a_hi W_hi alone, single-pass TF32)."""
    x = np.asarray(x, np.float32)
    K = x.shape[1]
    mean, m2 = _chan_stats(x, dtype)
    rstd = (1.0 / np.sqrt(m2 / np.float32(K) + np.float32(eps))).astype(np.float32)
    shift = (-mean * rstd).astype(np.float32)
    h = _fma(_fma(x, rstd, shift), w, b)
    if dtype == BF16:
        return _bf16(h @ np.asarray(W, np.float32).T)
    a_hi = _rna_tf32(h)
    a_lo = _tf32(h - a_hi)
    w_hi = _tf32(W)
    w_lo = _tf32(W - w_hi)
    acc = np.zeros((x.shape[0], W.shape[0]), np.float32)
    for k0 in range(0, K, 32):
        k = slice(k0, k0 + 32)
        part = a_hi[:, k] @ w_hi[:, k].T
        if passes == 3:
            part = (a_lo[:, k] @ w_hi[:, k].T + a_hi[:, k] @ w_lo[:, k].T) + part
        acc = acc + part
    return acc


def _b1_inputs(seed, dtype, M=312, C=256, N=1536):
    """x (M, C) with every fifth row at |mean| / std = 24, every seventh
    at 30 and every eleventh with 50 std added to its column 0
    (cancellation, or statistics shifted by one of the row's values, would
    show there), the norm near 1, W ~0.05: numpy f32 rounded to
    ``dtype``'s values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, C)).astype(np.float32)
    x[::5] = x[::5] * 0.5 + 12.0
    x[1::7] = x[1::7] * 0.4 - 12.0
    x[3::11, 0] += 50.0
    w = (rng.standard_normal(C) * 0.05 + 1.0).astype(np.float32)
    b = (rng.standard_normal(C) * 0.05).astype(np.float32)
    W = (rng.standard_normal((N, C)) * 0.05).astype(np.float32)
    if dtype == BF16:
        x, w, b, W = (_bf16(a) for a in (x, w, b, W))
    return x, w, b, W


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_ln_gemm_kernel_arithmetic_holds_the_tolerance(dtype):
    """B1's arithmetic at the main path's 312 x 256 x 1536 against
    ``ln_gemm_ref`` at chip_smoke's tolerances (f32 1e-4, bf16 1e-2), with
    rows far from zero mean and rows with an outlier in column 0; f32
    single-pass TF32 does not hold it."""
    x, w, b, W = _b1_inputs(15, dtype)
    tol = 1e-4 if dtype == F32 else 1e-2
    want = tfb.ln_gemm_ref(*(t(a).to(dtype) for a in (x, w, b)), (t(W).to(dtype),),
                           out_dtype=F32).numpy()
    got = _ln_gemm_kernel_np(x, w, b, W, dtype)
    assert _within(got, want, tol)
    if dtype == F32:
        assert not _within(_ln_gemm_kernel_np(x, w, b, W, dtype, passes=1), want, tol)
        # and the statistics match f64's closely at |mean| / std = 30 and
        # beside a 50 std outlier
        f64 = x.astype(np.float64)
        h64 = (f64 - f64.mean(-1, keepdims=True)) / np.sqrt(f64.var(-1, keepdims=True) + 1e-5)
        assert _within(_ln_gemm_kernel_np(x, np.ones_like(w), np.zeros_like(b),
                                          np.eye(256, dtype=np.float32), dtype), h64, 1e-5)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_ln_gemm_kernel_arithmetic_in_the_block_matches_pallas(dtype):
    """The block at the estimator's widths (B = 2, T = 156: 312 rows, 8 x
    64 heads, FF 1024, a (B, T, T) bias) with B1 taken as the kernel's
    arithmetic and A, B2 as their plain versions, against the JAX
    package's Pallas kernel in interpret mode: the tolerances of the
    three-launch chain test."""
    x, *_ = _b1_inputs(16, F32)
    B, T, C, heads, d, ff = 2, 156, 256, 8, 64, 1024
    rng = np.random.default_rng(17)
    W = _weights(rng, C, heads * d, ff)
    bias = np.zeros((B, T, T), np.float32)
    bias[1, :, -9:] = -1e10
    jd = jnp.float32 if dtype == F32 else jnp.bfloat16
    want = j_fused(jnp.asarray(x.reshape(B, T, C), jd), jnp.asarray(bias, jd),
                   *(jnp.asarray(v, jd) for v in W), heads=heads, scale=d ** -0.5,
                   interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))

    def kernel_b1(x2, n1w, n1b, ws):
        Wc = torch.cat([v.float() for v in ws]).numpy()
        y = _ln_gemm_kernel_np(x2.float().numpy(), n1w.float().numpy(), n1b.float().numpy(),
                               Wc, dtype)
        return torch.from_numpy(y).to(dtype)

    def attend(q, k, v, bias_, scale):
        return flash_attention_ref(q, k, v, bias_, scale).permute(0, 2, 1, 3)

    tx, tW = t(x.reshape(B, T, C)).to(dtype), [t(v).to(dtype) for v in W]
    got = tfb._block(tx, t(bias).to(dtype), *tW, heads, d ** -0.5, kernel_b1, attend,
                     tfb.block_tail_ref)
    if dtype == F32:
        assert_close(got, want, **TOL, name="B1 arithmetic vs pallas interpret")
    else:
        assert_close(got.float(), want, atol=6e-2, rtol=2e-2,
                     name="B1 arithmetic vs pallas interpret")


# ---------------------------------------------------------------------------
# 3xTF32 through the tail
# ---------------------------------------------------------------------------


def _tail_np(a, x, W, ranks, mm):
    """The tail in numpy in the kernel's order of summation, every product
    through ``mm``: the out-projection unsplit over the ranks, its chains of
    256 of K summed in f32 (the kernel promotes them into its x1 tile), x1
    = x + (s + bo); LN3 as the kernel takes it in f32 (``_chan_stats``, two
    fused multiply-adds; in f64 the plain two-pass form); the FF hidden in
    ``ranks`` chunks, each chunk's FF2 product summed over its sub-tiles of
    64 hidden columns in f32 (the kernel's FF2 sum in shared memory), the
    partials summed in rank order; GELU in f32; y = x1 + (ff + b2)."""
    wo, bo, n3w, n3b, w1, b1, w2, b2 = W
    s = np.zeros((a.shape[0], wo.shape[0]), a.dtype)
    for k0 in range(0, a.shape[1], 256):
        k = slice(k0, k0 + 256)
        s = s + mm(a[:, k], np.ascontiguousarray(wo[:, k].T))
    x1 = x + (s + bo)
    if x1.dtype == np.float64:
        mu = x1.mean(-1, keepdims=True)
        h2 = (x1 - mu) / np.sqrt(np.square(x1 - mu).mean(-1, keepdims=True) + 1e-5) * n3w + n3b
    else:
        mean, m2 = _chan_stats(x1, F32)
        rstd = (1.0 / np.sqrt(m2 / np.float32(x1.shape[1]) + np.float32(1e-5))).astype(np.float32)
        h2 = _fma(_fma(x1, rstd, (-mean * rstd).astype(np.float32)), n3w, n3b)
    fr = w1.shape[0] // ranks
    ff = np.zeros_like(s)
    for r in range(ranks):
        cols = slice(r * fr, (r + 1) * fr)
        f = mm(h2, np.ascontiguousarray(w1[cols].T)) + b1[cols]
        f = (0.5 * f * (1 + np.tanh(0.7978845608 * (f + 0.044715 * f ** 3)))).astype(f.dtype)
        part = np.zeros_like(s)
        for j0 in range(0, fr, 64):
            sub = slice(r * fr + j0, r * fr + j0 + 64)
            part = part + mm(f[:, j0:j0 + 64], np.ascontiguousarray(w2[:, sub].T))
        ff = ff + part
    return x1 + (ff + b2)


@pytest.mark.parametrize("ranks", TAIL_RANKS)
def test_3xtf32_holds_the_tail_tolerance(ranks):
    """chip_smoke's tail inputs at the estimator's widths (inner 512, FF
    1024: out-projection chains of 256, FF1 256, FF2 64 a sub-tile) on a
    64-row tile with rows of x1 at |mean| / std ~10-30 and an outlier
    column: 3xTF32 is inside atol = rtol = 1e-4 of the f64 tail, single-pass
    TF32 is not.  The emulation rounds each product's sum once to f32; it
    does not model the tensor cores' truncation as they add into their
    accumulator: that the chains of 256 hold the tolerance is the card's to
    show (chip_smoke's B2 cases)."""
    rng = np.random.default_rng(ranks)
    W = [w.astype(np.float32) for w in _weights(rng, 256, 512, 1024)]
    tail = [W[i] for i in (5, 6, 7, 8, 9, 10, 11, 12)]
    a = rng.standard_normal((64, 512)).astype(np.float32)
    x = _tail_x(rng, 64, 256)
    want = _tail_np(a.astype(np.float64), x.astype(np.float64),
                    [w.astype(np.float64) for w in tail], ranks, lambda p, q: p @ q)
    assert _within(_tail_np(a, x, tail, ranks, lambda p, q: _matmul_tf32(p, q, 3)), want, 1e-4)
    assert not _within(_tail_np(a, x, tail, ranks, lambda p, q: _matmul_tf32(p, q, 1)), want,
                       1e-4)
    # and block_tail_ref with the plan's ranks agrees with the f64 tail
    ref = tfb.block_tail_ref(*(t(v) for v in [a, x] + tail), ranks=ranks).numpy()
    assert _within(ref, want, 1e-4)


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


@pytest.mark.parametrize("ranks", TAIL_RANKS)
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
    assert "kGeluTanh)" not in tail.split("block_tail_kernel(const __grid_constant__ TailArgs p)")[1]
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
