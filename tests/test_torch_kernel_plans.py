"""What the tensor-core kernels of the port add and a CPU run can hold:

- the split-key combine of the attention plain versions (``kv_splits``)
  against the unsplit ones and against the JAX package's Pallas kernels in
  interpret mode, 2e-5;
- ``gemm_ref(split_k=n)`` against ``gemm_ref()``, 2e-5, with every epilogue;
- the plans (``_gemm_plan``, ``_attention_plan``) at the main path's shapes:
  what the kernels require of them and the grids they give; the attention
  plans against what ``csrc/flash_attention.cu`` launches and against the
  shared memory of a block (``_attention_smem_bytes``);
- a numpy emulation of error-compensated 3xTF32 (mantissa cut to 10 bits,
  three products, f32 sum) against f64: inside the kernels' f32 tolerances
  where single-pass TF32 is not;
- the wrappers' refusals of what 16-byte copies cannot take.

The kernels themselves run only on the card, where ``chip_smoke.py`` holds
them against these plain versions."""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cosy_tpu.ops import flash_attention as jfa
from cosy_tpu_torch.ops import _cuda
from cosy_tpu_torch.ops import flash_attention as tfa
from cosy_tpu_torch.ops import fused_block as tfb
from test_torch_common import assert_close, t
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=2e-5, rtol=2e-5)
SPLITS = [1, 2, 3, 7]
CSRC = Path(tfa.__file__).resolve().parent.parent / "csrc"
F32, BF16 = torch.float32, torch.bfloat16


def _qkv(seed, B, H, T, S, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, T, d), (B, H, S, d), (B, H, S, d))]


# ---------------------------------------------------------------------------
# the split-key combine
# ---------------------------------------------------------------------------

# S = 300 is 5 key tiles: 2 splits cut at key 192, 3 at 128 and 256, 7 leave
# two splits without a key.  (bias?, k_valid)
COMBINE_CASES = {
    "bias": (True, None),
    "k_valid_inside_a_split": (True, [300, 100]),
    "k_valid_on_a_split_boundary": (False, [192, 128]),
    "fully_masked_row": (True, [300, 250]),
}


@pytest.mark.parametrize("kv_splits", SPLITS)
@pytest.mark.parametrize("case", sorted(COMBINE_CASES))
def test_split_combine_equals_unsplit(case, kv_splits):
    with_bias, kv = COMBINE_CASES[case]
    q, k, v = (t(a) for a in _qkv(sorted(COMBINE_CASES).index(case), 2, 2, 70, 300, 16))
    bias = None
    if with_bias:
        bias = torch.zeros((2, 70, 300))
        bias[1, :, -40:] = -1e10
        if case == "fully_masked_row":
            bias[0, 3, :] = -1e10
    k_valid = None if kv is None else torch.tensor(kv, dtype=torch.int32)
    want = tfa.flash_attention_ref(q, k, v, bias, 0.25, k_valid)
    got = tfa.flash_attention_ref(q, k, v, bias, 0.25, k_valid, kv_splits=kv_splits)
    assert torch.isfinite(got).all()
    assert_close(got, want, **TOL, name=f"{case} splits={kv_splits}")
    if kv_splits == 1:
        assert torch.equal(got, want)  # the default is the old arithmetic, bit for bit
    if case == "fully_masked_row":  # the uniform average over all S keys, however split
        assert_close(got[0, :, 3], v[0].mean(dim=1), **TOL)


@pytest.mark.parametrize("kv_splits", SPLITS)
@pytest.mark.parametrize("window,kv", [(10, None), (40, [300, 150]), (0, None)])
def test_banded_split_combine_equals_unsplit(window, kv, kv_splits):
    """Window 10 at T = 300: for most rows every split but one holds no key
    of the band (all scores replaced by -1e10) and must weigh nothing."""
    q, k, v = (t(a) for a in _qkv(11, 2, 2, 300, 300, 8))
    k_valid = None if kv is None else torch.tensor(kv, dtype=torch.int32)
    want = tfa.banded_attention_ref(q, k, v, 0.3, window, k_valid)
    got = tfa.banded_attention_ref(q, k, v, 0.3, window, k_valid, kv_splits=kv_splits)
    assert torch.isfinite(got).all()
    assert_close(got, want, **TOL, name=f"window={window} splits={kv_splits}")


@pytest.mark.parametrize("kv_splits", [2, 3])
@pytest.mark.parametrize("case", ["bias", "k_valid", "fully_masked"])
def test_split_combine_matches_pallas_interpret(case, kv_splits):
    """The cases of tests/test_torch_flash_attention.py, same numpy inputs."""
    if case == "bias":
        q, k, v = _qkv(0, 2, 3, 100, 150, 32)
        bias, kv = np.zeros((2, 100, 150), np.float32), None
        bias[1, :, -30:] = -1e10
    elif case == "k_valid":
        q, k, v = _qkv(2, 2, 2, 80, 80, 32)
        bias, kv = None, np.asarray([80, 55], np.int32)
    else:
        q, k, v = _qkv(1, 1, 2, 64, 64, 16)
        bias, kv = np.full((1, 64, 64), -1e10, np.float32), None
    d = q.shape[-1]
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), d ** -0.5,
        k_valid=None if kv is None else jnp.asarray(kv), interpret=True,
        block_q=64, block_k=64))
    got = tfa.flash_attention_ref(t(q), t(k), t(v), None if bias is None else t(bias),
                                  d ** -0.5, None if kv is None else t(kv, torch.int32),
                                  kv_splits=kv_splits)
    if case == "fully_masked":
        # the Pallas kernel averages its -1e10 pad keys in; the port excludes
        # them, as tests/test_torch_flash_attention.py holds: the uniform mean
        assert np.isfinite(want).all()
        want = np.broadcast_to(v.mean(axis=2, keepdims=True), got.shape)
    assert_close(got, want, **TOL, name=f"{case} splits={kv_splits}")


# (B, H, T, d, window, scale, k_valid) of tests/test_torch_banded_attention.py
BANDED_CASES = {
    "aligned": (2, 3, 384, 64, 96, 0.125, None),
    "ragged_k_valid": (2, 2, 300, 8, 64, 0.3, [300, 217]),
    "rows_without_keys": (2, 2, 150, 8, 16, 0.3, [150, 40]),
}


@pytest.mark.parametrize("kv_splits", [2, 3])
@pytest.mark.parametrize("case", sorted(BANDED_CASES))
def test_banded_split_combine_matches_pallas_interpret(case, kv_splits):
    B, H, T, d, window, scale, kv = BANDED_CASES[case]
    q, k, v = _qkv(sorted(BANDED_CASES).index(case), B, H, T, T, d)
    k_valid = None if kv is None else np.asarray(kv, np.int32)
    want = np.asarray(jfa.banded_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, window,
        k_valid=None if kv is None else jnp.asarray(k_valid), interpret=True))
    got = tfa.banded_attention_ref(t(q), t(k), t(v), scale, window,
                                   None if kv is None else t(k_valid, torch.int32),
                                   kv_splits=kv_splits)
    for b in range(B):  # rows past k_valid have no admissible key and no defined value
        n = T if kv is None else kv[b]
        assert_close(got[b, :, :n], want[b, :, :n], **TOL, name=f"{case} b={b}")


# ---------------------------------------------------------------------------
# the split-K sum
# ---------------------------------------------------------------------------

EPILOGUES = {
    "none": dict(),
    "bias": dict(bias=True),
    "bias_gelu_tanh": dict(bias=True, gelu="tanh"),
    "bias_gelu_erf": dict(bias=True, gelu="erf"),
    "bias_residual_f32": dict(bias=True, residual=True),
    "three_segments": dict(nseg=3),
}


@pytest.mark.parametrize("split_k", [2, 4, 8])
@pytest.mark.parametrize("epilogue", sorted(EPILOGUES))
def test_gemm_ref_split_k_equals_unsplit(epilogue, split_k):
    e = EPILOGUES[epilogue]
    rng = np.random.default_rng(sorted(EPILOGUES).index(epilogue))
    M, K, seg, nseg = 37, 1024, 24, e.get("nseg", 1)
    a = t(rng.standard_normal((M, K)).astype(np.float32))
    ws = [t((rng.standard_normal((seg, K)) * 0.05).astype(np.float32)) for _ in range(nseg)]
    bias = t((rng.standard_normal(seg * nseg) * 0.05).astype(np.float32)) if e.get("bias") else None
    res = t(rng.standard_normal((M, seg * nseg)).astype(np.float32)) if e.get("residual") else None
    want = tfb.gemm_ref(a, ws, bias, res, gelu=e.get("gelu"))
    got = tfb.gemm_ref(a, ws, bias, res, gelu=e.get("gelu"), split_k=split_k)
    assert_close(got, want, **TOL, name=f"{epilogue} split_k={split_k}")
    assert torch.equal(tfb.gemm_ref(a, ws, bias, res, gelu=e.get("gelu"), split_k=1), want)


def test_gemm_ref_split_k_ragged_k():
    """K = 200 is four K slices (the last one short): 3 splits take 2, 2, 0."""
    rng = np.random.default_rng(9)
    a = t(rng.standard_normal((5, 200)).astype(np.float32))
    w = [t(rng.standard_normal((8, 200)).astype(np.float32))]
    assert_close(tfb.gemm_ref(a, w, split_k=3), tfb.gemm_ref(a, w), **TOL)


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

# the block's four products as (N, K): QKV, out-projection, FF1, FF2
PRODUCTS = {"QKV": (1536, 256), "out-proj": (256, 512), "FF1": (1024, 256), "FF2": (256, 1024)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("product", sorted(PRODUCTS))
@pytest.mark.parametrize("M", [312, 624, 2558, 5116])
def test_gemm_plan_on_the_main_path(M, product, dtype):
    N, K = PRODUCTS[product]
    bm, bn, split = tfb._gemm_plan(M, N, K, dtype)
    tiles = tfb._GEMM_TILES_F32 if dtype == torch.float32 else tfb._GEMM_TILES
    assert (bm, bn) in [t[:2] for t in tiles]  # an instantiation the kernel has
    assert split in (1, 2, 4, 8) and bm % split == 0  # ranks deal the tile's rows
    assert K % (split * tfb.K_SLICE) == 0  # whole K slices a split
    if split > 1:
        assert K // split >= 2 * tfb.K_SLICE
    blocks = -(-M // bm) * -(-N // bn) * split
    # a block for every SM, unless K is already split as far as it goes
    assert blocks >= _cuda.SMS or K // split == 2 * tfb.K_SLICE
    if M >= 2558 and K == 256:
        # the long utterance's shallow products fill the card unsplit; its
        # deep-K products (out-projection, FF2) measured faster split
        assert split == 1


# what the sweep on the card chose (PERF.md), spelt out
GEMM_PLANS = {
    (312, "QKV", torch.float32): (64, 64, 2),
    (312, "FF2", torch.float32): (64, 64, 8),
    (312, "out-proj", torch.float32): (64, 64, 4),
    (624, "FF1", torch.float32): (64, 64, 2),
    (2558, "QKV", torch.float32): (128, 64, 1),
    (2558, "FF2", torch.float32): (64, 64, 4),
    (5116, "FF1", torch.float32): (128, 64, 1),
    (5116, "FF2", torch.float32): (128, 64, 2),
    (312, "FF2", torch.bfloat16): (64, 64, 8),
    (2558, "FF1", torch.bfloat16): (128, 128, 1),
    (5116, "QKV", torch.bfloat16): (128, 128, 1),
    (5116, "out-proj", torch.bfloat16): (64, 64, 1),
}


@pytest.mark.parametrize("case", sorted(GEMM_PLANS, key=str), ids=str)
def test_gemm_plan_choices(case):
    M, product, dtype = case
    assert tfb._gemm_plan(M, *PRODUCTS[product], dtype) == GEMM_PLANS[case]


def test_gemm_plan_keeps_two_slices_a_split():
    """A tiny product cannot fill the card: the split stops where a rank
    would be left with fewer than two K slices."""
    assert tfb._gemm_plan(16, 64, 256, torch.float32) == (64, 64, 2)
    assert tfb._gemm_plan(16, 64, 64, torch.bfloat16) == (64, 64, 1)
    assert tfb._gemm_plan(16, 64, 8192, torch.float32) == (64, 64, 8)


# (B*H, T, S, window, dtype) -> kv_splits: the short synthesis's two levels,
# the long utterance, the streaming case, and the windowed path's two levels
ATTENTION_PLANS = {
    (16, 156, 156, None, F32): 1,  # three key tiles: too few to split
    (16, 312, 312, None, F32): 1,
    (16, 2580, 2580, None, F32): 1,
    (16, 128, 8320, None, F32): 3,  # 96 of the card's 132 slots
    (16, 2558, 2558, 256, F32): 1,
    (16, 1279, 1279, 128, F32): 1,
    (16, 156, 156, None, BF16): 1,
    (16, 312, 312, None, BF16): 1,
    (16, 1024, 1024, None, BF16): 1,
    (16, 2580, 2580, None, BF16): 1,
    (16, 128, 8320, None, BF16): 8,  # three blocks an SM: 256 of 396 slots
    (16, 1279, 1279, 128, BF16): 1,
    (4, 600, 600, 300, F32): 2,  # a band wide enough to split
}


@pytest.mark.parametrize("shape", sorted(ATTENTION_PLANS, key=str), ids=str)
def test_attention_plan_on_the_main_path(shape):
    """The kernel's one block shape (64 query rows, 64-key tiles) fits a
    block's shared memory, and the plan splits the keys only as far as
    filling the SMs needs while each split keeps its tiles."""
    BH, T, S, window, dtype = shape
    splits = tfa._attention_plan(BH, T, S, window, dtype)
    assert splits == ATTENTION_PLANS[shape] and splits in tfa._SPLITS
    assert tfa.BLOCK_Q == tfa.KV_TILE == 64
    assert tfa._attention_smem_bytes(dtype) <= tfa._SMEM_LIMIT
    keys = S if window is None else min(S, tfa.BLOCK_Q + 2 * window)
    tiles = -(-keys // tfa.KV_TILE)
    assert splits == 1 or tiles // splits >= tfa._MIN_TILES[dtype]
    blocks = -(-T // tfa.BLOCK_Q) * BH
    slots = _cuda.SMS * tfa._blocks_per_sm(dtype)
    assert splits == 1 or 4 * blocks * splits <= 3 * slots
    # the next split would overfill the slots or leave too few tiles a split
    bigger = [n for n in tfa._SPLITS if n > splits]
    assert not bigger or 4 * blocks * bigger[0] > 3 * slots \
        or tiles // bigger[0] < tfa._MIN_TILES[dtype]


def _attention_source():
    return (CSRC / "flash_attention.cu").read_text()


def test_attention_plans_are_the_kernels_instantiations():
    """Every plan ``_attention_plan`` can return is one the source launches:
    the dispatch instantiates both types at the source's block shape, which
    is the wrapper's (kBQ, kBK), and takes 1 to 8 splits, every one of
    ``_SPLITS``; the budget's constants are the source's; and A and C are
    the Hopper kernel: K and V by TMA into an mbarrier ring, products on
    wgmma with P from registers, bf16's P V on the transpose bit, no
    mma.sync, no cp.async ring for K and V (cp.async copies only a bias
    that TMA cannot take), one consumer warpgroup; the cluster attribute
    only for a split."""
    src = _attention_source()
    dispatch = src[src.index("int dispatch("):src.index("}  // namespace\n")]
    assert "launch<float, kBanded>(args, B, kv_splits, s)" in dispatch
    assert "launch<__nv_bfloat16, kBanded>(args, B, kv_splits, s)" in dispatch
    assert "kv_splits < 1 ||" in dispatch and "kv_splits > 8 ||" in dispatch
    assert set(tfa._SPLITS) <= set(range(1, 9))
    for const in (f"kD = {tfa.HEAD_DIM};", f"kBQ = {tfa.BLOCK_Q};", f"kBK = {tfa.KV_TILE};",
                  f"kSmemLimit = {tfa._SMEM_LIMIT};", f"kSmSmem = {tfa._SM_SMEM};",
                  "kStages = 2;", "kThreads = 128 + kSideWarps * 32;"):
        assert const in src
    for need in ("tma_load_4d", "mbar_arrive_expect", "Wgmma<T, kBK>::rs",
                 "Wgmma<T, kD, 1>::rs", "fence_proxy_async", "make_tensor_map_strided"):
        assert need in src
    for gone in ("mma.sync", "cp_async_16", "cp_async_commit", "cp_async_wait", "Mma<",
                 "mma_grid", "a_from_acc", "load_b_kn", "ldmatrix", "named_arrive"):
        assert gone not in src
    # the one cp.async left: the lanes' 16-byte chunks of a bias TMA cannot take
    assert src.count("cp_async_chunk(") == 1 and "if (lane_bias) {" in src
    launch = src[src.index("cudaError_t launch("):src.index("int dispatch(")]
    gated = launch[launch.index("if (kv_splits > 1) {"):]
    assert "cudaLaunchAttributeClusterDimension" in gated[:gated.index("}")]
    assert "1, 1, 1" in (CSRC / "wgmma.cuh").read_text()  # the transpose-B bit


# the source's header states each type's shared memory in bytes
HEADER_SMEM = {F32: 216120, BF16: 60472}


@pytest.mark.parametrize("dtype", sorted(HEADER_SMEM, key=str), ids=str)
def test_attention_smem_fits_every_plan(dtype):
    """The block of both types fits a block's 232 448 bytes, as the source
    header states it; the combine's o, m and l tiles fit over the ring; and
    the blocks an SM holds are the source's kMinBlocks: three in bf16, one
    in f32."""
    n = tfa._attention_smem_bytes(dtype)
    assert n == HEADER_SMEM[dtype] and n <= tfa._SMEM_LIMIT
    assert f"{n // 1000} {n % 1000:03d}" in _attention_source()
    es = 4 if dtype == F32 else 2
    tile, bq = tfa.KV_TILE, tfa.BLOCK_Q
    ring = 2 * ((5 if es == 4 else 2) * tile * 64 * es + bq * (tile * es + 16))
    assert bq * (64 + 6) * 4 <= ring
    assert tfa._blocks_per_sm(dtype) == (3 if dtype == BF16 else 1)


# ---------------------------------------------------------------------------
# 3xTF32 against the f32 tolerances
# ---------------------------------------------------------------------------


def _tf32(x):
    """x cut to TF32's 10 mantissa bits (truncation: the pessimistic case of
    the card's round-to-nearest conversion)."""
    return (np.ascontiguousarray(x, np.float32).view(np.uint32)
            & np.uint32(0xFFFFE000)).view(np.float32)


def _matmul_tf32(a, b, passes):
    """a @ b as the tensor cores see it: one TF32 product, or the three of
    the compensated scheme (a_lo b_hi + a_hi b_lo + a_hi b_hi), summed in f32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _within(got, want, tol):
    return bool(np.all(np.abs(got - want) <= tol + tol * np.abs(want)))


@pytest.mark.parametrize("K", [256, 512, 1024])
def test_3xtf32_holds_the_gemm_tolerance(K):
    """chip_smoke's GEMM inputs (a ~ N(0, 1), w ~ 0.05 N(0, 1)) at the
    block's three K: 3xTF32 is inside atol = rtol = 1e-4 of the exact
    product, single-pass TF32 is not, which is why it was not taken."""
    rng = np.random.default_rng(K)
    a = rng.standard_normal((64, K)).astype(np.float32)
    w = (rng.standard_normal((K, 48)) * 0.05).astype(np.float32)
    want = a.astype(np.float64) @ w.astype(np.float64)
    assert _within(_matmul_tf32(a, w, 3), want, 1e-4)
    assert not _within(_matmul_tf32(a, w, 1), want, 1e-4)


@pytest.mark.parametrize("chain", ["tile", "all_keys"])
def test_3xtf32_holds_the_attention_tolerance(chain):
    """Both products of an attention call at d = 64 over 512 keys: inside
    atol = rtol = 1e-5 of f64 with 3xTF32, outside with single-pass TF32.
    ``tile`` walks the keys in the kernel's 64-key tiles with an online softmax
    and sums each tile's P V apart, adding it to O in f32 (the kernel's
    kPromote); ``all_keys`` takes P V as one product over every key (the
    longer chain).  This emulation rounds every sum to nearest in f32: it
    does not model the tensor cores' accumulator, which adds by truncation
    and makes a long chain drift, the reason the kernel promotes every
    tile; only the card shows that."""
    rng = np.random.default_rng(64)
    S, kv_tile = 512, tfa.KV_TILE
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((32, 64), (S, 64), (S, 64)))

    def attend(matmul):
        tiles = [(matmul(q, np.ascontiguousarray(k[s0:s0 + kv_tile].T)) * np.float32(0.125))
                 .astype(np.float32) for s0 in range(0, S, kv_tile)]
        if chain == "all_keys":
            sc = np.concatenate(tiles, axis=1)
            p = np.exp(sc - sc.max(-1, keepdims=True)).astype(np.float32)
            return matmul(p, v) / p.sum(-1, keepdims=True)
        m = np.full((32, 1), -1e10, np.float32)
        l = np.zeros((32, 1), np.float32)
        o = np.zeros((32, 64), np.float32)
        for i, sc in enumerate(tiles):
            m_new = np.maximum(m, sc.max(-1, keepdims=True))
            alpha = np.exp(m - m_new).astype(np.float32)
            p = np.exp(sc - m_new).astype(np.float32)
            l = (l * alpha + p.sum(-1, keepdims=True)).astype(np.float32)
            pv = np.asarray(matmul(p, v[i * kv_tile:(i + 1) * kv_tile]), np.float32)
            o = (o * alpha + pv).astype(np.float32)
            m = m_new
        return o / l

    want = attend(lambda a, b: a.astype(np.float64) @ b.astype(np.float64))
    assert _within(attend(lambda a, b: _matmul_tf32(a, b, 3)), want, 1e-5)
    assert not _within(attend(lambda a, b: _matmul_tf32(a, b, 1)), want, 1e-5)


# ---------------------------------------------------------------------------
# what the 16-byte copies refuse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["k_not_multiple_of_8", "seg_not_multiple_of_4",
                                  "misaligned_start", "non_contiguous"])
def test_gemm_argument_checks(case):
    a, w = torch.zeros((8, 64)), torch.zeros((16, 64))
    tfb.check_gemm_args(a, [w], None, None, torch.float32, None)
    if case == "k_not_multiple_of_8":
        a, w = torch.zeros((8, 60)), torch.zeros((16, 60))
    elif case == "seg_not_multiple_of_4":
        w = torch.zeros((6, 64))
    elif case == "misaligned_start":
        a = torch.zeros(8 * 64 + 1)[1:].view(8, 64)
    else:
        a = torch.zeros((64, 8)).t()
    n0 = tfb.gemm.launches
    with pytest.raises(ValueError):
        tfb.check_gemm_args(a, [w], None, None, torch.float32, None)
    assert tfb.gemm.launches == n0


@pytest.mark.parametrize("case", ["row_stride", "start", "out_rows"])
def test_attention_alignment_checks(case):
    q = torch.zeros((1, 2, 8, 64))
    out = None
    tfa.check_kernel_args(q, q, q, None, None)
    if case == "row_stride":  # rows 65 floats apart: every other row off a boundary
        bad = torch.zeros((1, 2, 8, 65))[..., :64]
        args = (bad, bad, bad)
    elif case == "start":
        bad = torch.zeros(2 * 8 * 64 + 1)[1:].view(1, 2, 8, 64)
        args = (q, bad, q)
    else:
        args, out = (q, q, q), torch.zeros((1, 2, 8, 66))[..., 2:]
    with pytest.raises(ValueError, match="16-byte"):
        tfa.check_kernel_args(*args, None, None, out)
