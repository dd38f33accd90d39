"""The port's full-parameter training against the JAX package on the CPU:
the CosyVoice2 training forwards (``qwen2lm_forward_train`` uni- and
bistream on JAX's coin, and against the torch-recorded golden
``qwen2lm_unistream``; ``qwen2lm_forward_dpo``; ``flow2_forward_train``
with and without streaming on JAX's draws), ``dpo_loss`` and the DPO loss
function with its frozen reference, two ``FullTrainer`` steps at
accumulation 2 against JAX's ``FullTrainer``, the inf/nan skip (parameters
and moments untouched, as in JAX), the step checkpoints (a resumed run
equal to an uninterrupted one, retention, the asynchronous save), the
``.pt`` exports read by the other package, the parallel options at a
world of one (once refused naming A15), and
gradient checkpointing (the same loss and gradients as without, dropout
included).  Tolerances: 2e-4 for losses, cosine >= 0.9999 for gradients,
1e-4 x max(1, max|p|) for parameters after two steps."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from cosy_tpu.ctx import EVAL as JEVAL, Ctx as JCtx
from cosy_tpu.models import flow2 as JF2
from cosy_tpu.models import gan as JG
from cosy_tpu.models import qwen2lm as JLM
from cosy_tpu.params import P as JP, load_torch_checkpoint as j_load, save_torch_checkpoint as j_save
from cosy_tpu.parallel import mesh as pmesh
from cosy_tpu.train import checkpoint as JCK
from cosy_tpu.train import dpo as JDPO
from cosy_tpu.train.full_trainer import FullTrainer as JFullTrainer
from cosy_tpu_torch.config import tiny_model_config, replace
from cosy_tpu_torch.ctx import EVAL, Ctx
from cosy_tpu_torch.models import flow2 as TF2
from cosy_tpu_torch.models import gan as TG
from cosy_tpu_torch.models import qwen2lm as TLM
from cosy_tpu_torch.models.llm import init_llm_params, llm_forward_train
from cosy_tpu_torch.params import P as TP, from_numpy
from cosy_tpu_torch.train import dpo as TDPO
from cosy_tpu_torch.train.checkpoint import TrainCheckpointer, load_model_pt
from cosy_tpu_torch.train.distill import tiny_flow2_config
from cosy_tpu_torch.train.full_trainer import FullTrainer, adamw
from test_torch_common import assert_close, golden_np, grad_agreement, t
from test_torch_cv2 import LCFG, jax_config
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=2e-4, rtol=2e-4)
J_LCFG = jax_config(LCFG)
# dropout off: the training forward runs under Ctx(train=True), JAX's under EVAL
FCFG2 = dataclasses.replace(tiny_flow2_config(), encoder=dataclasses.replace(
    tiny_flow2_config().encoder, dropout_rate=0.0, positional_dropout_rate=0.0,
    attention_dropout_rate=0.0))


@pytest.fixture(scope="module")
def lm():
    return {k: v.numpy() for k, v in TLM.init_qwen2lm_params(LCFG, "cpu", seed=1)
            .state_dict().items()}


def _jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _lm_batch(B=3, seed=0, dpo=False):
    """Rows of speech/text above the mix ratio (bistream-eligible) and one
    below it."""
    rng = np.random.default_rng(seed)
    b = {"text_token": rng.integers(0, 50, (B, 5)).astype(np.int32),
         "text_token_len": np.asarray([4, 3, 5][:B], np.int32),
         "speech_token": rng.integers(0, 30, (B, 20)).astype(np.int32),
         "speech_token_len": np.asarray([20, 16, 9][:B], np.int32)}
    if dpo:
        b["reject_speech_token"] = rng.integers(0, 30, (B, 20)).astype(np.int32)
        b["reject_speech_token_len"] = np.asarray([18, 15, 12][:B], np.int32)
    return b


def _tt(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_qwen2lm_forward_train_golden():
    params, ins, outs = golden_np("qwen2lm_unistream")
    res = TLM.qwen2lm_forward_train(TP(from_numpy(params, "cpu")), LCFG, _tt(ins), EVAL)
    assert_close(res["loss"], outs["loss"], atol=1e-3, rtol=1e-3)
    assert_close(res["acc"], outs["acc"], atol=1e-6, rtol=0)


@pytest.mark.parametrize("stream", ["uni", "bi"])
def test_qwen2lm_forward_train_matches_jax(lm, stream):
    """Loss, accuracy and gradients; ``bi`` takes JAX's coin from its key
    (the eligible rows pack bistream)."""
    batch = _lm_batch()
    key = None
    if stream == "bi":  # the first key whose coin packs an eligible row bistream
        key = next(k for k in map(jax.random.PRNGKey, range(20))
                   if np.asarray(jax.random.uniform(k, (3,)) < 0.5)[:2].any())

    def j_loss(p):
        r = JLM.qwen2lm_forward_train(JP(p), J_LCFG, _jnp(batch), JEVAL, rng=key)
        return r["loss"], r["acc"]

    (lj, aj), gj = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(_jnp(lm))
    coin = None if key is None else np.asarray(jax.random.uniform(key, (3,)) < 0.5)
    p = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in lm.items()}
    res = TLM.qwen2lm_forward_train(TP(p), LCFG, _tt(batch), Ctx(train=True),
                                    coin=None if coin is None else torch.from_numpy(coin))
    res["loss"].backward()
    assert_close(res["loss"].detach(), lj, **TOL)
    assert_close(res["acc"], aj, atol=1e-6, rtol=0)
    cos, _ = grad_agreement({k: v.grad.numpy() for k, v in p.items()},
                            {k: np.asarray(v) for k, v in gj.items()})
    assert cos >= 0.9999


def test_dpo_forward_loss_and_metrics_match_jax(lm):
    """qwen2lm_forward_dpo on JAX's coin, then the DPO loss function (policy
    moved off the frozen reference) and its gradients; dpo_loss in its
    three forms."""
    batch = _lm_batch(dpo=True)
    key = jax.random.PRNGKey(4)
    coin = torch.from_numpy(np.asarray(jax.random.uniform(key, (3,)) < 0.5))
    want = jax.jit(lambda p_, b_: JLM.qwen2lm_forward_dpo(JP(p_), J_LCFG, b_, JEVAL, rng=key))(
        _jnp(lm), _jnp(batch))
    got = TLM.qwen2lm_forward_dpo(TP(from_numpy(lm, "cpu")), LCFG, _tt(batch), EVAL, coin=coin)
    for k in ("loss", "acc", "chosen_logps", "rejected_logps"):
        assert_close(got[k], want[k], **TOL, name=k)
    rng = np.random.default_rng(5)
    policy = {k: v + (0.02 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in lm.items()}
    j_fn = JDPO.make_dpo_loss_fn(J_LCFG, _jnp(lm), beta=0.5)
    (lj, mj), gj = jax.jit(jax.value_and_grad(lambda p: j_fn(p, key, _jnp(batch)),
                                              has_aux=True))(_jnp(policy))
    t_fn = TDPO.make_dpo_loss_fn(LCFG, from_numpy(lm, "cpu"), beta=0.5)
    p = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in policy.items()}
    lt, mt = t_fn(p, None, _tt(batch), coin=coin)
    lt.backward()
    assert_close(lt.detach(), lj, **TOL)
    for k in mj:
        assert_close(mt[k], mj[k], **TOL, name=k)
    cos, _ = grad_agreement({k: v.grad.numpy() for k, v in p.items()},
                            {k: np.asarray(v) for k, v in gj.items()})
    assert cos >= 0.9999
    lp = [rng.standard_normal(4).astype(np.float32) - 2 for _ in range(4)]
    for kw in (dict(beta=0.01), dict(beta=0.1, label_smoothing=0.2), dict(beta=0.1, ipo=True)):
        for g, w in zip(TG.dpo_loss(*(t(a) for a in lp), **kw),
                        JG.dpo_loss(*(jnp.asarray(a) for a in lp), **kw)):
            assert_close(g, w, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("streaming", [False, True], ids=["full", "stream"])
def test_flow2_forward_train_matches_jax(streaming):
    flat = {k: v.numpy() for k, v in TF2.init_flow2_params(FCFG2, "cpu", seed=2)
            .state_dict().items()}
    jcfg = jax_config(FCFG2)
    rng = np.random.default_rng(6)
    B, T = 2, 26
    batch = {"speech_token": rng.integers(0, 128, (B, 12)).astype(np.int32),
             "speech_token_len": np.asarray([12, 9], np.int32),
             "speech_feat": rng.standard_normal((B, T, 80)).astype(np.float32),
             "speech_feat_len": np.asarray([26, 18], np.int32),
             "embedding": rng.standard_normal((B, 192)).astype(np.float32)}
    key = jax.random.PRNGKey(7)
    lj, gj = jax.jit(jax.value_and_grad(lambda p: JF2.flow2_forward_train(
        JP(p), jcfg, key, _jnp(batch), JEVAL, streaming=streaming)))(_jnp(flat))
    k_cond, k_len, k_loss = jax.random.split(key, 3)
    kt, kz, kcfg = jax.random.split(k_loss, 3)
    draws = {"drop": np.asarray(jax.random.bernoulli(k_cond, 0.5, (B,))),
             "plen_u": np.asarray(jax.random.uniform(k_len, (B,))),
             "t_u": np.asarray(jax.random.uniform(kt, (B, 1, 1))),
             "z": np.asarray(jax.random.normal(kz, (B, 80, T))),
             "cfg_u": np.asarray(jax.random.uniform(kcfg, (B,)))}
    p = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in flat.items()}
    loss = TF2.flow2_forward_train(TP(p), FCFG2, None, _tt(batch), Ctx(train=True),
                                   streaming=streaming, draws=draws)
    loss.backward()
    assert_close(loss.detach(), lj, **TOL)
    cos, _ = grad_agreement({k: v.grad.numpy() for k, v in p.items() if v.grad is not None},
                            {k: np.asarray(gj[k]) for k, v in p.items() if v.grad is not None})
    assert cos >= 0.9999


# -- the trainer ---------------------------------------------------------


def _super(seed, accum=2, B=3):
    bs = [_lm_batch(B, seed * 10 + a) for a in range(accum)]
    return {k: np.stack([b[k] for b in bs]) for k in bs[0]}


def test_two_full_trainer_steps_match_jax(lm):
    """Qwen2LM in unistream (no draws), AdamW 1e-3, clip 5, accumulation 2:
    the metrics and the parameters after two steps."""
    def j_loss(p, rng, b):
        r = JLM.qwen2lm_forward_train(JP(p), J_LCFG, b, JCtx(rng=rng, train=True), rng=None)
        return r["loss"], {"acc": r["acc"]}

    jt = JFullTrainer(j_loss, _jnp(lm), optax.adamw(1e-3), accum=2,
                      mesh=pmesh.make_mesh(dp=1, devices=jax.devices()[:1]))

    def t_loss(p, g, b):
        r = TLM.qwen2lm_forward_train(TP(p), LCFG, b, Ctx(generator=g, train=True))
        return r["loss"], {"acc": r["acc"]}

    tt = FullTrainer(t_loss, from_numpy(lm, "cpu"), adamw(1e-3), accum=2)
    for step in range(2):
        sb = _super(step)
        mj, mt = jt.step(sb, jax.random.PRNGKey(step)), tt.step(sb)
        assert sorted(mj) == sorted(mt) == ["acc", "grad_norm", "loss", "skipped"]
        for k in mj:
            np.testing.assert_allclose(mt[k], mj[k], **TOL, err_msg=k)
    for k, v in jt.params.items():
        want = np.asarray(v)
        assert_close(tt.params[k], want, atol=1e-4 * max(1.0, np.abs(want).max()), rtol=0,
                     name=k)


def _quad(lib):
    """A quadratic loss both packages trace in a blink; a batch row of inf
    makes the gradient non-finite."""
    def loss(p, rng, b):
        r = lib.sum(lib.square(p["w"] * b["x"] + p["b"] - b["y"]))
        return r, {}
    return loss


def test_inf_nan_skip_leaves_parameters_and_moments(lm):
    """A non-finite gradient norm skips the update in both packages: the
    parameters, the moments and the step count of the optimizer stay."""
    p0 = {"w": np.full((4,), 0.5, np.float32), "b": np.zeros((4,), np.float32)}
    good = {"x": np.ones((2, 3, 4), np.float32), "y": np.full((2, 3, 4), 2.0, np.float32)}
    bad = {k: v.copy() for k, v in good.items()}
    bad["x"][1, 0, 0] = np.inf
    jt = JFullTrainer(_quad(jnp), _jnp(p0), optax.adamw(1e-2), accum=2,
                      mesh=pmesh.make_mesh(dp=1, devices=jax.devices()[:1]))
    tt = FullTrainer(lambda p, g, b: _quad(torch)(p, g, b), from_numpy(p0, "cpu"), adamw(1e-2),
                     accum=2)
    for sb, skipped in ((good, 0.0), (bad, 1.0), (good, 0.0)):
        before = {k: v.detach().clone() for k, v in tt.params.items()}
        moments = {k: v.clone() for k, v in
                   tt.optimizer.state[tt.params["w"]].items()} if tt.optimizer.state else {}
        mj, mt = jt.step(sb, jax.random.PRNGKey(0)), tt.step(sb)
        assert mj["skipped"] == mt["skipped"] == skipped
        if skipped:
            assert all(torch.equal(before[k], v) for k, v in tt.params.items())
            after = tt.optimizer.state[tt.params["w"]]
            assert all(torch.equal(moments[k], after[k]) for k in moments)
        for k, v in jt.params.items():
            assert_close(tt.params[k], np.asarray(v), atol=1e-6, rtol=1e-6, name=k)


def test_checkpoint_resume_equals_uninterrupted_run(lm, tmp_path):
    """Three steps straight against two steps, an asynchronous save, a new
    trainer restored from it and one more step: the same parameters, bit
    for bit; keep=2 retains the newest two steps."""
    def loss(p, g, b):
        return TLM.qwen2lm_forward_train(TP(p), LCFG, b, Ctx(generator=g, train=True))["loss"], {}

    def trainer():
        return FullTrainer(loss, from_numpy(lm, "cpu"), adamw(1e-3), accum=2)

    a = trainer()
    for s in range(3):
        a.step(_super(s))
    b = trainer()
    d = str(tmp_path / "ckpt")
    for s in range(2):
        b.step(_super(s))
        b.save_checkpoint(d, keep=2)
    b.close()
    c = trainer()
    assert c.load_checkpoint(d) == 2
    c.step(_super(2))
    assert all(torch.equal(a.params[k], c.params[k]) for k in a.params)
    c.save_checkpoint(d, keep=2, async_save=False)
    assert TrainCheckpointer(d).all_steps() == [2, 3]
    with pytest.raises(FileNotFoundError):
        TrainCheckpointer(str(tmp_path / "empty")).restore()


def test_pt_exports_are_read_by_the_other_package(lm, tmp_path):
    p = str(tmp_path / "llm_epoch0.pt")
    FullTrainer(lambda *a: None, from_numpy(lm, "cpu")).save_model(p, info={"epoch": 0})
    assert "step: 0" in open(str(tmp_path / "llm_epoch0.yaml")).read()
    back = j_load(p)
    assert sorted(back) == sorted(lm)
    assert all(np.array_equal(np.asarray(back[k]), lm[k]) for k in lm)
    q = str(tmp_path / "from_jax.pt")
    JCK.save_model_pt(_jnp(lm), q, info={"epoch": 1})
    got = load_model_pt(q)
    assert all(np.array_equal(got[k].numpy(), lm[k]) for k in lm)


@pytest.mark.parametrize("kw", [dict(mesh="world"), dict(tensor_parallel=True),
                                dict(sequence_parallel=True),
                                dict(pipeline_parallel_microbatches=2)])
def test_parallel_options_are_refused_naming_a15(kw):
    """The options these tests once saw refused (naming ROADMAP A15) are
    taken now: at a world of one each trainer's step equals the plain
    trainer's exactly (every collective is skipped at size 1).  The
    multi-rank equalities are held in tests/test_torch_parallel.py."""
    from cosy_tpu_torch.parallel.mesh import make_mesh

    if kw.get("mesh") == "world":
        kw = dict(mesh=make_mesh(device="cpu"))

    def loss_fn(p, g, b):
        return torch.sum(torch.square(p["w"] * b["x"][:, :2].sum(0) - 1.0)), {}

    sb = {"x": np.arange(12, dtype=np.float32).reshape(1, 2, 6)}
    plain = FullTrainer(loss_fn, {"w": torch.ones(2)}, zero2=False)
    taken = FullTrainer(loss_fn, {"w": torch.ones(2)}, **kw)
    assert taken.mesh.shape == {"dp": 1, "seq": 1, "model": 1}
    assert plain.step(sb) == taken.step(sb)
    assert torch.equal(plain.params["w"], taken.params["w"])


def test_gradient_checkpointing_gives_the_same_loss_and_gradients():
    """The 300M LLM's two encoders with dropout on: checkpointed layers
    recompute the same dropout masks, so loss and gradients are those of
    the stored run, and the generator ends where it would."""
    cfg = tiny_model_config().llm
    torch.manual_seed(0)
    batch = {"text_token": torch.randint(0, 300, (3, 5)), "text_token_len": torch.tensor([5, 4, 3]),
             "speech_token": torch.randint(0, 128, (3, 9)),
             "speech_token_len": torch.tensor([9, 7, 8]), "embedding": torch.randn(3, 192)}
    init = {k: v.detach() for k, v in init_llm_params(cfg, "cpu", seed=1).named_parameters()}
    runs = []
    for gc in (False, True):
        c = replace(cfg, llm=replace(cfg.llm, gradient_checkpointing=gc, dropout_rate=0.1),
                    text_encoder=replace(cfg.text_encoder, gradient_checkpointing=gc,
                                         dropout_rate=0.1))
        p = {k: v.clone().requires_grad_(True) for k, v in init.items()}
        g = torch.Generator().manual_seed(5)
        loss = llm_forward_train(TP(p), c, batch, Ctx(generator=g, train=True))["loss"]
        loss.backward()
        runs.append((loss.detach(), {k: v.grad for k, v in p.items() if v.grad is not None},
                     g.get_state()))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert torch.equal(l0, l1) and torch.equal(s0, s1) and sorted(g0) == sorted(g1)
    assert all(torch.allclose(g0[k], g1[k], atol=1e-7, rtol=1e-6) for k in g0)
