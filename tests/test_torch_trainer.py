"""The port's schedules and JointTrainer against the JAX package: every
schedule equal over 0..total steps (rtol 1e-5: f32 against f64); three
``llm_only`` optimizer steps at dropout 0 from the same carried adapters
(each adapter entry within 1e-3, and on average within 1e-4, of the largest
movement any entry made: AdamW's first steps are g / |g|, so the update is
insensitive to small gradient differences; measured 1.5e-5 and 5e-6);
checkpoint round trip; ``export_merged``
equal to ``merge_lora`` and loadable by ``TTSPipeline``; base weights
untouched; and the training step's distance from the kernels: the wrappers
refuse an input that requires a gradient, and a step calls none of them."""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cosy_tpu.config import LoRAConfig as JLoRA, TrainConfig as JTrain, tiny_model_config as j_tiny
from cosy_tpu.parallel import mesh as pmesh
from cosy_tpu.train import schedules as JS
from cosy_tpu.train.trainer import JointTrainer as JTrainer
from cosy_tpu_torch import config as TC
from cosy_tpu_torch import lora as TL
from cosy_tpu_torch import merge as tmerge
from cosy_tpu_torch import ops as tops
from cosy_tpu_torch.infer.pipeline import TTSPipeline
from cosy_tpu_torch.models import flow as TF, hift as TH, llm as TLLM
from cosy_tpu_torch.ops import flash_attention as tfa, fused_block as tfb
from cosy_tpu_torch.train import schedules as TS
from cosy_tpu_torch.train.trainer import JointTrainer
from test_torch_common import assert_close, port_config
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)


def _no_dropout(cfg):
    z = dict(dropout_rate=0.0, positional_dropout_rate=0.0, attention_dropout_rate=0.0)
    llm = dataclasses.replace(cfg.llm, text_encoder=dataclasses.replace(cfg.llm.text_encoder, **z),
                              llm=dataclasses.replace(cfg.llm.llm, **z))
    flow = dataclasses.replace(cfg.flow, encoder=dataclasses.replace(cfg.flow.encoder, **z))
    return dataclasses.replace(cfg, llm=llm, flow=flow)


JCFG = _no_dropout(j_tiny())
JTCFG = JTrain(training_mode="llm_only", batch_size=4, accumulate_grad_batches=2,
               max_feat_len=16, learning_rate=1e-3, warmup_steps=1, bf16=False,
               llm_lora=JLoRA(r=2, alpha=4, dropout=0.0),
               flow_lora=JLoRA(r=2, alpha=4, dropout=0.0,
                               target_modules=("to_q", "to_k", "to_v", "w_1", "w_2")))


def super_batch(seed=0, accum=2, B=4):
    rng = np.random.default_rng(seed)
    return {
        "text_token": rng.integers(0, 300, (accum, B, 5)).astype(np.int32),
        "text_token_len": np.full((accum, B), 5, np.int32),
        "speech_token": rng.integers(0, 128, (accum, B, 9)).astype(np.int32),
        "speech_token_len": np.full((accum, B), 9, np.int32),
        "speech_feat": (rng.standard_normal((accum, B, 16, 80)) * 2 - 6).astype(np.float32),
        "speech_feat_len": np.full((accum, B), 16, np.int32),
        "embedding": rng.standard_normal((accum, B, 192)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def models():
    cfg = port_config(JCFG)
    return (cfg, TLLM.init_llm_params(cfg.llm, "cpu", seed=1),
            TF.init_flow_params(cfg.flow, "cpu", seed=2))


SCHEDULE_CFGS = {
    "warmup_cosine": dict(scheduler="warmup_cosine", warmup_steps=7),
    "warmup_cosine_no_warmup": dict(scheduler="warmup_cosine", warmup_steps=0),
    "warmuplr": dict(scheduler="warmuplr", warmup_steps=9),
    "warmuplr_no_warmup": dict(scheduler="warmuplr", warmup_steps=0),
    "constantlr": dict(scheduler="constantlr"),
    "cosine_annealing": dict(scheduler="cosine_annealing", warmup_steps=5),
    "square_annealing": dict(scheduler="square_annealing", warmup_steps=5),
    "squareroot_annealing": dict(scheduler="squareroot_annealing", warmup_steps=5),
    "squareroot_annealing_no_warmup": dict(scheduler="squareroot_annealing", warmup_steps=0),
    "noam_annealing": dict(scheduler="noam_annealing", warmup_steps=6, scheduler_d_model=64,
                           min_learning_rate=1e-5),
    "noamhold_annealing": dict(scheduler="noamhold_annealing", warmup_steps=4,
                               scheduler_hold_steps=6, scheduler_decay_rate=0.5),
    "noamhold_annealing_no_warmup": dict(scheduler="noamhold_annealing", warmup_steps=0,
                                         scheduler_hold_steps=3, scheduler_decay_rate=1.0),
}


@pytest.mark.parametrize("name", sorted(SCHEDULE_CFGS))
def test_schedule_matches_jax(name):
    total = 40
    jt = dataclasses.replace(JTrain(), **SCHEDULE_CFGS[name])
    want_fn = JS.make_schedule(jt, total)
    got_fn = TS.make_schedule(port_config(jt), total)
    steps = range(total + 6)  # past the end too
    want = np.asarray([float(want_fn(jnp.asarray(s))) for s in steps])
    got = np.asarray([got_fn(s) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12, err_msg=name)
    assert sorted(TS.SCHEDULES) == sorted(JS.SCHEDULES)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown scheduler"):
        TS.make_schedule(TC.TrainConfig(scheduler="nope"), 10)


def test_three_llm_only_steps_match_the_jax_trainer(models, tmp_path):
    cfg, llm, flow = models
    jllm = {k: jnp.asarray(v.numpy()) for k, v in llm.state_dict().items()}
    before = {k: v.clone() for k, v in llm.state_dict().items()}
    jt = JTrainer(JCFG, JTCFG, jllm, {}, out_dir=str(tmp_path / "j"),
                  mesh=pmesh.make_mesh(dp=1), total_steps=10)
    jstate = jt.init_state(jax.random.PRNGKey(3))
    init = {k: np.array(v) for k, v in jstate.loras["llm"].items()}

    tt = JointTrainer(cfg, port_config(JTCFG), llm, None, out_dir=str(tmp_path / "t"),
                      total_steps=10)
    tstate = tt.init_state(loras={"llm": TL.lora_from_numpy(init, "cpu")})
    batches = [super_batch(s) for s in range(3)]
    for i, sb in enumerate(batches):
        jm = jt.step(jstate, sb, jax.random.PRNGKey(20 + i))
        tm = tt.step(tstate, sb)
        assert sorted(tm) == sorted(jm) == ["grad_norm", "llm_acc", "llm_loss", "loss", "lr"]
        for k in tm:
            assert_close(tm[k], np.asarray(jm[k]), atol=2e-4, rtol=2e-4, name=f"step {i} {k}")
    assert tstate.step == jstate.step == 3 and float(tm["grad_norm"]) > 0

    want = {k: np.asarray(v) for k, v in jstate.loras["llm"].items()}
    got = TL.lora_to_numpy(tstate.loras["llm"])
    moved = max(np.abs(want[k] - init[k]).max() for k in want)
    dev = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert moved > 1e-3  # lr 0 at step 0 (warmup), then 1e-3 twice
    assert dev.max() <= 1e-3 * moved and dev.mean() <= 1e-4 * moved, (dev.max(), dev.mean(), moved)
    # the base weights are bit-identical after training
    assert all(torch.equal(v, before[k]) for k, v in llm.state_dict().items())

    # the merged export against the JAX trainer's, both at bf16=False (f32
    # base weights on both sides): within 2e-5, what the adapters' distance
    # above leaves.  With bf16=True the two differ by design: the JAX trainer
    # merges into its bf16-rounded copy of the base weights cast back to f32,
    # the port into the f32 master weights, so an entry W can differ by the
    # bf16 rounding of W, at most |W| * 2**-9.
    jmerged = jt.export_merged(jstate, save=False)["llm"]
    tmerged = tt.export_merged(tstate, save=False)["llm"]
    assert sorted(tmerged) == sorted(jmerged)
    for k, v in tmerged.items():
        assert v.dtype == torch.float32
        assert_close(v, np.asarray(jmerged[k]), atol=2e-5, rtol=0, name=f"merged {k}")
    assert any(not torch.equal(tmerged[k], before[k]) for k in before)


def test_joint_steps_bf16_checkpoint_merge_and_synthesis(models, tmp_path):
    """Joint mode with the default bf16 compute: finite metrics, a loss that
    falls on a repeated batch, a checkpoint that restores adapters, moments
    and step, a merge equal to merge_lora on the f32 weights, and merged
    weights that synthesize."""
    cfg, llm, flow = models
    tcfg = dataclasses.replace(port_config(JTCFG), training_mode="joint", bf16=True,
                               warmup_steps=0, learning_rate=2e-3)
    tr = JointTrainer(cfg, tcfg, llm, flow, out_dir=str(tmp_path), total_steps=50)
    state = tr.init_state(torch.Generator().manual_seed(0))
    assert all(v.dtype == torch.bfloat16 for v in tr.llm_params.values())
    assert all(v.dtype == torch.float32 for d in state.loras.values() for v in d.values())
    sb = super_batch(7)
    hist = [{k: float(v) for k, v in tr.step(state, sb, torch.Generator().manual_seed(1)).items()}
            for _ in range(4)]
    assert all(np.isfinite(v) for m in hist for v in m.values())
    assert hist[0]["grad_norm"] > 0 and hist[-1]["loss"] < hist[0]["loss"]
    assert sorted(hist[0]) == ["flow_loss", "grad_norm", "llm_acc", "llm_loss", "loss", "lr"]
    ev = tr.evaluate([sb], state)
    assert sorted(ev) == ["cv_flow_loss", "cv_llm_acc", "cv_llm_loss", "cv_loss"]

    path = tr.save_checkpoint(str(tmp_path / "joint_joint_last.ckpt"), state)
    assert path.endswith(".ckpt.pt") and tmerge.find_latest_checkpoint(str(tmp_path), "joint") == path
    back = tr.load_checkpoint(path, tr.init_state(torch.Generator().manual_seed(9)))
    assert back.step == 4
    for name in state.loras:
        for k, v in state.loras[name].items():
            assert torch.equal(back.loras[name][k], v) and back.loras[name][k].requires_grad
    m1 = tr.step(state, sb, torch.Generator().manual_seed(2))
    m2 = tr.step(back, sb, torch.Generator().manual_seed(2))
    assert float(m1["loss"]) == float(m2["loss"])  # the moments came back too
    assert all(torch.equal(a, b) for a, b in zip(state.leaves(), back.leaves()))

    merged = tr.export_merged(state, save=True)
    for name, module, lcfg in (("llm", llm, tcfg.llm_lora), ("flow", flow, tcfg.flow_lora)):
        want = TL.merge_lora(dict(module.named_parameters()), state.loras[name], lcfg.scaling)
        assert sorted(merged[name]) == sorted(module.state_dict())
        assert all(torch.equal(merged[name][k], want[k]) for k in want)
        assert any(not torch.equal(merged[name][k], v) for k, v in module.state_dict().items())
    with open(tmp_path / "flow_merged_joint.pt.meta.json") as f:
        assert json.load(f)["mel_space"] == "normalized"
    assert not os.path.exists(tmp_path / "llm_merged_joint.pt.meta.json")
    adapters = tr.export_adapters(state, str(tmp_path / "adapters.pt"))
    assert float(adapters["llm._scaling"]) == 2.0 and any(k.startswith("flow.") for k in adapters)

    llm2, flow2 = TLLM.TransformerLM(cfg.llm, "cpu"), TF.Flow(cfg.flow, "cpu")
    llm2.load_state_dict(torch.load(tmp_path / "llm_merged_joint.pt", weights_only=True), strict=True)
    flow2.load_state_dict(torch.load(tmp_path / "flow_merged_joint.pt", weights_only=True), strict=True)
    pipe = TTSPipeline(cfg, llm2, flow2, TH.init_hift_params(cfg.hift, "cpu", seed=3))
    wav = next(pipe.synthesize(np.asarray([[5, 6, 7]]), max_len_cap=12))["tts_speech"]
    assert wav.ndim == 2 and wav.shape[1] > 0 and np.isfinite(wav).all()


def test_fit_topk_and_merge_cli(models, tmp_path):
    cfg, llm, flow = models
    # the default flow adapters: what the merge entry point rebuilds
    tcfg = dataclasses.replace(port_config(JTCFG), training_mode="flow_only", warmup_steps=0,
                               no_prompt_training=False, early_stop_patience=1,
                               early_stop_min_delta=100.0, flow_lora=TC.FLOW_LORA_DEFAULT)
    tr = JointTrainer(cfg, tcfg, None, flow, out_dir=str(tmp_path), total_steps=20)
    state = tr.fit([super_batch(1), super_batch(2)], max_epochs=5, log_every=1)
    # early stop: epoch 0 sets the best loss, epoch 1 cannot beat it by 100
    assert state.step == 4 and len(tr._metrics_log) == 4
    assert "flow" in state.loras and "llm" not in state.loras
    assert all("llm_loss" not in m and np.isfinite(m["loss"]) for m in tr._metrics_log)
    names = sorted(os.listdir(tmp_path))
    assert "joint_flow_only_last.ckpt.pt" in names and "metrics.jsonl" in names
    assert sum(n.startswith("joint_flow_only_0") for n in names) == 2

    # the merge entry point: latest checkpoint of the mode -> merged flow weights
    tmerge.main(["--mode", "flow_only", "--output", str(tmp_path), "--tiny", "--device", "cpu",
                 "--seed", "1", "--adapters-out", str(tmp_path / "ad.pt")])
    merged = torch.load(tmp_path / "flow_merged_flow_only.pt", weights_only=True)
    base = TF.init_flow_params(cfg.flow, "cpu", seed=2).state_dict()  # CLI: seed + 1
    assert sorted(merged) == sorted(base)
    changed = [k for k in base if not torch.equal(merged[k], base[k])]
    assert changed and all(".to_" in k or ".w_" in k or ".linear_" in k for k in changed)
    assert os.path.exists(tmp_path / "ad.pt")


def test_kernel_wrappers_refuse_inputs_that_require_a_gradient():
    q = torch.zeros((1, 2, 8, 64))
    qg = q.clone().requires_grad_(True)
    for call in (lambda: tfa.flash_attention(qg, q, q, None, 1.0),
                 lambda: tfa.flash_attention(q, q, qg, None, 1.0),
                 lambda: tfa.banded_attention(q, qg, q, 1.0, 2)):
        with pytest.raises(RuntimeError, match="no backward"):
            call()
    a, w = torch.zeros((4, 8)), torch.zeros((6, 8))
    with pytest.raises(RuntimeError, match="no backward"):
        tfb.gemm(a, (w.clone().requires_grad_(True),))
    with pytest.raises(RuntimeError, match="no backward"):
        tfb.layer_norm_rows(a.clone().requires_grad_(True), torch.ones(8), torch.zeros(8),
                            torch.float32)
    x = torch.zeros((1, 4, 8), requires_grad=True)
    m = torch.zeros((8, 8))
    with pytest.raises(RuntimeError, match="no backward"):
        tfb.fused_transformer_block(x, None, *([m] * 13), heads=1, scale=1.0)
    with torch.no_grad():  # nothing recorded: accepted
        assert tfa.flash_attention(qg, q, q, None, 1.0).shape == q.shape


def test_training_and_lora_stay_off_the_kernel_wrappers(models, monkeypatch, tmp_path):
    """A training step calls no kernel wrapper; the fused-block gate is off
    under training and under un-merged LoRA even for CUDA tensors; un-merged
    LoRA at inference runs the unfused block through flash_attention."""
    from cosy_tpu_torch.ctx import Ctx
    from cosy_tpu_torch.layers import attention as tattn, unet as tunet
    import types

    cfg, llm, flow = models
    cuda_x = types.SimpleNamespace(device=torch.device("cuda"))
    assert tfb.use_fused_block(cuda_x, "gelu", None, None)
    assert not tfb.use_fused_block(cuda_x, "gelu", None, None, Ctx(train=True))
    assert not tfb.use_fused_block(cuda_x, "gelu", None, None, Ctx(lora={}))

    calls = []
    for mod, name in ((tattn, "flash_attention"), (tattn, "banded_attention"),
                      (tunet, "fused_transformer_block")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _r=real, **kw: (calls.append(_n), _r(*a, **kw))[1])
    tcfg = dataclasses.replace(port_config(JTCFG), training_mode="joint")
    tr = JointTrainer(cfg, tcfg, llm, flow, out_dir=str(tmp_path), total_steps=10)
    state = tr.init_state(torch.Generator().manual_seed(0))
    counts = tops.launch_counts()
    tr.step(state, super_batch(3), torch.Generator().manual_seed(1))
    assert calls == [] and tops.launch_counts() == counts

    # un-merged adapters at inference: the unfused block, attention through
    # the wrapper (kernel A on a CUDA tensor)
    rng = np.random.default_rng(0)
    x, mu, cond = (torch.from_numpy(rng.standard_normal((2, 80, 16)).astype(np.float32))
                   for _ in range(3))
    with torch.no_grad():
        tunet.conditional_decoder(
            flow.p.sub("decoder.estimator"), cfg.flow.estimator, x, None, mu,
            torch.tensor([0.2, 0.7]), torch.zeros((2, 80)), cond,
            Ctx(lora=state.loras["flow"], lora_scale=2.0))
    assert calls and set(calls) == {"flash_attention"}
    # outside no_grad the adapters require a gradient and the wrapper raises:
    # an eval context never gives way to the einsum-softmax path silently
    with pytest.raises(RuntimeError, match="no backward"):
        tunet.conditional_decoder(
            flow.p.sub("decoder.estimator"), cfg.flow.estimator, x, None, mu,
            torch.tensor([0.2, 0.7]), torch.zeros((2, 80)), cond,
            Ctx(lora=state.loras["flow"], lora_scale=2.0))
