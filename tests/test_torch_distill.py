"""MeanFlow distillation and the few-step sampler in the port against the JAX
package on the CPU, at the tiny configuration and on JAX's own draws:

- the estimator's ``s`` branch (a trained-looking, nonzero branch), the
  student equal to the teacher at init, distilled weights through the
  strict loaders (and no other unknown key);
- ``cfm_solve_mean``, ``flow_inference`` and ``flow2_inference`` under
  ``sampler="meanflow"`` (z and the fixed noise as JAX draws them);
- both distillation targets' losses and gradients (CosyVoice-300M), the
  CosyVoice2 loss in streaming, and two ``FlowDistiller`` steps;
- the sampler on every serving path: ``TTSPipeline`` whole, streamed,
  batched, stream-batched and the engine, ``TTS2Pipeline``, the refusals,
  the prompted warning, and the server's ``--sampler meanflow`` flags.

Tolerances (PERF.md section 2): 2e-4 for modules, cosine >= 0.9999 for
gradients, 1e-4 x max(1, max|p|) for parameters after two steps.  One
intra-op thread; JAX references under jax.jit."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cosy_tpu.config import tiny_model_config as j_tiny
from cosy_tpu.ctx import EVAL as JEVAL
from cosy_tpu.layers.unet import conditional_decoder as j_decoder
from cosy_tpu.models import flow as JF
from cosy_tpu.models import flow2 as JF2
from cosy_tpu.params import P as JP
from cosy_tpu.train import distill as JD
from cosy_tpu_torch import config as TC
from cosy_tpu_torch.infer import pipeline as TPIPE
from cosy_tpu_torch.infer import pipeline2 as TP2
from cosy_tpu_torch.infer.engine import ContinuousBatchEngine
from cosy_tpu_torch.layers.unet import conditional_decoder as t_decoder
from cosy_tpu_torch.models import flow as TF
from cosy_tpu_torch.models import flow2 as TF2
from cosy_tpu_torch.models.hift import init_hift_params
from cosy_tpu_torch.models.llm import init_llm_params
from cosy_tpu_torch.params import P as TP, from_numpy, save_torch_checkpoint
from cosy_tpu_torch.train import distill as TD
from test_torch_common import assert_close, grad_agreement, port_config, port_init, t
from test_torch_cv2 import jax_config
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=2e-4, rtol=2e-4)
JCFG = j_tiny()
TCFG = port_config(JCFG)
EST = "decoder.estimator."
WAIT = 120


@pytest.fixture(scope="module")
def weights():
    """(teacher, JAX-branched student flow, a trained-looking branch) as
    flat numpy dicts."""
    teacher = port_init(TF.init_flow_params, JCFG.flow, seed=1)
    branched = {k: np.asarray(v) for k, v in JD.add_meanflow_time_branch(
        {k: jnp.asarray(v) for k, v in teacher.items()}, JCFG.flow.estimator,
        jax.random.PRNGKey(3)).items()}
    trained = dict(branched)
    rng = np.random.default_rng(4)
    for k in ("time_mlp_s.linear_2.weight", "time_mlp_s.linear_2.bias"):
        trained[EST + k] = (0.1 * rng.standard_normal(trained[EST + k].shape)).astype(np.float32)
    return teacher, branched, trained


def _jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _est_inputs(B=2, T=16, seed=5):
    rng = np.random.default_rng(seed)
    C = JCFG.flow.output_size
    x, mu, cond = (rng.standard_normal((B, C, T)).astype(np.float32) for _ in range(3))
    spks = rng.standard_normal((B, C)).astype(np.float32)
    mask = np.ones((B, 1, T), np.float32)
    mask[1, :, 11:] = 0.0
    return x, mask, mu, spks, cond


def test_s_branch_matches_jax(weights):
    _, _, trained = weights
    x, mask, mu, spks, cond = _est_inputs()
    tt, s = np.asarray([0.2, 0.6], np.float32), np.asarray([0.7, 0.6], np.float32)
    want = jax.jit(lambda p, *a: j_decoder(JP(p, EST), JCFG.flow.estimator, *a[:6], JEVAL,
                                           s=a[6]))(_jnp(trained), x, mask, mu, tt, spks, cond, s)
    got = t_decoder(TP(from_numpy(trained, "cpu"), EST), TCFG.flow.estimator, t(x), t(mask),
                    t(mu), t(tt), t(spks), t(cond), s=t(s))
    assert_close(got, want, **TOL)
    plain = t_decoder(TP(from_numpy(trained, "cpu"), EST), TCFG.flow.estimator, t(x), t(mask),
                      t(mu), t(tt), t(spks), t(cond))
    assert (got - plain).abs().max() > 1e-3  # the branch moves the field


def test_student_equals_teacher_at_init(weights):
    teacher, _, _ = weights
    tp = from_numpy(teacher, "cpu")
    branched = TD.add_meanflow_time_branch(tp, TCFG.flow.estimator,
                                           torch.Generator().manual_seed(3))
    assert set(branched) - set(tp) == {EST + f"time_mlp_s.linear_{i}.{w}" for i in (1, 2)
                                       for w in ("weight", "bias")}
    x, mask, mu, spks, cond = (t(a) for a in _est_inputs())
    tt, s = torch.tensor([0.3, 0.7]), torch.tensor([0.9, 0.7])
    v = t_decoder(TP(tp, EST), TCFG.flow.estimator, x, mask, mu, tt, spks, cond)
    u0 = t_decoder(TP(branched, EST), TCFG.flow.estimator, x, mask, mu, tt, spks, cond, s=s)
    assert torch.equal(v, u0)


def _model_dir(d, flow):
    """llm / flow / hift.pt of the tiny configuration in ``d``, ``flow`` (a
    flat numpy dict) as its flow."""
    for name, flat in (("llm", port_init(init_llm_params, JCFG.llm, seed=1)), ("flow", flow),
                       ("hift", port_init(init_hift_params, JCFG.hift, seed=3))):
        save_torch_checkpoint(from_numpy(flat, "cpu"), str(d / f"{name}.pt"))


def _distilled_flow2(fcfg, seed=2):
    """A seeded ``Flow2`` that took a branched state dict (the strict load
    adds the branch)."""
    base = TF2.init_flow2_params(fcfg, "cpu", seed=seed)
    flow = TF2.Flow2(fcfg, "cpu")
    flow.load_state_dict(TD.add_meanflow_time_branch(dict(base.p.d), fcfg.estimator,
                                                     torch.Generator().manual_seed(seed)))
    return flow


def test_distilled_weights_through_the_strict_loaders(weights, tmp_path):
    from cosy_tpu_torch.compat.loader import load_or_init

    teacher, branched, _ = weights
    flow = TF.Flow(TCFG.flow, "cpu")
    assert not TF.is_distilled(flow)
    flow.load_state_dict(from_numpy(branched, "cpu"), strict=True)
    assert TF.is_distilled(flow) and TF.is_distilled(branched)
    base = TF.Flow(TCFG.flow, "cpu")
    base.load_state_dict(from_numpy(teacher, "cpu"), strict=True)
    assert not TF.is_distilled(base)
    with pytest.raises(RuntimeError, match="Unexpected"):
        TF.Flow(TCFG.flow, "cpu").load_state_dict(
            {**from_numpy(branched, "cpu"), EST + "time_mlp_x.weight": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="Missing"):  # a distilled module needs its branch
        flow.load_state_dict(from_numpy(teacher, "cpu"))
    assert TF.is_distilled(_distilled_flow2(TP2_FCFG))
    # a model dir whose flow.pt is distilled loads strictly through load_or_init
    _model_dir(tmp_path, branched)
    loaded = load_or_init(str(tmp_path), TCFG, "cpu")["flow"]
    assert TF.is_distilled(loaded)
    assert_close(loaded.p[EST + "time_mlp_s.linear_1.weight"],
                 branched[EST + "time_mlp_s.linear_1.weight"], atol=0, rtol=0)


@pytest.mark.parametrize("steps", [1, 2])
def test_cfm_solve_mean_matches_jax(weights, steps):
    _, _, trained = weights
    z, mask, mu, spks, cond = _est_inputs(seed=6)
    want = jax.jit(lambda p, *a: JF.cfm_solve_mean(JP(p, EST), JCFG.flow, *a, steps))(
        _jnp(trained), z, mask, mu, spks, cond)
    got = TF.cfm_solve_mean(TP(from_numpy(trained, "cpu"), EST), TCFG.flow, t(z), t(mask),
                            t(mu), t(spks), t(cond), steps)
    assert_close(got, want, **TOL)
    with pytest.raises(ValueError, match=">= 1"):
        TF.cfm_solve_mean(TP(from_numpy(trained, "cpu"), EST), TCFG.flow, t(z), t(mask),
                          t(mu), t(spks), t(cond), 0)


def test_flow_inference_meanflow_matches_jax(weights):
    """Prompt-free, an odd mel length (padded and masked), the default
    2 steps, finetuned norm; z as JAX draws it from the key."""
    _, _, trained = weights
    rng = np.random.default_rng(7)
    tok = rng.integers(0, 128, (1, 15)).astype(np.int32)
    spk = rng.standard_normal((1, 192)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    T = int(15 / 50 * 22050 / 256)
    T_pad = T + T % 2
    z = np.asarray(jax.random.normal(key, (1, 80, T_pad)))
    want = jax.jit(lambda p, tk, sp: JF.flow_inference(
        JP(p), JCFG.flow, key, tk, jnp.zeros((1, 0), jnp.int32), jnp.zeros((1, 0, 80)), sp,
        finetuned_norm=True, sampler="meanflow"))(_jnp(trained), jnp.asarray(tok),
                                                   jnp.asarray(spk))
    got = TF.flow_inference(TP(from_numpy(trained, "cpu")), TCFG.flow, torch.as_tensor(tok).long(),
                            torch.zeros((1, 0), dtype=torch.long), torch.zeros((1, 0, 80)),
                            t(spk), finetuned_norm=True, z=t(z), sampler="meanflow")
    assert T % 2 == 1 and got.shape == (1, 80, T)
    assert_close(got, want, **TOL)


TP2_FCFG = TD.tiny_flow2_config()


def _flow2_flat():
    return {k: v.numpy() for k, v in
            TF2.init_flow2_params(TP2_FCFG, "cpu", seed=2).state_dict().items()}


def test_flow2_inference_meanflow_matches_jax():
    flat = _flow2_flat()
    jb = {k: np.asarray(v) for k, v in JD.add_meanflow_time_branch(
        _jnp(flat), jax_config(TP2_FCFG).estimator, jax.random.PRNGKey(3)).items()}
    rng = np.random.default_rng(9)
    jb[EST + "time_mlp_s.linear_2.weight"] = 0.1 * rng.standard_normal(
        jb[EST + "time_mlp_s.linear_2.weight"].shape).astype(np.float32)
    tok = rng.integers(0, 128, (1, 11)).astype(np.int32)
    spk = rng.standard_normal((1, 192)).astype(np.float32)
    for streaming, finalize in ((False, True), (True, False)):
        want = jax.jit(lambda p, tk, sp: JF2.flow2_inference(
            JP(p), jax_config(TP2_FCFG), tk, jnp.zeros((1, 0), jnp.int32),
            jnp.zeros((1, 0, 80)), sp, streaming=streaming, finalize=finalize, n_timesteps=2,
            sampler="meanflow"))(_jnp(jb), jnp.asarray(tok), jnp.asarray(spk))
        got = TF2.flow2_inference(TP(from_numpy(jb, "cpu")), TP2_FCFG, torch.as_tensor(tok).long(),
                                  torch.zeros((1, 0), dtype=torch.long),
                                  torch.zeros((1, 0, 80)), t(spk), streaming=streaming,
                                  finalize=finalize, n_timesteps=2, sampler="meanflow")
        assert_close(got, want, **TOL)


def _batch(B=2, T=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"speech_token": rng.integers(0, 128, (B, 8)).astype(np.int32),
            "speech_token_len": np.asarray([8, 6], np.int32)[:B],
            "speech_feat": (rng.standard_normal((B, T, 80)) * 2 - 6).astype(np.float32),
            "speech_feat_len": np.asarray([16, 12], np.int32)[:B],
            "embedding": rng.standard_normal((B, 192)).astype(np.float32)}


def _core_draws(key, B, shape, inst_frac=0.25):
    """JAX's (t, s, z) of meanflow_distill_loss from its key."""
    kt, ks, ke, kz = jax.random.split(key, 4)
    tt = jax.random.uniform(kt, (B,))
    s = tt + (1.0 - tt) * jax.random.uniform(ks, (B,))
    s = jnp.where(jax.random.uniform(ke, (B,)) < inst_frac, tt, s)
    return tuple(np.asarray(a) for a in (tt, s, jax.random.normal(kz, shape)))


@pytest.mark.parametrize("target", ["integral", "jvp"])
def test_distill_loss_and_gradients_match_jax(weights, target):
    teacher, _, trained = weights
    batch = _batch()
    key = jax.random.PRNGKey(11)
    student = JD.student_subset(_jnp(trained))
    loss_j, grad_j = jax.jit(jax.value_and_grad(lambda st: JD.flow_distill_loss(
        st, _jnp(teacher), JCFG.flow, key, _jnp(batch), target=target)))(student)
    st = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in student.items()}
    loss = TD.flow_distill_loss(st, from_numpy(teacher, "cpu"), TCFG.flow, None,
                                {k: torch.from_numpy(v) for k, v in batch.items()},
                                target=target, noise=_core_draws(key, 2, (2, 80, 16)))
    loss.backward()
    assert_close(loss.detach(), loss_j, **TOL)
    cos, _ = grad_agreement({k: v.grad.numpy() for k, v in st.items()},
                            {k: np.asarray(v) for k, v in grad_j.items()})
    assert cos >= 0.9999


def test_flow2_distill_loss_streaming_matches_jax():
    """The CosyVoice2 wrapper in streaming: JAX's prompt draws (drop,
    length) and core draws passed in; loss and gradients."""
    flat = _flow2_flat()
    jcfg = jax_config(TP2_FCFG)
    jb = {k: np.asarray(v) for k, v in JD.add_meanflow_time_branch(
        _jnp(flat), jcfg.estimator, jax.random.PRNGKey(3)).items()}
    rng = np.random.default_rng(12)
    B, T = 2, 24
    batch = {"speech_token": rng.integers(0, 128, (B, 12)).astype(np.int32),
             "speech_token_len": np.asarray([12, 9], np.int32),
             "speech_feat": (rng.standard_normal((B, T, 80))).astype(np.float32),
             "speech_feat_len": np.asarray([24, 20], np.int32),
             "embedding": rng.standard_normal((B, 192)).astype(np.float32)}
    key = jax.random.PRNGKey(13)
    student = JD.student_subset(_jnp(jb))
    loss_j, grad_j = jax.jit(jax.value_and_grad(lambda st: JD.flow2_distill_loss(
        st, _jnp(flat), jcfg, key, _jnp(batch), streaming=True)))(student)
    k_cond, k_len, k_core = jax.random.split(key, 3)
    draws = {"drop": np.asarray(jax.random.bernoulli(k_cond, 0.5, (B,))),
             "plen_u": np.asarray(jax.random.uniform(k_len, (B,)))}
    st = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in student.items()}
    loss = TD.flow2_distill_loss(st, from_numpy(flat, "cpu"), TP2_FCFG, None,
                                 {k: torch.from_numpy(v) for k, v in batch.items()},
                                 streaming=True, noise=_core_draws(k_core, B, (B, 80, T)),
                                 draws=draws)
    loss.backward()
    assert_close(loss.detach(), loss_j, **TOL)
    cos, _ = grad_agreement({k: v.grad.numpy() for k, v in st.items()},
                            {k: np.asarray(v) for k, v in grad_j.items()})
    assert cos >= 0.9999


def test_two_distiller_steps_match_jax(weights):
    """JAX's FlowDistiller (threefry keys) and the port's from the same
    branched student, each step on JAX's draws: the student after two steps
    within 1e-4 x max(1, max|p|), and the export's sidecar."""
    teacher, _, _ = weights
    jd = JD.FlowDistiller(JCFG.flow, _jnp(teacher), lr=1e-3, prng_impl="threefry2x32")
    jstate = jd.init_state()
    start = {k: np.asarray(v) for k, v in jstate.student.items()}
    td = TD.FlowDistiller(TCFG.flow, from_numpy(teacher, "cpu"), lr=1e-3)
    tstate = td.init_state(student=from_numpy(start, "cpu"))
    for step in range(2):
        batch = _batch(seed=20 + step)
        draws = _core_draws(jax.random.fold_in(jd.rng, step), 2, (2, 80, 16))
        lj = float(jd.step(jstate, batch))
        lt = float(td.step(tstate, batch, noise=draws))
        np.testing.assert_allclose(lt, lj, **TOL)
    for k, v in jstate.student.items():
        want = np.asarray(v)
        assert_close(tstate.student[k], want, atol=1e-4 * max(1.0, np.abs(want).max()), rtol=0,
                     name=k)


# -- the sampler on the serving paths -------------------------------------


@pytest.fixture(scope="module")
def mf_pipe(weights):
    """A tiny TTSPipeline on distilled (trained-looking) flow weights under
    the MeanFlow sampler; decodes of at most 3 tokens a text id."""
    _, _, trained = weights
    flow = TF.Flow(TCFG.flow, "cpu")
    flow.load_state_dict(from_numpy(trained, "cpu"))
    icfg = TC.InferenceConfig(sampler="meanflow", meanflow_steps=2, max_token_text_ratio=3.0,
                              min_token_text_ratio=2.0)
    return TPIPE.TTSPipeline(TCFG, init_llm_params(TCFG.llm, "cpu", seed=1), flow,
                             init_hift_params(TCFG.hift, "cpu", seed=3), icfg)


def _count_solves(monkeypatch):
    """Record the step count of every MeanFlow solve; an Euler solve fails."""
    calls = []
    mean = TF.cfm_solve_mean

    def record(*a, **k):
        calls.append(a[7])
        return mean(*a, **k)

    def euler(*a, **k):
        raise AssertionError("an Euler solve under the MeanFlow sampler")

    monkeypatch.setattr(TF, "cfm_solve_mean", record)
    monkeypatch.setattr(TF, "cfm_solve_euler", euler)
    return calls


def test_every_v1_serving_path_takes_the_meanflow_sampler(mf_pipe, monkeypatch, capsys):
    calls = _count_solves(monkeypatch)
    ids = [np.random.default_rng(i).integers(0, 256, (1, 6 + i)) for i in range(2)]
    spk = np.zeros((1, 192), np.float32)
    out = list(mf_pipe.synthesize(ids[0], spk_embedding=spk, seed=1))
    assert len(calls) == 1 and np.isfinite(out[0]["tts_speech"]).all()
    n = len(calls)
    list(mf_pipe.synthesize(ids[1], spk_embedding=spk, seed=2, stream=True))
    wavs = mf_pipe.synthesize_batch(ids, seed=3)
    list(mf_pipe.synthesize_stream_batch(ids, seed=4))
    assert len(calls) > n + 2 and set(calls) == {2}
    assert all(np.isfinite(w).all() for w in wavs)
    eng = ContinuousBatchEngine(mf_pipe, slots=2, prefix_len=32, max_len=64)
    try:
        n = len(calls)
        req = eng.submit(ids[0], seed=5)
        chunks = [c[0] for c in req.chunks(timeout=WAIT)]
        assert chunks and all(np.isfinite(c).all() for c in chunks) and len(calls) > n
    finally:
        eng.stop()
    # a prompted call warns once: the student was distilled prompt-free
    mf_pipe.token2wav(ids[0][:, :4] % 128, spk, prompt_token=np.zeros((1, 4), np.int64),
                      prompt_feat=np.zeros((1, 6, 80), np.float32),
                      generator=torch.Generator().manual_seed(0))
    assert "meanflow sampler with a prompt" in capsys.readouterr().out


def test_v1_pipeline_refuses_the_sampler_on_undistilled_weights(weights):
    teacher, _, _ = weights
    mods = (init_llm_params(TCFG.llm, "meta"), TF.Flow(TCFG.flow, "meta"),
            init_hift_params(TCFG.hift, "meta"))
    with pytest.raises(ValueError, match="MeanFlow-distilled"):
        TPIPE.TTSPipeline(TCFG, *mods, TC.InferenceConfig(sampler="meanflow"))
    with pytest.raises(ValueError, match=">= 1"):
        TPIPE.TTSPipeline(TCFG, *mods, TC.InferenceConfig(meanflow_steps=0))


def test_tts2_pipeline_takes_the_meanflow_sampler(monkeypatch):
    """Whole and streamed CosyVoice2 synthesis on distilled tiny weights:
    every flow call takes the sampler and its step count."""
    from test_torch_cv2 import HCFG, LCFG
    from cosy_tpu_torch.models.qwen2lm import init_qwen2lm_params

    fcfg = dataclasses.replace(TP2_FCFG, vocab_size=LCFG.speech_token_size, spk_embed_dim=192)
    flow = _distilled_flow2(fcfg)
    seen = []
    real = TP2.flow2_inference

    def record(*a, **k):
        seen.append((k["sampler"], k["n_timesteps"]))
        return real(*a, **k)

    monkeypatch.setattr(TP2, "flow2_inference", record)
    pipe = TP2.TTS2Pipeline(LCFG, fcfg, HCFG, init_qwen2lm_params(LCFG, "cpu", seed=1), flow,
                            init_hift_params(HCFG, "cpu", seed=3),
                            TC.InferenceConfig(sampler="meanflow", meanflow_steps=1,
                                               max_token_text_ratio=3.0), hop_samples=256)
    ids = np.random.default_rng(0).integers(0, 50, (1, 12))
    for stream in (False, True):
        for out in pipe.synthesize(ids, seed=1, stream=stream):
            assert np.isfinite(out["tts_speech"]).all()
    assert seen and set(seen) == {("meanflow", 1)}


def test_server_meanflow_flags(weights, tmp_path, monkeypatch):
    """``--sampler meanflow --flow-weights distilled.pt`` serves the
    distilled flow under the sampler, and so does a model dir whose
    ``flow.pt`` is distilled; distilled weights without the flag, and the
    flag on undistilled weights, are refused by the pipeline's check."""
    import cosy_tpu_torch.api as TAPI
    from cosy_tpu_torch.serve import build_parser, build_server

    teacher, _, trained = weights
    _model_dir(tmp_path, teacher)
    dist = str(tmp_path / "flow_distilled.pt")
    save_torch_checkpoint(from_numpy(trained, "cpu"), dist)
    real = TAPI.CosyVoice
    # the tiny topology: the model dir has no cosyvoice.yaml
    monkeypatch.setattr(TAPI, "CosyVoice", lambda d, **kw: real(d, model_cfg=TCFG, **kw))
    common = ["--model-dir", str(tmp_path), "--device", "cpu", "--finetuned-norm", "1"]
    server = build_server(build_parser().parse_args(
        common + ["--flow-weights", dist, "--sampler", "meanflow", "--meanflow-steps", "1"]))
    model = server.api.model
    assert model.icfg.sampler == "meanflow" and model.icfg.meanflow_steps == 1
    assert TF.is_distilled(model.flow_p.d)
    assert_close(model.flow_p[EST + "time_mlp_s.linear_2.weight"],
                 trained[EST + "time_mlp_s.linear_2.weight"], atol=0, rtol=0)
    with pytest.raises(SystemExit, match="MeanFlow-distilled"):
        build_server(build_parser().parse_args(common + ["--flow-weights", dist]))
    with pytest.raises(SystemExit, match="needs MeanFlow-distilled"):
        build_server(build_parser().parse_args(
            common + ["--flow-weights", str(tmp_path / "flow.pt"), "--sampler", "meanflow"]))
    with pytest.raises(SystemExit, match=">= 1"):
        build_server(build_parser().parse_args(common + ["--flow-weights", dist, "--sampler",
                                                         "meanflow", "--meanflow-steps", "0"]))
    _model_dir(tmp_path, trained)  # a model dir whose own flow.pt is distilled
    server = build_server(build_parser().parse_args(common + ["--sampler", "meanflow"]))
    assert server.api.model.icfg.meanflow_steps == 2
    with pytest.raises(SystemExit, match="MeanFlow-distilled"):
        build_server(build_parser().parse_args(common))


def test_api_refuses_the_euler_solve_on_distilled_weights(weights, tmp_path):
    """``CosyVoice(model_dir)`` on a distilled ``flow.pt`` takes
    ``sampler="meanflow"`` and refuses the default Euler solve; so does
    ``TTS2Pipeline`` on a distilled ``Flow2``."""
    from cosy_tpu_torch.api import CosyVoice
    from cosy_tpu_torch.models.hift import HiFT
    from cosy_tpu_torch.models.qwen2lm import Qwen2LM
    from test_torch_cv2 import HCFG, LCFG

    _, _, trained = weights
    _model_dir(tmp_path, trained)
    with pytest.raises(ValueError, match="MeanFlow-distilled"):
        CosyVoice(str(tmp_path), model_cfg=TCFG, device="cpu")
    api = CosyVoice(str(tmp_path), model_cfg=TCFG, device="cpu",
                    infer_cfg=TC.InferenceConfig(sampler="meanflow", meanflow_steps=1))
    assert api.model.icfg.sampler == "meanflow" and TF.is_distilled(api.model.flow_p.d)
    mods = (Qwen2LM(LCFG, "meta"), _distilled_flow2(TP2_FCFG), HiFT(HCFG, "meta"))
    with pytest.raises(ValueError, match="MeanFlow-distilled"):
        TP2.TTS2Pipeline(LCFG, TP2_FCFG, HCFG, *mods, TC.InferenceConfig())
