"""Multi-voice LoRA serving in the port (CPU) against the JAX package and
against merged weights: voice-stacked dense and 1x1-conv routing in both
layouts (2e-5 against ``cosy_tpu/layers/basic.py``); decode logits with
per-row adapters against JAX's causal forward with each row's voice
(2e-4); unvoiced rows bit-identical to the adapter-free decode; a voice
carried through ``llm_admit_slot``; ``flow_inference`` with adapters against
JAX (injected z) and against the port's merged weights; the refusal of
adapter targets the decode cannot route; a voiced ``synthesize`` (whole and
streamed) equal to a pipeline built on that voice's merged weights; an
unknown voice; the trainer's adapter export read back by
``load_voice_adapters``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cosy_tpu.config import tiny_model_config as j_tiny
from cosy_tpu.ctx import Ctx as JCtx
from cosy_tpu.layers.basic import conv1d as j_conv1d, conv1d_nwc as j_conv1d_nwc, dense as j_dense
from cosy_tpu.models import flow as JF
from cosy_tpu.params import P as JP
from cosy_tpu_torch.config import InferenceConfig, LoRAConfig, TrainConfig
from cosy_tpu_torch.ctx import Ctx
from cosy_tpu_torch.infer.pipeline import TTSPipeline
from cosy_tpu_torch.layers.basic import conv1d, conv1d_nwc, dense
from cosy_tpu_torch.lora import init_lora, merge_lora, stack_voice_loras
from cosy_tpu_torch.models import flow as TF
from cosy_tpu_torch.models import llm as TL
from cosy_tpu_torch.models.flow import Flow
from cosy_tpu_torch.models.llm import TransformerLM
from cosy_tpu_torch.params import P
from test_torch_common import assert_close, port_config, port_modules, t, tiny_flats
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

KTOL = dict(atol=2e-5, rtol=2e-5)
TOL = dict(atol=2e-4, rtol=2e-4)
LLM_LORA = LoRAConfig(r=2, alpha=4, dropout=0.0)
FLOW_LORA = LoRAConfig(r=2, alpha=4, dropout=0.0,
                       target_modules=("to_q", "to_k", "to_v", "w_1", "w_2"))
IDS = np.asarray([[3, 9, 2, 7, 1, 4]], np.int64)
SPK = np.zeros((1, 192), np.float32)
SHORT = InferenceConfig(max_token_text_ratio=3.0)  # whole requests: 12-18 tokens
# streamed requests: EOS held off, 130 tokens capped -> a 120-token window, then
# the bucketed final
LONG = InferenceConfig(min_token_text_ratio=25.0, max_token_text_ratio=25.0)


def _adapters(params, cfg, seed, amp=8.0):
    """One voice's adapters, B amplified so voices differ above rounding."""
    lo = init_lora(torch.Generator().manual_seed(seed), params, cfg)
    return {k: (v * amp if ".lora_B" in k else v).detach() for k, v in lo.items()}


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_tiny()
    tcfg = port_config(jcfg)
    flats = tiny_flats(jcfg)
    llm, flow, hift = port_modules(tcfg, flats)
    voices = {name: {"llm": _adapters(llm.p.d, LLM_LORA, seed),
                     "flow": _adapters(flow.p.d, FLOW_LORA, seed + 100)}
              for name, seed in (("alice", 7), ("bob", 8))}
    return jcfg, tcfg, flats, (llm, flow, hift), voices


def _pipe(tcfg, mods, voices=None, finetuned_norm=True, icfg=SHORT):
    pipe = TTSPipeline(tcfg, *mods, icfg, finetuned_norm=finetuned_norm)
    if voices is not None:
        pipe.set_voices(voices, llm_scale=LLM_LORA.scaling, flow_scale=FLOW_LORA.scaling)
    return pipe


def _merged_pipe(tiny, voice, finetuned_norm=True, icfg=SHORT):
    _, tcfg, _, (llm, flow, hift), voices = tiny
    ml, mf = TransformerLM(tcfg.llm, "cpu"), Flow(tcfg.flow, "cpu")
    ml.load_state_dict(merge_lora(llm.p.d, voices[voice]["llm"], LLM_LORA.scaling))
    mf.load_state_dict(merge_lora(flow.p.d, voices[voice]["flow"], FLOW_LORA.scaling))
    return _pipe(tcfg, (ml, mf, hift), finetuned_norm=finetuned_norm, icfg=icfg)


@pytest.fixture(scope="module")
def voiced(tiny):
    _, tcfg, _, mods, voices = tiny
    return _pipe(tcfg, mods, voices)


def _wav(pipe, voice, stream=False, seed=5):
    outs = pipe.synthesize(IDS, spk_embedding=SPK, stream=stream, voice=voice, seed=seed,
                           max_len_cap=130)
    return np.concatenate([o["tts_speech"] for o in outs], axis=1)


# -- layers --------------------------------------------------------------


@pytest.mark.parametrize("kind", ["dense", "conv_bct", "conv_btc"])
def test_stacked_routing_matches_jax(kind):
    """Row b of a voice-stacked call takes voice vids[b]'s delta, as
    cosy_tpu/layers/basic.py routes it; without lora_vids it raises."""
    rng = np.random.default_rng(0)
    V, B, Cin, Cout, T, r = 3, 4, 6, 5, 7, 2
    conv = kind != "dense"
    w = rng.standard_normal((Cout, Cin, 1) if conv else (Cout, Cin)).astype(np.float32)
    params = {"c.weight": w, "c.bias": rng.standard_normal(Cout).astype(np.float32)}
    sfx = ".weight" if conv else ""
    a = rng.standard_normal((V, r, Cin) + ((1,) if conv else ())).astype(np.float32)
    b = rng.standard_normal((V, Cout, r) + ((1,) if conv else ())).astype(np.float32)
    vids = rng.integers(0, V, B)
    lo = {f"c.lora_A{sfx}": a, f"c.lora_B{sfx}": b}
    x = rng.standard_normal({"dense": (B, T, Cin), "conv_bct": (B, Cin, T),
                             "conv_btc": (B, T, Cin)}[kind]).astype(np.float32)
    jfn, tfn = {"dense": (j_dense, dense), "conv_bct": (j_conv1d, conv1d),
                "conv_btc": (j_conv1d_nwc, conv1d_nwc)}[kind]
    jctx = JCtx(lora={k: jnp.asarray(v) for k, v in lo.items()}, lora_scale=2.0,
                lora_vids=jnp.asarray(vids, jnp.int32))
    want = jfn(JP({k: jnp.asarray(v) for k, v in params.items()}), "c", jnp.asarray(x),
               ctx=jctx)
    tp = P({k: t(v) for k, v in params.items()})
    tlo = {k: t(v) for k, v in lo.items()}
    got = tfn(tp, "c", t(x), ctx=Ctx(lora=tlo, lora_scale=2.0,
                                     lora_vids=torch.as_tensor(vids)))
    assert_close(got, np.asarray(want), **KTOL)
    with pytest.raises(ValueError, match="lora_vids"):
        tfn(tp, "c", t(x), ctx=Ctx(lora=tlo, lora_scale=2.0))


# -- the decode ----------------------------------------------------------


def _jax_voice_logits(jcfg, flats, voice_np, x_emb):
    """JAX's causal forward with one voice's adapters through its Ctx."""
    jp = {k: jnp.asarray(v) for k, v in flats["llm"].items()}
    ctx = JCtx(lora={k: jnp.asarray(v) for k, v in voice_np.items()},
               lora_scale=LLM_LORA.scaling)
    fn = jax.jit(lambda p, x: _causal_forward_ctx(p, jcfg.llm, x, ctx))
    return np.asarray(fn(jp, jnp.asarray(x_emb)))


def _causal_forward_ctx(jp, jlcfg, x_emb, ctx):
    from cosy_tpu.layers.basic import layer_norm as j_ln
    from cosy_tpu.layers.conformer import transformer_layer as j_layer
    from cosy_tpu.layers.posenc import rel_pos_table as j_table
    from cosy_tpu.models import llm as JL
    from cosy_tpu.ops.masks import NEG_BIAS

    p = JP(jp)
    sp = p.sub("llm")
    x = JL._token_embed_legacy(sp, jlcfg.llm.output_size, x_emb.dtype)(x_emb)
    L = x.shape[1]
    causal = jnp.where(jnp.arange(L)[:, None] >= jnp.arange(L)[None, :], 0.0, NEG_BIAS)[None]
    pe = j_table(L, jlcfg.llm.output_size)
    for i in range(jlcfg.llm.num_blocks):
        x = j_layer(sp, f"encoders.{i}", jlcfg.llm, x, causal, pe, ctx)
    x = j_ln(sp, "after_norm", x, eps=1e-5)
    return j_dense(p, "llm_decoder", x)[0]


def _np(d):
    return {k: v.numpy() for k, v in d.items()}


def test_batched_decode_logits_with_adapters_match_jax(tiny):
    """Three left-padded rows, each with its own voice (the last the base
    zero row), fed forced tokens: every step's logits equal JAX's causal
    forward of the row's unpadded prefix with that voice's adapters."""
    jcfg, tcfg, flats, (llm, _, _), voices = tiny
    bank = stack_voice_loras([voices["alice"]["llm"], voices["bob"]["llm"]])
    bank = {k: torch.cat([v, torch.zeros_like(v[:1])]) for k, v in bank.items()}
    rng = np.random.default_rng(1)
    lens, vids, n = (5, 8, 6), (1, 0, 2), 5
    pre = [rng.standard_normal((1, m, 16)).astype(np.float32) for m in lens]
    L0 = max(lens)
    padded = torch.cat([t(np.pad(x, ((0, 0), (L0 - x.shape[1], 0), (0, 0)))) for x in pre])
    toks = rng.integers(0, jcfg.llm.speech_token_size, (3, n))
    got = TL.llm_teacher_forced_logits(llm.p, tcfg.llm, padded, lens, toks.tolist(),
                                       lora=bank, vids=vids, lora_scale=LLM_LORA.scaling)
    emb = flats["llm"]["speech_embedding.weight"]
    names = ["alice", "bob"]
    for b in range(3):
        x = np.concatenate([pre[b], emb[toks[b]][None]], 1)
        lo = _np(voices[names[vids[b]]]["llm"]) if vids[b] < 2 else \
            {k: np.zeros_like(v) for k, v in _np(voices["alice"]["llm"]).items()}
        want = _jax_voice_logits(jcfg, flats, lo, x)[lens[b] - 1:]
        assert_close(got[b], want, **TOL, name=f"row {b}")


def test_unvoiced_rows_bit_identical_and_solo_voice(tiny):
    """A mixed batch (voice 0, the base zero row) against the adapter-free
    batch: the base row's tokens and logits are bit-identical; the voiced
    row's tokens equal a solo decode with that voice's own dict."""
    _, tcfg, _, (llm, _, _), voices = tiny
    bank = stack_voice_loras([voices["alice"]["llm"]])
    bank = {k: torch.cat([v, torch.zeros_like(v[:1])]) for k, v in bank.items()}
    rng = np.random.default_rng(2)
    prefix = t(rng.standard_normal((2, 6, 16)).astype(np.float32))
    gens = lambda: [torch.Generator().manual_seed(s) for s in (3, 4)]  # noqa: E731
    kw = dict(lora_scale=LLM_LORA.scaling)
    mixed = TL.llm_decode_start(llm.p, tcfg.llm, prefix, [6, 6], [2, 2], [14, 14], gens(),
                                lora=bank, vids=[0, 1], **kw).run()
    plain = TL.llm_decode_start(llm.p, tcfg.llm, prefix, [6, 6], [2, 2], [14, 14],
                                gens()).run()
    assert mixed.tokens[1] == plain.tokens[1]
    toks = [mixed.tokens[1][:6]] * 2
    lm = TL.llm_teacher_forced_logits(llm.p, tcfg.llm, prefix, [6, 6], toks, lora=bank,
                                      vids=[0, 1], **kw)
    lp = TL.llm_teacher_forced_logits(llm.p, tcfg.llm, prefix, [6, 6], toks)
    assert torch.equal(lm[1], lp[1])
    solo = TL.llm_decode(llm.p, tcfg.llm, prefix[:1], 2, 14,
                         generator=torch.Generator().manual_seed(3),
                         lora=voices["alice"]["llm"], **kw)
    assert mixed.tokens[0] == solo


def test_admit_slot_carries_voice(tiny):
    """A request admitted mid-flight with voice 1 decodes that voice's solo
    tokens; an admission without a voice into an adapter state refuses."""
    _, tcfg, _, (llm, _, _), voices = tiny
    bank = stack_voice_loras([voices["alice"]["llm"], voices["bob"]["llm"]])
    rng = np.random.default_rng(3)
    prefix = t(rng.standard_normal((2, 6, 16)).astype(np.float32))
    kw = dict(lora_scale=LLM_LORA.scaling)
    st = TL.llm_decode_start(llm.p, tcfg.llm, prefix, [6, 6], [2, 2], [16, 16],
                             [torch.Generator().manual_seed(s) for s in (5, 6)],
                             lora=bank, vids=[0, 0], **kw)
    st.run(3)
    new = t(rng.standard_normal((1, 6, 16)).astype(np.float32))
    with pytest.raises(ValueError, match="voice id"):
        TL.llm_admit_slot(st, new, 6, 2, 12, torch.Generator().manual_seed(77), 1)
    TL.llm_admit_slot(st, new, 6, 2, 12, torch.Generator().manual_seed(77), 1, vid=1)
    st.run()
    solo = TL.llm_decode(llm.p, tcfg.llm, new, 2, 12, generator=torch.Generator().manual_seed(77),
                         lora=voices["bob"]["llm"], **kw)
    assert st.tokens[1] == solo and st.vids == [0, 1]


def test_decode_refuses_unroutable_targets(tiny):
    _, tcfg, _, _, voices = tiny
    bad = dict(voices["alice"]["llm"])
    bad["llm_decoder.lora_A"] = torch.zeros(2, 16)
    bad["llm_decoder.lora_B"] = torch.zeros(tcfg.llm.speech_token_size + 1, 2)
    with pytest.raises(ValueError, match="silently ignored"):
        TL._stack_decode_loras(bad, tcfg.llm.llm.num_blocks)
    # text_encoder adapters are prefill-only and pass
    assert any(k.startswith("text_encoder.") for k in voices["alice"]["llm"])
    TL._stack_decode_loras(voices["alice"]["llm"], tcfg.llm.llm.num_blocks)


# -- the flow ------------------------------------------------------------


def test_flow_inference_with_adapters(tiny):
    """flow_inference(lora=) against JAX's with the same z, and against the
    port's own merged flow weights; the adapters move the output."""
    jcfg, tcfg, flats, (_, flow, _), voices = tiny
    lo = voices["alice"]["flow"]
    rng = np.random.default_rng(4)
    tok = rng.integers(0, jcfg.flow.vocab_size, (1, 13))
    spk = rng.standard_normal((1, 192)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    T = int(13 / 50 * 22050 / 256)
    want = jax.jit(lambda p, lo_: JF.flow_inference(
        JP(p), jcfg.flow, key, jnp.asarray(tok), jnp.zeros((1, 0), jnp.int32),
        jnp.zeros((1, 0, 80)), jnp.asarray(spk), n_timesteps=4, finetuned_norm=True,
        lora=lo_, lora_scale=FLOW_LORA.scaling))(
        {k: jnp.asarray(v) for k, v in flats["flow"].items()},
        {k: jnp.asarray(v.numpy()) for k, v in lo.items()})
    z = t(np.asarray(jax.random.normal(key, (1, 80, T + T % 2))))

    def run(p, lora):
        return TF.flow_inference(p, tcfg.flow, t(tok, torch.long), torch.zeros((1, 0), dtype=torch.long),
                                 torch.zeros((1, 0, 80)), t(spk), n_timesteps=4,
                                 finetuned_norm=True, z=z, lora=lora,
                                 lora_scale=FLOW_LORA.scaling)

    got = run(flow.p, lo)
    assert_close(got, np.asarray(want), **TOL, name="against JAX")
    merged = run(P(merge_lora(flow.p.d, lo, FLOW_LORA.scaling)), None)
    assert_close(got, merged.numpy(), **TOL, name="against merged weights")
    assert (got - run(flow.p, None)).abs().max() > 1e-3


# -- the pipeline ----------------------------------------------------------


@pytest.mark.parametrize("stream", [False, True])
def test_voiced_synthesize_equals_merged_pipeline(tiny, voiced, stream):
    """synthesize(voice=) equals a pipeline on that voice's merged llm and
    flow weights, same seed (the reference's only multi-voice option);
    streamed: a 120-token window, then the bucketed final."""
    _, tcfg, _, mods, voices = tiny
    vpipe = _pipe(tcfg, mods, voices, icfg=LONG) if stream else voiced
    got = _wav(vpipe, "alice", stream)
    want = _wav(_merged_pipe(tiny, "alice", icfg=LONG if stream else SHORT), None, stream)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    if not stream:
        base = _wav(voiced, None)
        assert got.shape != base.shape or not np.allclose(got, base, atol=1e-4)


def test_voiced_request_denormalizes_on_base_pipeline(tiny):
    """Adapters are fine-tuned in normalized mel space: on a pipeline built
    with finetuned_norm=False a voiced request still denormalizes, as a
    merged finetuned_norm=True build does."""
    _, tcfg, _, mods, voices = tiny
    got = _wav(_pipe(tcfg, mods, voices, finetuned_norm=False), "alice")
    want = _wav(_merged_pipe(tiny, "alice", finetuned_norm=True), None)
    np.testing.assert_allclose(got, want, **TOL)


def test_voice_registry_and_unknown_voice(voiced):
    assert voiced.voice_names == ["alice", "bob"]
    voiced.voice_names.append("mallory")  # a copy, not the registry
    assert voiced.voice_names == ["alice", "bob"]
    with pytest.raises(KeyError, match="unknown voice"):
        _wav(voiced, "nobody")
    with pytest.raises(KeyError, match="unknown voice"):
        voiced.synthesize_batch([IDS], voices=["nobody"])
    bank = voiced._voice_llm_bank
    assert all(not v.requires_grad and v.shape[0] == 3 for v in bank.values())
    assert all(not v[2].any() for v in bank.values())  # the base row


def test_mixed_batch_base_rows_equal_unvoiced_batch(voiced):
    """synthesize_batch with voices [bob, None]: the base row is the
    unvoiced batch's row exactly; the voiced row differs."""
    wavs = voiced.synthesize_batch([IDS, IDS], [SPK, SPK], seed=9, voices=["bob", None])
    base = voiced.synthesize_batch([IDS, IDS], [SPK, SPK], seed=9)
    np.testing.assert_array_equal(wavs[1], base[1])
    assert wavs[0].shape != wavs[1].shape or not np.allclose(wavs[0], wavs[1], atol=1e-4)


def test_trainer_adapter_export_loads_as_voice(tiny, tmp_path):
    """JointTrainer.export_adapters -> serve.load_voice_adapters ->
    set_voices: the scales and keys survive, and the voice synthesizes."""
    from cosy_tpu_torch.serve import load_voice_adapters
    from cosy_tpu_torch.train.trainer import JointTrainer

    _, tcfg, _, mods, _ = tiny
    trcfg = TrainConfig(training_mode="joint", batch_size=1, accumulate_grad_batches=1,
                        max_feat_len=16, llm_lora=LLM_LORA, flow_lora=FLOW_LORA, bf16=False)
    tr = JointTrainer(tcfg, trcfg, mods[0], mods[1], out_dir=str(tmp_path), total_steps=1)
    state = tr.init_state(torch.Generator().manual_seed(0))
    path = str(tmp_path / "adapters.pt")
    tr.export_adapters(state, path)
    v = load_voice_adapters(path)
    assert set(v["llm"]) == set(state.loras["llm"]) and set(v["flow"]) == set(state.loras["flow"])
    assert v["llm_scale"] == LLM_LORA.scaling and v["flow_scale"] == FLOW_LORA.scaling
    pipe = _pipe(tcfg, mods)
    pipe.set_voices({"v": {"llm": v["llm"], "flow": v["flow"]}}, llm_scale=v["llm_scale"],
                    flow_scale=v["flow_scale"])
    wav = _wav(pipe, "v")
    assert np.isfinite(wav).all() and wav.size > 0
