"""``serve --tp`` without a launch: ``shard_params``' layout against the JAX
package's on every full-width leaf, int8 leaves too; the split views that
carry it (``P.split``); and the world-one port held to the JAX package's
own tensor-parallel runs of tests/test_tp_decode.py (a 2-device CPU mesh,
f64): the solo and batched decodes with a Gumbel-max sampler injected into
both packages, and the flow with JAX's z injected (2e-4, that file's bound).

The two-rank runs (decodes, flows and a ``--tp 2`` server) are cases of
tests/test_torch_parallel.py's two-rank worker, which builds its inputs with
this file's helpers (:func:`decode_case`, :func:`flow_case`): the chain is
JAX tp == the port at a world of one (here) == the port over 2 ranks
(there).  The helpers import no JAX.
"""

import types
from contextlib import contextmanager, nullcontext

import numpy as np
import pytest
import torch

from cosy_tpu_torch.config import (EncoderConfig, EstimatorConfig, FlowConfig, LLMConfig,
                                   replace)
from cosy_tpu_torch.infer.pipeline import shard_pipeline
from cosy_tpu_torch.layers.qwen2 import Qwen2Config
from cosy_tpu_torch.models import flow as TF
from cosy_tpu_torch.models import llm as TL
from cosy_tpu_torch.models import qwen2lm as TQ2
from cosy_tpu_torch.layers import unet as TU
from cosy_tpu_torch.parallel import tp as TP
from cosy_tpu_torch.params import P
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

# tests/test_tp_decode.py's tiny LLM and flow
_ENC = EncoderConfig(input_size=16, output_size=16, attention_heads=2, linear_units=24,
                     num_blocks=2)
LCFG = LLMConfig(text_encoder_input_size=16, llm_input_size=16, llm_output_size=16,
                 text_token_size=40, speech_token_size=30, spk_embed_dim=12,
                 text_encoder=replace(_ENC, static_chunk_size=1),
                 llm=replace(_ENC, static_chunk_size=1, input_layer="linear_legacy"))
FCFG = FlowConfig(input_size=16, output_size=80, spk_embed_dim=12, vocab_size=30,
                  encoder=replace(_ENC, num_blocks=1),
                  estimator=EstimatorConfig(in_channels=320, out_channels=80, channels=(16, 16),
                                            attention_head_dim=4, n_blocks=1, num_mid_blocks=1,
                                            num_heads=2))
# tests/test_torch_cv2.py's tiny Qwen2 LM
QCFG = TQ2.Qwen2LMConfig(llm_input_size=32, llm_output_size=32, speech_token_size=30,
                         qwen=Qwen2Config(hidden_size=32, intermediate_size=64,
                                          num_hidden_layers=2, num_attention_heads=4,
                                          num_key_value_heads=2, head_dim=8, vocab_size=50))
DECODES = ("solo", "batched", "voiced", "int8", "qwen2")
FLOWS = ("euler", "window", "meanflow", "fused")
FLOW_TOKENS = 8  # -> 13 mel frames, padded to 14
FLOW_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_tp_decode.py:93


def _f64(module) -> dict:
    return {k: v.detach().double() for k, v in module.state_dict().items()}


def _gumbel(steps: int, vocab: int, seed: int = 5) -> np.ndarray:
    return -np.log(-np.log(np.random.default_rng(seed).uniform(1e-6, 1 - 1e-6, (steps, vocab))))


GUMBEL = _gumbel(13, LCFG.speech_token_size + 1)
GUMBEL_Q = _gumbel(13, QCFG.speech_token_size + 3, seed=6)


@contextmanager
def gumbel_sampler():
    """Both decodes' samplers replaced by Gumbel-max over fixed noise, step n
    of a row taking row n of the noise (the JAX side patches its own)."""
    real = TL.ras_sample, TQ2.ras_sample

    def pick(noise):
        return lambda logp, decoded, *a, **k: int(np.argmax(
            logp.double().numpy() + noise[len(decoded)]))

    TL.ras_sample, TQ2.ras_sample = pick(GUMBEL), pick(GUMBEL_Q)
    try:
        yield
    finally:
        TL.ras_sample, TQ2.ras_sample = real


def decode_prefix(B: int, width: int = 16) -> np.ndarray:
    return np.random.default_rng(10 + B + width).standard_normal((B, 6, width))


def voice_bank(w: dict) -> dict:
    """Two voices of seeded adapters on the decode's six modules, stacked."""
    from cosy_tpu_torch.lora import stack_voice_loras

    rng = np.random.default_rng(9)
    voices = []
    for _ in range(2):
        v = {}
        for i in range(LCFG.llm.num_blocks):
            for m in TL._DECODE_LORA_MODS:
                out_f, in_f = w[f"llm.encoders.{i}.{m}.weight"].shape
                v[f"llm.encoders.{i}.{m}.lora_A"] = torch.from_numpy(rng.standard_normal((2, in_f)))
                v[f"llm.encoders.{i}.{m}.lora_B"] = torch.from_numpy(
                    0.3 * rng.standard_normal((out_f, 2)))
        voices.append(v)
    return stack_voice_loras(voices, "cpu")


def decode_case(case: str, mesh=None) -> list:
    """The token rows of one decode case in f64; with ``mesh``, its weights
    split over the mesh's model axis (``shard_pipeline``, as
    ``TTSPipeline.shard`` splits them)."""
    if case == "qwen2":
        p = P(_f64(TQ2.init_qwen2lm_params(QCFG, "cpu", seed=2)))
    else:
        p = P(_f64(TL.init_llm_params(LCFG, "cpu", seed=0)))
    step = TL.quantize_decode_step(p, LCFG) if case == "int8" else p
    bank = voice_bank(p.d) if case == "voiced" else None
    if mesh is not None:
        p, step, _, _ = shard_pipeline(mesh, p, step, P({}))
    with gumbel_sampler(), torch.inference_mode():
        if case == "qwen2":
            return [TQ2.qwen2lm_decode(p, QCFG, torch.from_numpy(decode_prefix(1, 32)), 2, 12)]
        if case in ("solo", "int8"):
            return [TL.llm_decode(p, LCFG, torch.from_numpy(decode_prefix(1)), 2, 12,
                                  step_p=step)]
        lora = {} if bank is None else dict(lora=bank, vids=[0, 1], lora_scale=2.0)
        return TL.llm_decode_start(p, LCFG, torch.from_numpy(decode_prefix(2)), [6, 4],
                                   [2, 2], [12, 12], [None, None], **lora).run().tokens


def flow_inputs():
    rng = np.random.default_rng(3)
    tok = torch.from_numpy(rng.integers(0, FCFG.vocab_size, (1, FLOW_TOKENS)))
    return tok, torch.from_numpy(rng.standard_normal((1, FCFG.spk_embed_dim)))


@contextmanager
def fused_on_cpu():
    """The estimator's blocks routed to the kernel chain on CPU tensors too,
    where ``fused_transformer_block`` runs its plain version."""
    real, cuda_x = TU.use_fused_block, types.SimpleNamespace(device=torch.device("cuda"))
    TU.use_fused_block = lambda x, *a: real(cuda_x, *a)
    try:
        yield
    finally:
        TU.use_fused_block = real


def flow_case(variant: str, z: np.ndarray, mesh=None) -> torch.Tensor:
    """One f64 flow solve (NFE 4, ``z`` injected): Euler, Euler with a
    2-frame attention window, the MeanFlow sampler on branched weights, or
    Euler through the fused block's chain (its plain version; under a split
    each block gathers its split weights); with ``mesh``, split as
    :func:`decode_case` splits."""
    from cosy_tpu_torch.train.distill import add_meanflow_time_branch

    w = _f64(TF.init_flow_params(FCFG, "cpu", seed=0))
    cfg, kw = FCFG, {}
    if variant == "window":
        cfg = replace(FCFG, estimator=replace(FCFG.estimator, attn_window=2))
    elif variant == "meanflow":
        w = {k: v.double() for k, v in add_meanflow_time_branch(w, FCFG.estimator).items()}
        kw = dict(sampler="meanflow")
    p = P(w)
    if mesh is not None:
        _, _, p, _ = shard_pipeline(mesh, P({}), P({}), p)
    tok, spk = flow_inputs()
    with fused_on_cpu() if variant == "fused" else nullcontext(), torch.inference_mode():
        return TF.flow_inference(p, cfg, tok, torch.zeros((1, 0), dtype=torch.long),
                                 torch.zeros((1, 0, 80), dtype=torch.float64), spk,
                                 n_timesteps=4, finetuned_norm=True, z=torch.from_numpy(z), **kw)


# tests/test_torch_cv2.py's tiny causal flow and 24 kHz-style HiFT
FCFG2 = dict(input_size=16, output_size=80, spk_embed_dim=12, vocab_size=33,
             encoder=EncoderConfig(input_size=16, output_size=16, attention_heads=2,
                                   linear_units=24, num_blocks=1, static_chunk_size=4),
             num_up_blocks=1,
             estimator=EstimatorConfig(in_channels=320, out_channels=80, channels=(12, 12),
                                       attention_head_dim=4, n_blocks=1, num_mid_blocks=1,
                                       num_heads=2),
             decoder_static_chunk_size=4)


def cv2_case(mesh=None) -> list:
    """A tiny ``TTS2Pipeline`` (f32; EOS held off to 8 attempts a text id):
    a whole synthesis, a streamed one and a batch of two, as wavs; with
    ``mesh``, after ``TTS2Pipeline.shard``."""
    from cosy_tpu_torch.config import HiFTConfig, InferenceConfig
    from cosy_tpu_torch.infer.pipeline2 import TTS2Pipeline
    from cosy_tpu_torch.models.flow2 import Flow2Config, init_flow2_params
    from cosy_tpu_torch.models.hift import init_hift_params

    hcfg = HiFTConfig(in_channels=80, base_channels=16, nb_harmonics=2, upsample_rates=(8, 8),
                      upsample_kernel_sizes=(16, 16), istft_n_fft=16, istft_hop_len=4,
                      resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
                      source_resblock_kernel_sizes=(3, 3),
                      source_resblock_dilation_sizes=((1,), (1,)), f0_predictor_cond_channels=8)
    fcfg = Flow2Config(**FCFG2)
    pipe = TTS2Pipeline(QCFG, fcfg, hcfg, TQ2.init_qwen2lm_params(QCFG, "cpu", seed=11),
                        init_flow2_params(fcfg, "cpu", seed=12),
                        init_hift_params(hcfg, "cpu", seed=13),
                        InferenceConfig(nfe_short=2, min_token_text_ratio=8.0), hop_samples=256)
    if mesh is not None:
        pipe.shard(mesh)
    rng = np.random.default_rng(4)
    texts = [rng.integers(0, QCFG.qwen.vocab_size, (1, n)) for n in (3, 2)]
    wavs = [c["tts_speech"] for c in pipe.synthesize(texts[0], max_len_cap=24, seed=3)]
    wavs += [c["tts_speech"] for c in pipe.synthesize(texts[1], stream=True, max_len_cap=24,
                                                      seed=4)]
    return wavs + pipe.synthesize_batch(texts, max_len_cap=24, seed=5)


def jax_flow_z() -> np.ndarray:
    """tests/test_tp_decode.py's z: its key's normal draw at the padded mel
    length (f64)."""
    import jax

    T = int(FLOW_TOKENS / FCFG.input_frame_rate * 22050 / 256)
    with jax.enable_x64(True):
        return np.array(jax.random.normal(jax.random.PRNGKey(3), (1, 80, T + T % 2),
                                          jax.numpy.float64))


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------


class _Mesh:
    """A model axis of ``n`` seen from rank 0, without a process group."""

    def __init__(self, n):
        self.n = n

    def size(self, axis):
        return self.n if axis == "model" else 1

    def coord(self, axis):
        return 0

    def group(self, axis):
        return None


@pytest.fixture(scope="module")
def full_width():
    """Meta tensors of the full-width 300M LLM and flow and of Qwen2-0.5B,
    with the int8 dicts' leaves: the 300M decode step's view and every
    Qwen2 projection (int8 weights and their ``@scale`` rows)."""
    from cosy_tpu_torch.config import ModelConfig
    from cosy_tpu_torch.models.flow import flow_spec
    from cosy_tpu_torch.models.llm import llm_spec
    from cosy_tpu_torch.models.qwen2lm import Qwen2LMConfig, qwen2lm_spec
    from cosy_tpu_torch.quant import QWEN2_PROJ_SUFFIXES

    cfg = ModelConfig()
    dicts = {}
    for tag, spec, int8 in (
            ("llm", llm_spec(cfg.llm), lambda k: k.startswith("llm.encoders.") and any(
                k.endswith(f"{m}.weight") for m in TL._DECODE_LORA_MODS)),
            ("flow", flow_spec(cfg.flow), lambda k: False),
            ("qwen2", qwen2lm_spec(Qwen2LMConfig()),
             lambda k: any(k.endswith(s) for s in QWEN2_PROJ_SUFFIXES))):
        d = {}
        for k, (shape, _) in spec.entries.items():
            q = int8(k) and len(shape) == 2
            d[k] = torch.empty(shape, device="meta", dtype=torch.int8 if q else torch.float32)
            if q:
                d[k + "@scale"] = torch.empty(shape[:1], device="meta")
        dicts[tag] = d
    return dicts


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_layout_equals_jax_on_every_full_width_leaf(full_width, tp):
    """``shard_params``' layout is ``tp_param_shardings``' on every leaf (the
    ``@scale`` rows whole), and a split leaf's block is 1/tp of it."""
    import jax
    from jax.sharding import Mesh

    from cosy_tpu.parallel import tp as JTP

    jmesh = Mesh(np.array(jax.devices("cpu")[:tp]).reshape(1, 1, tp), ("dp", "seq", "model"))
    for tag, d in full_width.items():
        local, layout = TP.shard_params(_Mesh(tp), d)
        want = JTP.tp_param_shardings(jmesh, {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
                                              for k, v in d.items()})
        assert sorted(layout) == sorted(want) == sorted(local)
        for k, axis in layout.items():
            spec = tuple(want[k].spec)
            assert axis == (spec.index("model") if "model" in spec else None), (tag, k)
            shape = list(d[k].shape)
            if axis is not None:
                shape[axis] //= tp
            assert list(local[k].shape) == shape and local[k].dtype == d[k].dtype, (tag, k)
        assert TP.count_sharded(layout) == JTP.count_sharded(want) > 20, tag
        assert all(layout[k] is None for k in layout if k.endswith("@scale"))


def test_split_views_carry_their_layout():
    """``shard_pipeline``'s views carry their layout (``P.split``, the split
    leaves only), sub-views keep it, and the products read the axis from the
    view they are given: a view of the whole weights, or any view at a
    world of one, has none.  A ``P`` of a plain dict takes the Split of an
    enclosing ``tensor_parallel`` (the trainers' route) and none under
    ``suspended``."""
    llm = P(_f64(TL.init_llm_params(LCFG, "cpu", seed=0)))
    flow = P(_f64(TF.init_flow_params(FCFG, "cpu", seed=0)))
    lp, sp, fp, counts = shard_pipeline(_Mesh(2), llm, llm, flow)
    for view, whole in ((lp, llm), (fp, flow)):
        _, layout = TP.shard_params(_Mesh(2), whole.d)
        assert view.split.layout == {k: a for k, a in layout.items() if a is not None}
    assert sp is not lp and sp.split == lp.split
    assert counts == (len(lp.split.layout), len(fp.split.layout)) and min(counts) >= 4
    enc = lp.sub("llm.encoders.0")
    assert TP.split_axis(enc, "self_attn.linear_q.weight") == 0
    assert TP.split_axis(enc, "self_attn.linear_out.weight") == 1
    assert TP.split_axis(enc, "norm1.weight") is None
    blk = "decoder.estimator.mid_blocks.0.1.0"
    assert [TP.split_axis(fp.sub(blk), k) for k in TU._FUSED_WEIGHTS] == [
        None, None, 0, 0, 0, 1, None, None, None, 0, 0, 1, None]
    assert llm.split is None and TP.split_axis(llm.sub("llm.encoders.0"),
                                               "self_attn.linear_q.weight") is None
    whole = [flow[f"{blk}.{k}"] for k in TU._FUSED_WEIGHTS]
    assert all(a is b for a, b in zip(TP.gather_weights(flow.sub(blk), TU._FUSED_WEIGHTS),
                                      whole))
    assert shard_pipeline(_Mesh(1), llm, llm, flow)[0].split is None
    with TP.tensor_parallel(_Mesh(2), {"a.weight": 0, "b.weight": None}):
        assert P({}).split.layout == {"a.weight": 0} and P(llm).split is None
        with TP.suspended():
            assert P({}).split is None
    assert P({}).split is None


# ---------------------------------------------------------------------------
# the world-one port against the JAX package's tensor-parallel runs
# ---------------------------------------------------------------------------


def _jax_tp(params):
    """tests/test_tp_decode.py's 2-device CPU mesh and its split params."""
    import jax
    import jax.numpy as jnp

    from cosy_tpu.parallel import mesh as pmesh
    from cosy_tpu.parallel import tp as JTP

    mesh = pmesh.make_mesh(dp=1, model=2, devices=jax.devices("cpu")[:2])
    p = JTP.shard_params(mesh, {k: jnp.asarray(v.numpy()) for k, v in params.items()})
    assert JTP.count_sharded(p) >= 4
    return p


@pytest.mark.parametrize("case", ["solo", "batched"])
def test_world_one_decode_equals_jax_tp_decode(case, monkeypatch):
    """JAX's tp decode (its sampler Gumbel-max over the same noise) gives
    the port's world-one tokens, which the two-rank worker holds its own
    to."""
    import jax
    import jax.numpy as jnp

    from cosy_tpu.config import EncoderConfig as JEnc, LLMConfig as JLLM, replace as jreplace
    from cosy_tpu.models import llm as JL
    from cosy_tpu.params import P as JP

    g = jnp.asarray(GUMBEL)
    monkeypatch.setattr(JL, "ras_sample",
                        lambda rng, logp, decoded, n, *a: jnp.argmax(logp + g[n]).astype(jnp.int32))
    with jax.enable_x64(True):
        p = _jax_tp(_f64(TL.init_llm_params(LCFG, "cpu", seed=0)))
        enc = JEnc(input_size=16, output_size=16, attention_heads=2, linear_units=24,
                   num_blocks=2)
        cfg = JLLM(text_encoder_input_size=16, llm_input_size=16, llm_output_size=16,
                   text_token_size=40, speech_token_size=30, spk_embed_dim=12,
                   text_encoder=jreplace(enc, static_chunk_size=1),
                   llm=jreplace(enc, static_chunk_size=1, input_layer="linear_legacy"))
        if case == "solo":
            prefix = jnp.asarray(decode_prefix(1))
            r = jax.jit(lambda p: JL.llm_decode(JP(p), cfg, jax.random.PRNGKey(5), prefix, 6,
                                                jnp.asarray(2), 12))(p)
            want = [list(np.asarray(r.tokens)[:int(r.length)])]
        else:
            prefix = jnp.asarray(decode_prefix(2))
            r = jax.jit(lambda p: JL.llm_decode_batch(
                JP(p), cfg, jax.random.PRNGKey(8), prefix, jnp.asarray([6, 4]),
                jnp.asarray([2, 2]), 12))(p)
            want = [list(np.asarray(r.tokens)[b][:int(r.lengths[b])]) for b in range(2)]
    got = decode_case(case)
    assert got == [[int(t) for t in row] for row in want]
    assert all(len(row) >= 2 for row in got)


def test_world_one_flow_equals_jax_tp_flow():
    """JAX's tp flow solve (test_tp_decode.py's, NFE 4) with its own z
    against the port's world-one solve with that z injected, at 2e-4."""
    import jax
    import jax.numpy as jnp

    from cosy_tpu.config import EncoderConfig as JEnc, EstimatorConfig as JEst, FlowConfig as JFlow
    from cosy_tpu.models import flow as JF
    from cosy_tpu.params import P as JP

    with jax.enable_x64(True):
        jcfg = JFlow(input_size=16, output_size=80, spk_embed_dim=12, vocab_size=30,
                     encoder=JEnc(input_size=16, output_size=16, attention_heads=2,
                                  linear_units=24, num_blocks=1),
                     estimator=JEst(in_channels=320, out_channels=80, channels=(16, 16),
                                    attention_head_dim=4, n_blocks=1, num_mid_blocks=1,
                                    num_heads=2))
        p = _jax_tp(_f64(TF.init_flow_params(FCFG, "cpu", seed=0)))
        tok, spk = flow_inputs()
        want = np.asarray(jax.jit(lambda p: JF.flow_inference(
            JP(p), jcfg, jax.random.PRNGKey(3), jnp.asarray(tok.numpy()),
            jnp.zeros((1, 0), jnp.int32), jnp.zeros((1, 0, 80), jnp.float64),
            jnp.asarray(spk.numpy()), n_timesteps=4, finetuned_norm=True))(p))
    got = flow_case("euler", jax_flow_z()).numpy()
    assert got.shape == want.shape == (1, 80, 13)
    np.testing.assert_allclose(got, want, **FLOW_TOL)
