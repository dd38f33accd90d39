"""The port's conformer and transformer encoders against the torch-recorded
goldens and the JAX package (CPU).

Goldens (tests/test_parity.py:61-247, its configurations copied here, its
2e-4): ``conformer_l4`` (no xscale), ``conformer_l2_causal`` (static chunk
1, eps 1e-12), ``transformer_l2_causal``, ``transformer_l2_chunk`` (the
prefill and one step of the decode's KV cache, through the port's
``llm_teacher_forced_logits``) and ``transformer_lm`` (loss and accuracy).

The CNN module (``use_cnn_module``): ``encoder_forward`` against JAX's at
2e-4 with LayerNorm and BatchNorm (running statistics drawn, so they
matter), centred and causal depthwise convs, on a ragged batch (the pad
mask zeroes the pad frames on the way into and out of the module; under
the causal conv the short row also equals its own unpadded run); its
parameter names against JAX's ``init_encoder``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cosy_tpu.config import EncoderConfig as JEnc
from cosy_tpu.layers import conformer as JC
from cosy_tpu.params import KeyGen, P as JP
from cosy_tpu_torch.config import EncoderConfig, LLMConfig, replace
from cosy_tpu_torch.ctx import EVAL
from cosy_tpu_torch.layers.basic import glu
from cosy_tpu_torch.layers.conformer import encoder_forward, init_encoder
from cosy_tpu_torch.models.llm import llm_forward_train, llm_teacher_forced_logits
from cosy_tpu_torch.params import Spec, spec_tensors
from test_torch_common import assert_close, golden_np, t, torch_params
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=2e-4, rtol=2e-4)
L4_ENC = EncoderConfig(
    input_size=12, output_size=16, attention_heads=2, linear_units=24,
    num_blocks=2, dropout_rate=0.0, positional_dropout_rate=0.0,
    attention_dropout_rate=0.0, use_cnn_module=False, macaron_style=False,
    layer_norm_eps=1e-5,
)
TR_ENC = EncoderConfig(
    input_size=16, output_size=16, attention_heads=2, linear_units=24,
    num_blocks=2, dropout_rate=0.0, positional_dropout_rate=0.0,
    attention_dropout_rate=0.0, input_layer="linear_legacy",
    static_chunk_size=1, layer_norm_eps=1e-12, activation_type="relu",
)


def _encode(name, cfg, xscale, conformer):
    params, ins, outs = golden_np(name)
    y, _ = encoder_forward(torch_params(params), cfg, t(ins["x"]), t(ins["lens"], torch.long),
                           EVAL, xscale=xscale, conformer=conformer)
    return y, outs["y"], int(ins["lens"][1])


@pytest.mark.parametrize("name, cfg, xscale, conformer", [
    ("conformer_l4", L4_ENC, False, True),
    ("conformer_l2_causal", replace(L4_ENC, static_chunk_size=1, layer_norm_eps=1e-12), True, True),
    ("transformer_l2_causal", TR_ENC, True, False)])
def test_encoder_goldens(name, cfg, xscale, conformer):
    """Padded rows are garbage in both implementations: the valid region."""
    y, want, n1 = _encode(name, cfg, xscale, conformer)
    assert_close(y[0], want[0], **TOL, name="sample0")
    assert_close(y[1, :n1], want[1, :n1], **TOL, name="sample1-valid")


def test_transformer_l2_chunk_golden_through_the_decode_cache():
    """The golden's encoder as an LLM backbone: an identity head and a
    speech-embedding row 0 that is the golden's step input.  The prefill
    equals the reference's forward over 4 inputs, and one step of the
    decode's KV cache its concat-based forward_chunk."""
    params, ins, outs = golden_np("transformer_l2_chunk")
    y1, _ = encoder_forward(torch_params(params), TR_ENC, t(ins["xs1"]), torch.tensor([4]), EVAL,
                            conformer=False)
    assert_close(y1, outs["y1"], **TOL, name="prefill")
    cfg = LLMConfig(llm_input_size=16, llm_output_size=16, speech_token_size=15, llm=TR_ENC)
    flat = {"llm." + k: v for k, v in params.items()}
    flat["llm_decoder.weight"] = np.eye(16, dtype=np.float32)
    flat["llm_decoder.bias"] = np.zeros(16, np.float32)
    emb = np.zeros((15, 16), np.float32)
    emb[0] = ins["xs2"][0, 0]
    flat["speech_embedding.weight"] = emb
    out = llm_teacher_forced_logits(torch_params(flat), cfg, t(ins["xs1"]), [4], [[0]])
    assert_close(out[0, 0], outs["y1"][0, -1], **TOL, name="prefill-last")
    assert_close(out[0, 1], outs["y2"][0, 0], **TOL, name="decode-step")


def test_transformer_lm_golden_loss_and_acc():
    params, ins, outs = golden_np("transformer_lm")
    cfg = LLMConfig(
        text_encoder_input_size=12, llm_input_size=16, llm_output_size=16,
        text_token_size=40, speech_token_size=30, spk_embed_dim=10,
        text_encoder=replace(L4_ENC, layer_norm_eps=1e-12, static_chunk_size=1),
        llm=TR_ENC)
    batch = {k: torch.from_numpy(v) for k, v in ins.items()}
    res = llm_forward_train(torch_params(params), cfg, batch, EVAL)
    assert_close(res["loss"], outs["loss"], **TOL, name="lm-loss")
    assert_close(res["acc"], outs["acc"], **TOL, name="lm-acc")


def _cnn_cfg(norm, causal):
    return EncoderConfig(input_size=12, output_size=16, attention_heads=2, linear_units=24,
                         num_blocks=2, dropout_rate=0.0, positional_dropout_rate=0.0,
                         attention_dropout_rate=0.0, use_cnn_module=True, cnn_module_kernel=5,
                         cnn_module_norm=norm, causal=causal, macaron_style=True,
                         static_chunk_size=1 if causal else 0)


def _cnn_params(cfg, seed):
    spec = Spec()
    init_encoder(spec, "", cfg, conformer=True)
    flat = {k: v.numpy() for k, v in spec_tensors(spec, "cpu",
                                                  torch.Generator().manual_seed(seed)).items()}
    rng = np.random.default_rng(seed)
    for k in flat:
        if k.endswith("running_mean"):
            flat[k] = rng.standard_normal(flat[k].shape).astype(np.float32)
        elif k.endswith("running_var"):
            flat[k] = rng.uniform(0.5, 2.0, flat[k].shape).astype(np.float32)
    return flat


@pytest.mark.parametrize("norm", ["layer_norm", "batch_norm"])
@pytest.mark.parametrize("causal", [False, True], ids=["centred", "causal"])
def test_cnn_module_encoder_matches_jax(norm, causal):
    cfg = _cnn_cfg(norm, causal)
    jcfg = JEnc(**cfg.__dict__)
    flat = _cnn_params(cfg, seed=3 + causal)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    lens = np.array([9, 5])
    want, _ = jax.jit(lambda p, a, b: JC.encoder_forward(JP(p), jcfg, a, b))(
        {k: jnp.asarray(v) for k, v in flat.items()}, jnp.asarray(x), jnp.asarray(lens))
    got, mask = encoder_forward(torch_params(flat), cfg, t(x), torch.from_numpy(lens))
    want = np.asarray(want)
    assert_close(got[0], want[0], **TOL, name="row 0")
    assert_close(got[1, :5], want[1, :5], **TOL, name="row 1 valid")
    assert mask[1, 0].tolist() == [True] * 5 + [False] * 4
    if causal:  # a centred conv reads pad frames that hold GLU(bias), as the reference does
        solo, _ = encoder_forward(torch_params(flat), cfg, t(x[1:, :5]), torch.tensor([5]))
        assert_close(got[1, :5], solo[0], **TOL, name="row 1 against its own run")


def test_cnn_module_parameters_are_jax_init_encoders():
    """The port's names and shapes are JAX's; a BatchNorm module adds the
    running statistics it reads."""
    for norm in ("layer_norm", "batch_norm"):
        cfg = _cnn_cfg(norm, False)
        spec = Spec()
        init_encoder(spec, "enc", cfg, conformer=True)
        d = {}
        JC.init_encoder(KeyGen(jax.random.PRNGKey(0)), d, "enc", JEnc(**cfg.__dict__), True)
        stats = {f"enc.encoders.{i}.conv_module.norm.running_{s}": (16,)
                 for i in range(2) for s in ("mean", "var")} if norm == "batch_norm" else {}
        assert {k: v[0] for k, v in spec.entries.items()} == \
            {**{k: tuple(v.shape) for k, v in d.items()}, **stats}


def test_glu():
    x = torch.randn(2, 6, 3)
    assert_close(glu(x, 1), x[:, :3] * torch.sigmoid(x[:, 3:]), atol=0, rtol=0)
    assert_close(glu(x, 1), torch.nn.functional.glu(x, 1), atol=1e-7, rtol=1e-7)
