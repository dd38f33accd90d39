"""The port's ASR TransformerDecoder and BiTransformerDecoder against the
torch-recorded goldens ``asr_decoder`` and ``asr_bidecoder``
(tests/test_asr_decoder.py: valid rows, 2e-4) and against the JAX
package's forwards (jitted, 2e-4) on seeded weights with ragged target and
memory lengths; the init's names and shapes against JAX's."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cosy_tpu.layers import decoder as JD
from cosy_tpu.params import P as JP
from cosy_tpu_torch.layers.decoder import (DecoderConfig, bi_transformer_decoder_forward,
                                           init_bi_transformer_decoder,
                                           init_transformer_decoder,
                                           transformer_decoder_forward)
from cosy_tpu_torch.params import Spec, spec_tensors
from test_torch_common import assert_close, golden_np, t, torch_params
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

CFG = DecoderConfig(vocab_size=30, encoder_output_size=16, attention_heads=2,
                    linear_units=24, num_blocks=2, dropout_rate=0.0,
                    positional_dropout_rate=0.0)
TOL = dict(atol=2e-4, rtol=2e-4)


def _jcfg(cfg):
    return JD.DecoderConfig(**dataclasses.asdict(cfg))


def _ins(ins):
    return (t(ins["memory"]), torch.as_tensor(ins["memory_len"]), torch.as_tensor(ins["ys_in"]),
            torch.as_tensor(ins["ys_len"]))


def test_transformer_decoder_matches_golden():
    params, ins, outs = golden_np("asr_decoder")
    logits, olens = transformer_decoder_forward(torch_params(params), CFG, *_ins(ins))
    for b, n in enumerate(np.asarray(ins["ys_len"])):
        assert_close(logits[b, :n], outs["logits"][b, :n], name=f"logits[{b}]", **TOL)
    np.testing.assert_array_equal(olens.numpy(), ins["ys_len"])


def test_bi_transformer_decoder_matches_golden():
    params, ins, outs = golden_np("asr_bidecoder")
    l_x, r_x, _ = bi_transformer_decoder_forward(
        torch_params(params), CFG, *_ins(ins), torch.as_tensor(ins["r_ys_in"]),
        reverse_weight=0.3, r_num_blocks=1)
    for b, n in enumerate(np.asarray(ins["ys_len"])):
        assert_close(l_x[b, :n], outs["l_x"][b, :n], name=f"l_x[{b}]", **TOL)
        assert_close(r_x[b, :n], outs["r_x"][b, :n], name=f"r_x[{b}]", **TOL)


def _seeded(spec, seed):
    return {k: v.numpy() for k, v in
            spec_tensors(spec, "cpu", torch.Generator().manual_seed(seed)).items()}


def _inputs(seed, B=3, S=9, L=7, vocab=30):
    rng = np.random.default_rng(seed)
    memory = rng.standard_normal((B, S, 16)).astype(np.float32)
    ys = rng.integers(0, vocab, (B, L)).astype(np.int64)
    return memory, np.array([9, 5, 7]), ys, np.array([7, 3, 6]), ys[:, ::-1].copy()


@pytest.mark.parametrize("src_attention", [True, False])
def test_transformer_decoder_matches_jax(src_attention):
    cfg = dataclasses.replace(CFG, src_attention=src_attention, num_blocks=3)
    w = _seeded(init_transformer_decoder(Spec(), "", cfg), 5)
    memory, mlen, ys, ylen, _ = _inputs(6)
    want, wlen = jax.jit(lambda p, *a: JD.transformer_decoder_forward(JP(p), _jcfg(cfg), *a))(
        w, memory, mlen.astype(np.int32), ys.astype(np.int32), ylen.astype(np.int32))
    got, olen = transformer_decoder_forward(torch_params(w), cfg, t(memory),
                                            torch.as_tensor(mlen), torch.as_tensor(ys),
                                            torch.as_tensor(ylen))
    for b, n in enumerate(ylen):
        assert_close(got[b, :n], np.asarray(want)[b, :n], name=f"logits[{b}]", **TOL)
    np.testing.assert_array_equal(olen.numpy(), np.asarray(wlen))


@pytest.mark.parametrize("reverse_weight", [0.0, 0.4])
def test_bi_transformer_decoder_matches_jax(reverse_weight):
    w = _seeded(init_bi_transformer_decoder(Spec(), CFG, r_num_blocks=1), 8)
    memory, mlen, ys, ylen, rys = _inputs(9)
    args = (memory, mlen.astype(np.int32), ys.astype(np.int32), ylen.astype(np.int32),
            rys.astype(np.int32))
    jl, jr, _ = jax.jit(lambda p, *a: JD.bi_transformer_decoder_forward(
        JP(p), _jcfg(CFG), *a, reverse_weight=reverse_weight, r_num_blocks=1))(w, *args)
    l_x, r_x, _ = bi_transformer_decoder_forward(
        torch_params(w), CFG, t(memory), torch.as_tensor(mlen), torch.as_tensor(ys),
        torch.as_tensor(ylen), torch.as_tensor(rys), reverse_weight=reverse_weight,
        r_num_blocks=1)
    assert r_x.shape == tuple(jr.shape)
    for b, n in enumerate(ylen):
        assert_close(l_x[b, :n], np.asarray(jl)[b, :n], name=f"l_x[{b}]", **TOL)
        if reverse_weight:
            assert_close(r_x[b, :n], np.asarray(jr)[b, :n], name=f"r_x[{b}]", **TOL)
    if not reverse_weight:
        assert float(r_x) == 0.0


def test_init_names_and_shapes_equal_jax_and_the_goldens():
    def shapes(spec):
        return {k: s for k, (s, _) in spec.entries.items()}

    key = jax.random.PRNGKey(0)
    want = jax.eval_shape(lambda k: JD.init_transformer_decoder(k, _jcfg(CFG)), key)
    got = shapes(init_transformer_decoder(Spec(), "", CFG))
    assert got == {k: tuple(v.shape) for k, v in want.items()}
    assert got == {k: v.shape for k, v in golden_np("asr_decoder")[0].items()}
    want = jax.eval_shape(lambda k: JD.init_bi_transformer_decoder(k, _jcfg(CFG), 1), key)
    got = shapes(init_bi_transformer_decoder(Spec(), CFG, r_num_blocks=1))
    assert got == {k: tuple(v.shape) for k, v in want.items()}
    assert got == {k: v.shape for k, v in golden_np("asr_bidecoder")[0].items()}
    no_src = dataclasses.replace(CFG, src_attention=False)
    want = jax.eval_shape(lambda k: JD.init_transformer_decoder(k, _jcfg(no_src)), key)
    assert shapes(init_transformer_decoder(Spec(), "", no_src)) == \
        {k: tuple(v.shape) for k, v in want.items()}
