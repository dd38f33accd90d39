"""The port's Qwen2 backbone and Qwen2LM decode (CosyVoice2's LLM) on the
CPU: the HF-recorded ``qwen2.npz`` golden (full forward, and a prefill plus
one KV-cache step), the cached steps against the full causal forward
(teacher-forced), logits against JAX ``qwen2_forward``, Qwen2LM decode
logits against JAX over the same prefix and tokens, left-padded rows
against their unpadded runs, the decode's first-attempt and fill-token
rules, and batched and segmented decodes token-identical to solo.
Tolerance 2e-4 for modules, exact for tokens."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cosy_tpu.ctx import EVAL
from cosy_tpu.layers import qwen2 as JQ
from cosy_tpu.layers.basic import dense as j_dense, embedding as j_embedding
from cosy_tpu.params import P as JP
from cosy_tpu_torch.layers import qwen2 as TQ
from cosy_tpu_torch.models import qwen2lm as TLM
from test_torch_common import assert_close, golden_np, t, torch_params
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=2e-4, rtol=2e-4)
TINY_QWEN = TQ.Qwen2Config(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2, head_dim=8,
                           vocab_size=50)
J_TINY_QWEN = JQ.Qwen2Config(**TINY_QWEN.__dict__)
LCFG = TLM.Qwen2LMConfig(llm_input_size=32, llm_output_size=32, speech_token_size=30,
                         qwen=TINY_QWEN)


@pytest.fixture(scope="module")
def lm():
    """Tiny Qwen2LM weights from the port's init, as (torch P, jax dict)."""
    flat = {k: v.numpy() for k, v in TLM.init_qwen2lm_params(LCFG, "cpu", seed=4)
            .state_dict().items()}
    return torch_params(flat), {k: jnp.asarray(v) for k, v in flat.items()}


def test_qwen2_forward_matches_the_hf_golden():
    params, ins, outs = golden_np("qwen2")
    y = TQ.qwen2_forward(torch_params(params), TINY_QWEN, t(ins["xs"]),
                         torch.as_tensor(ins["lens"]))
    assert_close(y[0], outs["hidden"][0], **TOL)
    assert_close(y[1, :5], outs["hidden"][1, :5], **TOL)  # row 1's valid rows


def test_qwen2_kv_cache_step_matches_the_hf_golden():
    """A prefill of 4 rows into an 8-column cache, then one step at
    position 4 (the golden's ``step_prefix`` / ``step_next``)."""
    params, ins, outs = golden_np("qwen2")
    p, q = torch_params(params), TINY_QWEN
    S = 8
    kb = torch.zeros((q.num_hidden_layers, 1, q.num_key_value_heads, S, q.head_dim))
    vb = torch.zeros_like(kb)
    causal = torch.arange(S)[None, :] <= torch.arange(4)[:, None]
    bias = torch.where(causal, 0.0, -1e10)[None]
    h = t(ins["xs"][:1, :4])
    for i in range(q.num_hidden_layers):
        h = TQ.qwen2_layer(p.sub(f"layers.{i}"), q, h, torch.arange(4), bias,
                           kv_cache=(kb[i], vb[i]), cache_index=0)
    assert_close(TQ.rms_norm(p, "norm", h, q.rms_norm_eps), outs["step_prefix"], **TOL)
    bias2 = torch.where(torch.arange(S)[None, None, :] <= 4, 0.0, -1e10)
    h = t(ins["xs"][:1, 4:5])
    for i in range(q.num_hidden_layers):
        h = TQ.qwen2_layer(p.sub(f"layers.{i}"), q, h, torch.full((1,), 4), bias2,
                           kv_cache=(kb[i], vb[i]), cache_index=4)
    assert_close(TQ.rms_norm(p, "norm", h, q.rms_norm_eps), outs["step_next"], **TOL)


def test_qwen2_forward_matches_jax(lm):
    tp, jp = lm
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((3, 9, 32)).astype(np.float32)
    lens = np.asarray([9, 6, 1], np.int32)
    want = jax.jit(lambda p, x, l: JQ.qwen2_forward(JP(p).sub("llm.model.model"), J_TINY_QWEN,
                                                    x, l, EVAL))(jp, jnp.asarray(xs),
                                                                 jnp.asarray(lens))
    got = TQ.qwen2_forward(tp.sub("llm.model.model"), TINY_QWEN, t(xs), torch.as_tensor(lens))
    for b, n in enumerate(lens):
        assert_close(got[b, :n], np.asarray(want)[b, :n], **TOL, name=f"row {b}")


def test_rope_at_the_full_width_theta():
    """theta 1e6 over head dim 64 at positions up to 32767, against numpy
    in float64."""
    cfg = TQ.Qwen2Config()
    pos = torch.tensor([0, 1, 511, 32767])
    cos, sin = TQ.rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
    inv = 1.0 / cfg.rope_theta ** (np.arange(0, 64, 2) / 64)
    ang = np.concatenate([pos.numpy()[:, None] * inv] * 2, axis=1)
    np.testing.assert_allclose(cos.numpy(), np.cos(ang), atol=2e-3)
    np.testing.assert_allclose(sin.numpy(), np.sin(ang), atol=2e-3)
    assert cfg.max_position_embeddings == 32768 and cfg.rope_theta == 1e6


def _prefix(rng, L):
    return t(rng.standard_normal((1, L, 32)).astype(np.float32))


def _jax_logits(jp, prefix, tokens):
    """JAX logits of every position of [prefix, speech_emb(tokens)] through
    ``qwen2_forward`` + ``llm_decoder``: the logits a decode samples from."""
    def f(p, pre, tok):
        x = jnp.concatenate([pre, j_embedding(JP(p), "speech_embedding", tok)], axis=1)
        h = JQ.qwen2_forward(JP(p).sub("llm.model.model"), J_TINY_QWEN, x,
                             jnp.asarray([x.shape[1]]), EVAL)
        return j_dense(JP(p), "llm_decoder", h)
    return np.asarray(jax.jit(f)(jp, jnp.asarray(prefix.numpy()), jnp.asarray(tokens)))


def test_teacher_forced_decode_logits_match_jax_and_the_full_forward(lm):
    """Prefill + cached steps (one column an attempt) against JAX's full
    causal forward over the same sequence: 2e-4."""
    tp, jp = lm
    rng = np.random.default_rng(2)
    prefix = _prefix(rng, 7)
    toks = rng.integers(0, 30, (1, 6))
    got = TLM.qwen2lm_teacher_forced_logits(tp, LCFG, prefix, [7], toks.tolist())
    want = _jax_logits(jp, prefix, toks)[:, 6:]
    assert got.shape == (1, 7, 33)
    assert_close(got, want, **TOL)


def test_left_padded_rows_match_their_unpadded_runs(lm):
    """RoPE is relative: a row left-padded to L0 = 12 gives its unpadded
    run's logits at every step."""
    tp, _ = lm
    rng = np.random.default_rng(3)
    pres = [_prefix(rng, n) for n in (12, 5, 9)]
    toks = rng.integers(0, 30, (3, 5)).tolist()
    padded = torch.cat([torch.nn.functional.pad(p, (0, 0, 12 - p.shape[1], 0)) for p in pres])
    got = TLM.qwen2lm_teacher_forced_logits(tp, LCFG, padded, [12, 5, 9], toks)
    for b, pre in enumerate(pres):
        solo = TLM.qwen2lm_teacher_forced_logits(tp, LCFG, pre, [pre.shape[1]], [toks[b]])
        assert_close(got[b], solo[0], **TOL, name=f"row {b}")


def test_prefix_pack_matches_jax(lm):
    tp, jp = lm
    text = np.asarray([[3, 9, 14, 2]])
    pst = np.asarray([[5, 7, 11]])
    want = jnp.concatenate([jp["llm_embedding.weight"][0][None, None],
                            j_embedding(JP(jp).sub("llm.model.model"), "embed_tokens",
                                        jnp.asarray(text)),
                            jp["llm_embedding.weight"][1][None, None],
                            j_embedding(JP(jp), "speech_embedding", jnp.asarray(pst))], axis=1)
    got = TLM.qwen2lm_prefix(tp, LCFG, torch.as_tensor(text), torch.as_tensor(pst))
    assert got.shape == (1, 9, 32)
    assert_close(got, np.asarray(want), atol=0, rtol=0)


class _Scripted:
    """A stand-in for the sampler that returns a fixed id sequence."""

    def __init__(self, ids):
        self.ids = list(ids)

    def __call__(self, logp, decoded, *a, **kw):
        self.seen = getattr(self, "seen", []) + [(logp.clone(), list(decoded))]
        return self.ids.pop(0)


def test_fill_tokens_are_skipped_and_the_first_attempt_masks_them(lm, monkeypatch):
    """Ids above EOS are neither stored nor fed: the next attempt feeds the
    previous token at the next column; the EOS floor counts attempts; the
    first attempt's ids above EOS are -inf."""
    tp, _ = lm
    eos = LCFG.speech_token_size
    script = _Scripted([4, eos + 2, 7, eos + 1, eos])
    monkeypatch.setattr(TLM, "ras_sample", script)
    prefix = _prefix(np.random.default_rng(5), 6)
    st = TLM.qwen2lm_decode_start(tp, LCFG, prefix, [6], [3], [10], [None]).run()
    assert st.tokens[0] == [4, 7] and st.attempts[0] == 5 and st.done[0]
    first, later = script.seen[0][0], script.seen[1][0]
    assert torch.isinf(first[eos:]).all()  # EOS floor (3) and the fill mask
    assert torch.isinf(later[eos]) and not torch.isinf(later[eos + 1:]).any()
    assert not torch.isinf(script.seen[3][0][eos])  # attempt 3: past the floor
    assert [d for _, d in script.seen] == [[], [4], [4], [4, 7], [4, 7]]


def _decode_prefixes(rng, lens):
    return [_prefix(rng, n) for n in lens]


def test_batched_and_segmented_decodes_equal_solo(lm):
    """Four rows of different prefix lengths and caps in one lock-step
    decode, and one row paused and resumed every 3 steps: every token
    equals its solo decode's with the same generator."""
    tp, _ = lm
    rng = np.random.default_rng(6)
    lens, caps, mins = (7, 3, 12, 9), (14, 9, 20, 16), (0, 2, 4, 0)
    pres = _decode_prefixes(rng, lens)
    gen = lambda b: torch.Generator().manual_seed(100 + b)  # noqa: E731
    solo = [TLM.qwen2lm_decode(tp, LCFG, pres[b], mins[b], caps[b], generator=gen(b))
            for b in range(4)]
    assert any(solo) and all(len(s) <= c for s, c in zip(solo, caps))
    padded = torch.cat([torch.nn.functional.pad(p, (0, 0, 16 - p.shape[1], 0)) for p in pres])
    batch = TLM.qwen2lm_decode_batch(tp, LCFG, padded, list(lens), list(mins), list(caps),
                                     [gen(b) for b in range(4)])
    assert batch == solo
    st = TLM.qwen2lm_decode_start(tp, LCFG, pres[2], [12], [4], [20], [gen(2)])
    seen = []
    while not st.done[0]:
        st.run(st.i + 3)
        seen.append(len(st.tokens[0]))
    assert st.tokens[0] == solo[2] and seen == sorted(seen)
