"""The port's batched and resumable AR decode (models/llm.py DecodeState):
teacher-forced step logits of a LEFT-padded batch against the JAX package's
full causal forward per unpadded row (2e-4), and exact token identity of
batched rows, paused and resumed segments and a mid-flight admission with
solo decodes of the same generators (the behaviours of
tests/test_batch_decode.py and tests/test_engine.py:39)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cosy_tpu.config import tiny_model_config as j_tiny
from cosy_tpu_torch.models import llm as TL
from test_torch_common import assert_close, port_config, port_init, t, torch_params
from test_torch_llm import _jax_causal_logits

TOL = dict(atol=2e-4, rtol=2e-4)
LENS = (5, 9, 7)  # prefix lengths of the three rows


@pytest.fixture(scope="module")
def llm():
    jcfg = j_tiny().llm
    params = port_init(TL.init_llm_params, jcfg)
    return jcfg, params, port_config(jcfg)


def _prefixes(seed=0, lens=LENS, D=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, n, D)).astype(np.float32) for n in lens]


def _left_pad(prefixes):
    L0 = max(p.shape[1] for p in prefixes)
    return torch.cat([t(np.pad(p, ((0, 0), (L0 - p.shape[1], 0), (0, 0)))) for p in prefixes])


def _gens(seeds):
    return [torch.Generator().manual_seed(s) for s in seeds]


def _solo(tp, cfg, prefix, min_len, cap, seed):
    return TL.llm_decode(tp, cfg, t(prefix), min_len, cap,
                         generator=torch.Generator().manual_seed(seed))


def test_batched_step_logits_teacher_forced(llm):
    """Three rows of different prefix lengths, left-padded to one L0, fed
    the same forced tokens: every step's logits of row b equal JAX's causal
    forward over row b's unpadded prefix and tokens (positional keys taken
    per row from its own column)."""
    jcfg, params, cfg = llm
    tp = torch_params(params)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    prefixes = _prefixes()
    n = 6
    toks = np.random.default_rng(1).integers(0, jcfg.speech_token_size, (3, n))
    got = TL.llm_teacher_forced_logits(tp, cfg, _left_pad(prefixes), LENS, toks.tolist())
    emb = np.asarray(params["speech_embedding.weight"])
    for b, pre in enumerate(prefixes):
        x = np.concatenate([pre, emb[toks[b]][None]], 1)
        want = _jax_causal_logits(jp, jcfg, jnp.asarray(x))[LENS[b] - 1:]
        assert_close(got[b], want, **TOL, name=f"row {b}")


def test_batched_tokens_equal_solo_decodes(llm):
    _, params, cfg = llm
    tp = torch_params(params)
    prefixes = _prefixes(2)
    caps, mins, seeds = (14, 9, 11), (3, 9, 0), (5, 6, 7)
    st = TL.llm_decode_start(tp, cfg, _left_pad(prefixes), LENS, mins, caps, _gens(seeds))
    st.run()
    for b in range(3):
        solo = _solo(tp, cfg, prefixes[b], mins[b], caps[b], seeds[b])
        assert st.tokens[b] == solo
        assert mins[b] <= len(solo) <= caps[b] and st.done[b]


def test_eos_freezes_a_row_and_caps_hold(llm):
    """With EOS made likely (its logit bias raised), rows stop by EOS at or
    after their own min_len while the others run to their own caps; a
    frozen row's tokens do not change as the batch goes on, and every row
    equals its solo decode."""
    _, params, cfg = llm
    params = dict(params)
    bias = params["llm_decoder.bias"].copy()
    bias[cfg.speech_token_size] += 4.0
    params["llm_decoder.bias"] = bias
    tp = torch_params(params)
    prefixes = _prefixes(3)
    caps, mins, seeds = (40, 6, 40), (2, 0, 30), (11, 12, 13)
    st = TL.llm_decode_start(tp, cfg, _left_pad(prefixes), LENS, mins, caps, _gens(seeds))
    frozen = {}
    while not all(st.done):
        st.run(st.i + 1)
        for b in range(3):
            if st.done[b]:
                frozen.setdefault(b, list(st.tokens[b]))
                assert st.tokens[b] == frozen[b]
    lens = [len(x) for x in st.tokens]
    assert lens[0] < caps[0], "row 0 should stop by EOS before its cap"
    assert lens[1] <= caps[1] and lens[2] >= mins[2]
    assert all(lens[b] >= max(1, mins[b]) for b in range(3))
    for b in range(3):
        assert st.tokens[b] == _solo(tp, cfg, prefixes[b], mins[b], caps[b], seeds[b])


def test_segments_resumed_equal_uninterrupted(llm):
    _, params, cfg = llm
    tp = torch_params(params)
    prefixes = _prefixes(4)
    caps, mins, seeds = (17, 23, 12), (17, 23, 12), (1, 2, 3)
    whole = TL.llm_decode_start(tp, cfg, _left_pad(prefixes), LENS, mins, caps, _gens(seeds))
    whole.run()
    seg = TL.llm_decode_start(tp, cfg, _left_pad(prefixes), LENS, mins, caps, _gens(seeds))
    stops = []
    while not all(seg.done):
        seg.run(seg.i + 5)
        stops.append(seg.i)
    assert len(stops) > 2 and seg.tokens == whole.tokens
    assert [len(x) for x in seg.tokens] == list(caps)


def test_admit_slot_mid_flight_equals_solo(llm):
    """A newcomer spliced into a paused state at step 4 decodes as a solo
    run with its own generator, the running row is untouched, and a freed
    row is reused by a second admission."""
    _, params, cfg = llm
    tp = torch_params(params)
    pa, pb, pc = _prefixes(5, (7, 5, 4))
    L0 = 8
    st = TL.llm_decode_idle(tp, cfg, 2, L0, 16, torch.float32, "cpu")
    pad = lambda p: t(np.pad(p, ((0, 0), (L0 - p.shape[1], 0), (0, 0))))  # noqa: E731
    TL.llm_admit_slot(st, pad(pa), 7, 2, 12, torch.Generator().manual_seed(21), 0)
    st.run(st.i + 3)
    assert len(st.tokens[0]) == 4 and st.done[1]
    TL.llm_admit_slot(st, pad(pb), 5, 3, 6, torch.Generator().manual_seed(22), 1)
    assert len(st.tokens[1]) == 1
    while not st.done[1]:
        st.run(st.i + 2)
    assert st.tokens[1] == _solo(tp, cfg, pb, 3, 6, 22)
    TL.llm_admit_slot(st, pad(pc), 4, 5, 9, torch.Generator().manual_seed(23), 1)
    st.run()
    assert st.tokens[0] == _solo(tp, cfg, pa, 2, 12, 21)
    assert st.tokens[1] == _solo(tp, cfg, pc, 5, 9, 23)
    with pytest.raises(ValueError):
        TL.llm_admit_slot(st, pad(pc), 4, 5, 17, None, 1)  # cap over the state's 16
