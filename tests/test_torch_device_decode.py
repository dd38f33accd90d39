"""The device-resident decode (models/decode.py, ops/sampling.py) on the CPU:

- (a) the batched sampler ``ras_sample_batch`` against the numpy statement
  of the JAX package's rule and against the host ``ras_sample``, row by
  row, with rows where the fallback fires, EOS is masked before min_len or
  at step 0, and Qwen2LM's ids above EOS are masked at attempt 0;
- (b) with top_k = 1 and tau_r = 2.0 (the fallback can never fire) the
  sampler is greedy in both packages, so the port's decodes give the tokens
  of JAX's ``llm_decode`` and ``qwen2lm_decode`` on the same weights and
  prefixes: solo, batched and resumed in segments, with min_len and caps;
- (c) with RAS as configured, the tokens of a host loop that samples with
  ``ras_sample`` from the same generators (kept here as the reference
  statement: the per-token loop the port ran before), B = 1 and 4, int8
  and voiced rows, whole and in segments;
- (d) a step makes no host read, the reads of a segment are bounded by its
  chunks and a finished decode runs at most 2 * CHUNK - 1 frozen steps.

JAX runs jitted on the CPU; every fixture is module-scoped."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosy_tpu.config import tiny_model_config as j_tiny
from cosy_tpu.layers import qwen2 as JQ
from cosy_tpu.models import llm as JL
from cosy_tpu.models import qwen2lm as JLM
from cosy_tpu.params import P as JP
from cosy_tpu_torch.layers import qwen2 as TQ
from cosy_tpu_torch.lora import stack_voice_loras
from cosy_tpu_torch.models import decode as TD
from cosy_tpu_torch.models import llm as TL
from cosy_tpu_torch.models import qwen2lm as TLM
from cosy_tpu_torch.ops import sampling as TS
from test_torch_common import port_config, port_init, torch_params
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)
from test_torch_llm import _numpy_ras

TINY_QWEN = TQ.Qwen2Config(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2, head_dim=8,
                           vocab_size=50)
QCFG = TLM.Qwen2LMConfig(llm_input_size=32, llm_output_size=32, speech_token_size=30,
                         qwen=TINY_QWEN)
J_QCFG = JLM.Qwen2LMConfig(llm_input_size=32, llm_output_size=32, speech_token_size=30,
                           qwen=JQ.Qwen2Config(**TINY_QWEN.__dict__))
GREEDY = dict(top_p=0.8, top_k=1, win_size=10, tau_r=2.0)


@pytest.fixture(scope="module")
def llm():
    """Tiny TransformerLM weights (EOS raised by 1.5 so that some greedy and
    sampled rows stop by EOS) as (jax config, jax dict, port config, P)."""
    jcfg = j_tiny().llm
    flat = port_init(TL.init_llm_params, jcfg, seed=3)
    flat["llm_decoder.bias"] = flat["llm_decoder.bias"].copy()
    flat["llm_decoder.bias"][jcfg.speech_token_size] += 1.5
    return jcfg, {k: jnp.asarray(v) for k, v in flat.items()}, port_config(jcfg), \
        torch_params(flat)


@pytest.fixture(scope="module")
def qlm():
    flat = {k: v.numpy() for k, v in TLM.init_qwen2lm_params(QCFG, "cpu", seed=4)
            .state_dict().items()}
    flat["llm_decoder.bias"] = flat["llm_decoder.bias"].copy()
    flat["llm_decoder.bias"][QCFG.speech_token_size] += 1.0
    return {k: jnp.asarray(v) for k, v in flat.items()}, torch_params(flat)


def _prefixes(width, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, n, width)).astype(np.float32) for n in lens]


def _left_pad(prefixes):
    L0 = max(p.shape[1] for p in prefixes)
    return torch.from_numpy(np.concatenate(
        [np.pad(p, ((0, 0), (L0 - p.shape[1], 0), (0, 0))) for p in prefixes]))


def _gens(seeds):
    return [torch.Generator().manual_seed(s) for s in seeds]


# -- (a) the batched sampler ------------------------------------------------


def _numpy_log_probs(x, step, min_len, eos, fill_ids):
    """The decode's EOS rule in numpy (float64 log-softmax)."""
    x = x.astype(np.float64).copy()
    if fill_ids and step == 0:
        x[eos + 1:] = -np.inf
    logp = x - x.max() - np.log(np.exp(x - x.max()).sum())
    if step < min_len or (step == 0 and not fill_ids):
        logp[eos] = -np.inf
    return logp


@pytest.mark.parametrize("fill_ids", [False, True], ids=["llm", "qwen2"])
@pytest.mark.parametrize("seed", range(3))
def test_batched_sampler_equals_the_rule_and_the_host_sampler(seed, fill_ids):
    """Eight rows: steps 0 and later, EOS floors above and below the step,
    histories that repeat the likeliest id (the fallback fires) or not,
    short and empty histories; each row's id equals the numpy statement of
    the rule and the host ``ras_sample`` on that row's log-probs."""
    rng = np.random.default_rng(seed)
    B, V, H, eos = 8, 40, 16, 36 if fill_ids else 39
    logits = (3 * rng.standard_normal((B, V))).astype(np.float32)
    logits[:, eos] += 2.0  # EOS competes, so its mask matters
    steps = np.array([0, 0, 3, 5, 7, 12, 2, 9])
    mins = np.array([0, 4, 4, 5, 2, 0, 9, 3])
    counts = np.array([0, 0, 3, 5, 7, 12, 2, 9])
    u = rng.uniform(size=(B, 2)).astype(np.float32)
    top_p, top_k = (0.8, 25) if seed != 1 else (0.5, 3)
    logp = TS.decode_log_probs(torch.from_numpy(logits), torch.from_numpy(steps),
                               torch.from_numpy(mins), eos, fill_ids)
    hist = np.full((B, H), -1)
    for b in range(B):
        hist[b, :counts[b]] = rng.integers(0, V, counts[b])
        if b % 2:  # the nucleus candidate in the window: RAS falls back
            cand = TS.nucleus_sample(logp[b], top_p, top_k, u=float(u[b, 0]))
            hist[b, max(0, counts[b] - 2):counts[b]] = cand
    got = TS.ras_sample_batch(torch.from_numpy(logits), torch.from_numpy(hist),
                              torch.from_numpy(counts), torch.from_numpy(u),
                              torch.from_numpy(steps), torch.from_numpy(mins), eos, top_p, top_k,
                              10, 0.1, fill_ids=fill_ids)
    fell_back = 0
    for b in range(B):
        decoded = [int(x) for x in hist[b, :counts[b]]]
        want = _numpy_ras(_numpy_log_probs(logits[b], steps[b], mins[b], eos, fill_ids),
                          decoded, top_p, top_k, 10, 0.1, float(u[b, 0]), float(u[b, 1]))
        host = TS.ras_sample(logp[b], decoded, top_p, top_k, 10, 0.1,
                             uniforms=(float(u[b, 0]), float(u[b, 1])))
        assert int(got[b]) == want == host, f"row {b}"
        masked = steps[b] < mins[b] or (steps[b] == 0 and not fill_ids)
        assert masked == bool(torch.isinf(logp[b, eos]))
        if fill_ids and steps[b] == 0:
            assert torch.isinf(logp[b, eos + 1:]).all() and int(got[b]) <= eos
        cand = TS.nucleus_sample(logp[b], top_p, top_k, u=float(u[b, 0]))
        fell_back += sum(x == cand for x in decoded[-10:]) >= 1
    assert fell_back >= 2, "no row exercised the fallback"


# -- (b) greedy parity with the JAX package --------------------------------


def _jax_llm(jcfg, jp, prefix, min_len, cap):
    res = jax.jit(lambda p, x: JL.llm_decode(JP(p), jcfg, jax.random.PRNGKey(0), x, x.shape[1],
                                             jnp.asarray(min_len), cap, **GREEDY))(
        jp, jnp.asarray(prefix))
    return [int(t) for t in np.asarray(res.tokens)[:int(res.length)]]


def _jax_qwen2(jp, prefix, min_len, cap):
    res = jax.jit(lambda p, x: JLM.qwen2lm_decode(JP(p), J_QCFG, jax.random.PRNGKey(0), x,
                                                   jnp.asarray(min_len), cap, **GREEDY))(
        jp, jnp.asarray(prefix))
    return [int(t) for t in np.asarray(res.tokens)[:int(res.length)]]


BOUNDS = [(0, 14), (5, 20), (9, 11)]  # (min_len, cap) of three rows


@pytest.mark.parametrize("how", ["solo", "segments", "batch"])
def test_greedy_llm_decode_equals_jax(llm, how):
    jcfg, jp, tcfg, tp = llm
    pres = _prefixes(jcfg.llm_input_size, (7, 5, 9), 11)
    want = [_jax_llm(jcfg, jp, pre, mn, cap) for pre, (mn, cap) in zip(pres, BOUNDS)]
    assert any(len(w) < cap for w, (_, cap) in zip(want, BOUNDS)), "no row stopped by EOS"
    with torch.inference_mode():
        if how == "solo":
            got = [TL.llm_decode(tp, tcfg, torch.from_numpy(pre), mn, cap, **GREEDY)
                   for pre, (mn, cap) in zip(pres, BOUNDS)]
        else:
            rows = [0] if how == "segments" else [0, 1, 2]
            st = TL.llm_decode_start(tp, tcfg, _left_pad([pres[b] for b in rows]),
                                     [pres[b].shape[1] for b in rows],
                                     [BOUNDS[b][0] for b in rows], [BOUNDS[b][1] for b in rows],
                                     _gens(rows), **GREEDY)
            while not all(st.done):
                st.run(st.i + 3 if how == "segments" else None)
            got = st.tokens + want[len(rows):]
    assert got == want


@pytest.mark.parametrize("how", ["solo", "segments", "batch"])
def test_greedy_qwen2_decode_equals_jax(qlm, how):
    jp, tp = qlm
    pres = _prefixes(32, (6, 4, 8), 12)
    want = [_jax_qwen2(jp, pre, mn, cap) for pre, (mn, cap) in zip(pres, BOUNDS)]
    assert all(want)
    with torch.inference_mode():
        if how == "solo":
            got = [TLM.qwen2lm_decode(tp, QCFG, torch.from_numpy(pre), mn, cap, **GREEDY)
                   for pre, (mn, cap) in zip(pres, BOUNDS)]
        else:
            rows = [1] if how == "segments" else [0, 1, 2]
            st = TLM.qwen2lm_decode_start(tp, QCFG, _left_pad([pres[b] for b in rows]),
                                          [pres[b].shape[1] for b in rows],
                                          [BOUNDS[b][0] for b in rows],
                                          [BOUNDS[b][1] for b in rows], _gens(rows), **GREEDY)
            while not all(st.done):
                st.run(st.i + 4 if how == "segments" else None)
            got = (want[:1] + st.tokens + want[2:]) if how == "segments" else st.tokens
    assert got == want


# -- (c) the host loop it replaces ------------------------------------------


def _host_llm(p, cfg, prefix, valid, mins, caps, gens, sampling, step_p=None, lora=None,
              vids=None, stop_every=None):
    """The per-token host loop: every step's logits read back and each live
    row sampled by ``ras_sample`` with two draws from its own generator."""
    B, L0 = prefix.shape[:2]
    lora, vids = TL._voice_rows(cfg, lora, vids, B)
    ctx = TL._decode_ctx(lora, vids, 1.0, prefix.device)
    logits, cache = TL._prefilled_cache(p, cfg, prefix, valid, L0 + max(caps), ctx)
    eos = cfg.speech_token_size
    toks, last, done = [[] for _ in range(B)], [0] * B, [False] * B

    def sample(b, lg):
        logp = torch.log_softmax(lg.float(), -1)
        if not toks[b] or len(toks[b]) < mins[b]:
            logp[eos] = -math.inf
        tok = TS.ras_sample(logp, toks[b], *sampling, generator=gens[b])
        if tok == eos:
            done[b] = True
            return
        toks[b].append(tok)
        last[b] = tok
        done[b] = len(toks[b]) >= caps[b]

    for b in range(B):
        sample(b, logits[b])
    while not all(done):
        cols = [L0 - 1 if d else L0 + len(t) - 1 for t, d in zip(toks, done)]
        lg = TL.llm_decode_step_batch(step_p or p, cfg, cache, last, cols, ctx)
        for b in [b for b in range(B) if not done[b]]:
            sample(b, lg[b])
    return toks


def _host_qwen2(p, prefix, valid, mins, caps, gens, sampling):
    B, L0 = prefix.shape[:2]
    logits, cache = TLM._prefilled_cache(p, QCFG, prefix, valid, L0 + max(caps))
    eos = QCFG.speech_token_size
    toks, att, last, done = [[] for _ in range(B)], [0] * B, [0] * B, [False] * B

    def sample(b, lg):
        lg = lg.float().clone()
        if att[b] == 0:
            lg[eos + 1:] = -math.inf
        logp = torch.log_softmax(lg, -1)
        if att[b] < mins[b]:
            logp[eos] = -math.inf
        tok = TS.ras_sample(logp, toks[b], *sampling, generator=gens[b])
        att[b] += 1
        if tok == eos:
            done[b] = True
            return
        if tok < eos:
            toks[b].append(tok)
            last[b] = tok
        done[b] = att[b] >= caps[b]

    for b in range(B):
        sample(b, logits[b])
    while not all(done):
        cols = [L0 - 1 if d else L0 + a - 1 for a, d in zip(att, done)]
        lg = TLM.qwen2lm_decode_step(p, QCFG, cache, last, cols)
        for b in [b for b in range(B) if not done[b]]:
            sample(b, lg[b])
    return toks, att


def _voices(p, nl, n=2, seed=9):
    """``n`` voices of seeded adapters on the decode's six modules, stacked."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        v = {}
        for i in range(nl):
            for m in TL._DECODE_LORA_MODS:
                o, k = p[f"llm.encoders.{i}.{m}.weight"].shape
                v[f"llm.encoders.{i}.{m}.lora_A"] = torch.from_numpy(
                    rng.standard_normal((2, k)).astype(np.float32))
                v[f"llm.encoders.{i}.{m}.lora_B"] = torch.from_numpy(
                    0.3 * rng.standard_normal((o, 2)).astype(np.float32))
        out.append(v)
    return stack_voice_loras(out, "cpu")


SAMPLING = (0.8, 25, 10, 0.1)


@pytest.mark.parametrize("case", ["B1", "B4", "int8", "voiced", "B4-segments"])
def test_device_decode_equals_the_host_loop(llm, case):
    jcfg, _, tcfg, tp = llm
    B = 1 if case == "B1" else 4
    pres = _prefixes(jcfg.llm_input_size, (7, 5, 9, 4)[:B], 20)
    mins, caps, seeds = [2, 0, 6, 3][:B], [30, 18, 24, 12][:B], [5, 6, 7, 8][:B]
    kw = {}
    if case == "int8":
        kw["step_p"] = TL.quantize_decode_step(tp, tcfg)
    if case == "voiced":
        kw.update(lora=_voices(tp.d, tcfg.llm.num_blocks), vids=[0, 1, 1, 0])
    prefix, valid = _left_pad(pres), [x.shape[1] for x in pres]
    with torch.inference_mode():
        want = _host_llm(tp, tcfg, prefix, valid, mins, caps, _gens(seeds), SAMPLING, **kw)
        st = TL.llm_decode_start(tp, tcfg, prefix, valid, mins, caps, _gens(seeds), **kw)
        while not all(st.done):
            st.run(st.i + 5 if case.endswith("segments") else None)
    assert st.tokens == want
    assert any(len(w) < c for w, c in zip(want, caps)), "no row stopped by EOS"


@pytest.mark.parametrize("B", [1, 4])
def test_qwen2_device_decode_equals_the_host_loop(qlm, B):
    _, tp = qlm
    pres = _prefixes(32, (6, 4, 8, 5)[:B], 21)
    mins, caps, seeds = [3, 0, 5, 1][:B], [25, 14, 20, 9][:B], [1, 2, 3, 4][:B]
    prefix, valid = _left_pad(pres), [x.shape[1] for x in pres]
    with torch.inference_mode():
        want, att = _host_qwen2(tp, prefix, valid, mins, caps, _gens(seeds), SAMPLING)
        st = TLM.qwen2lm_decode_start(tp, QCFG, prefix, valid, mins, caps, _gens(seeds))
        while not all(st.done):
            st.run(st.i + 3)
    assert st.tokens == want and st.attempts == att


# -- (d) the reads ----------------------------------------------------------


def test_a_step_makes_no_host_read(llm, monkeypatch):
    """Every way a tensor reaches the host raises inside a step."""
    jcfg, _, tcfg, tp = llm
    pres = _prefixes(jcfg.llm_input_size, (7, 5), 22)

    def no_read(*a, **k):
        raise AssertionError("a host read inside a decode step")

    real = TD.DeviceDecode._step

    def guarded(self, *a):
        with monkeypatch.context() as m:
            for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__",
                         "__index__"):
                m.setattr(torch.Tensor, name, no_read)
            return real(self, *a)

    monkeypatch.setattr(TD.DeviceDecode, "_step", guarded)
    with torch.inference_mode():
        st = TL.llm_decode_start(tp, tcfg, _left_pad(pres), [7, 5], [3, 0], [20, 20],
                                 _gens((1, 2)))
        st.run()
        qst = TLM.qwen2lm_decode_start(qlm_params(), QCFG, _left_pad(_prefixes(32, (6,), 3)),
                                       [6], [0], [12], _gens((4,)))
        qst.run()
    assert all(st.done) and st.tokens[0] and all(qst.done)


def qlm_params():
    return torch_params({k: v.numpy() for k, v in TLM.init_qwen2lm_params(QCFG, "cpu", seed=4)
                         .state_dict().items()})


def test_host_reads_are_bounded_by_chunks(llm):
    """A segment of s steps reads at most ceil(s / CHUNK) times (the
    all-done probes and the segment's one copy), not s times; a finished
    decode runs at most 2 * CHUNK - 1 steps in which every row was done, and
    a segment launched on done rows runs one chunk of them."""
    jcfg, _, tcfg, tp = llm
    C = TD.CHUNK
    pres = _prefixes(jcfg.llm_input_size, (7, 5), 23)
    with torch.inference_mode():
        st = TL.llm_decode_start(tp, tcfg, _left_pad(pres), [7, 5], [50, 50], [60, 60],
                                 _gens((1, 2)))
        for s in (1, C, 5 * C + 2, 13):
            before = st.host_reads
            st.run(st.i + s)
            assert 1 <= st.host_reads - before <= math.ceil(s / C) and st.frozen_steps == 0
        assert st.segments_run == 4 and not any(st.done)
        st = TL.llm_decode_start(tp, tcfg, _left_pad(pres), [7, 5], [0, 0], [80, 80],
                                 _gens((3, 4)))
        st.run()
        n = max(len(t) for t in st.tokens)
        assert all(st.done) and n < 60, "rows should stop by EOS"
        assert st.i - 1 - st.frozen_steps == n and st.frozen_steps <= 2 * C - 1
        before, i0 = st.frozen_steps, st.i
        st.run(st.i + 3 * C)
        assert st.i - i0 == C and st.frozen_steps - before == C


def test_a_segment_launched_ahead_enqueues_one_chunk_first(llm):
    """``launch(ahead=True)`` enqueues one chunk before the previous
    segment's read and the rest when it is waited for (or the next one is
    launched); the tokens are those of segments launched whole."""
    jcfg, _, tcfg, tp = llm
    C = TD.CHUNK
    pres = _prefixes(jcfg.llm_input_size, (7, 5), 24)

    def start():
        return TL.llm_decode_start(tp, tcfg, _left_pad(pres), [7, 5], [40, 40], [60, 60],
                                   _gens((5, 6)))

    with torch.inference_mode():
        whole = start()
        for stop in (11, 21, 31):
            whole.run(stop)
        st = start()
        first = st.launch(11)
        second = st.launch(21, ahead=True)
        assert st.i == 11 + C and first.copy is not None and second.copy is None
        first.wait()
        assert len(st.tokens[0]) == 11
        third = st.launch(31, ahead=True)  # enqueues the rest of the second first
        assert second.copy is not None and st.i == 21 + C
        second.wait()
        assert len(st.tokens[0]) == 21
        third.wait()
    assert st.i == whole.i == 31 and st.tokens == whole.tokens
