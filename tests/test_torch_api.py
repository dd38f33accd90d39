"""The user API and prompted synthesis of the port (CPU) at
tiny_model_config(): the prompted LLM prefix (prompt text, prompt speech
tokens, speaker row present and absent) against JAX's ``_build_prefix``
(2e-4, min / max lengths exact); a prompted ``token2wav`` against JAX with
JAX's draws injected; the voice-conversion route and a streamed prompted
synthesis against the port's own windows; every mode of ``CosyVoice`` on a
tiny API built with ``__new__`` (as tests/test_api.py does) and one loaded
from a model dir; ``CosyVoice2.inference_instruct2`` dropping the LLM
speech prompt; ``compat.yaml_config`` against the JAX package's on
tests/test_yaml_config.py's yaml texts (``dataclasses.asdict``)."""

import dataclasses
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import cosy_tpu.compat.yaml_config as JY
from cosy_tpu.config import tiny_model_config as j_tiny
from cosy_tpu.infer.pipeline import TTSPipeline as JPipeline
import cosy_tpu_torch.compat.yaml_config as TY
from cosy_tpu_torch.api import CosyVoice, CosyVoice2
from cosy_tpu_torch.config import InferenceConfig
from cosy_tpu_torch.data.frontend import Frontend
from cosy_tpu_torch.infer.pipeline import StreamCursor, TTSPipeline, stream_seed
from cosy_tpu_torch.params import save_torch_checkpoint
from test_torch_common import assert_close, port_config, port_modules, tiny_flats
from test_torch_stream import _draws
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=2e-4, rtol=2e-4)
SPK = np.random.default_rng(11).standard_normal((1, 192)).astype(np.float32)
SHORT = InferenceConfig(max_token_text_ratio=3.0)  # short decodes keep the API tests cheap


@pytest.fixture(scope="module")
def pair():
    jcfg = j_tiny()
    tcfg = port_config(jcfg)
    flats = tiny_flats(jcfg, seed=20)
    jpipe = JPipeline(jcfg, *({k: jnp.asarray(v) for k, v in flats[n].items()}
                              for n in ("llm", "flow", "hift")), finetuned_norm=True)
    mods = port_modules(tcfg, flats)
    return jcfg, tcfg, flats, jpipe, TTSPipeline(tcfg, *mods, finetuned_norm=True), mods


def _ids(n, seed, hi=255):
    return np.random.default_rng(seed).integers(1, hi, (1, n)).astype(np.int32)


@pytest.mark.parametrize("case", ["prompted", "prompt_text_no_spk", "plain_no_spk"])
def test_prompted_prefix_matches_jax(pair, case):
    """[sos, spk?, prompt text + text, task, prompt speech?]: the bounds
    count the target text only (cosy_tpu/infer/pipeline.py:583-589)."""
    _, _, _, jpipe, tpipe, _ = pair
    text, ptext = _ids(9, 1), _ids(5, 2)
    pst = _ids(7, 3, hi=128)
    args = {"prompted": (ptext, pst, SPK), "prompt_text_no_spk": (ptext, None, None),
            "plain_no_spk": (None, None, None)}[case]
    want, jmin, jmax = jpipe._build_prefix(text, *args, 2048)
    got, tmin, tmax = tpipe._build_prefix(text, *args, 2048)
    assert (tmin, tmax) == (jmin, jmax) == (int(9 * 2), int(9 * 20))
    assert_close(got, np.asarray(want), **TOL)


def test_prompted_token2wav_matches_jax(pair):
    """31 target tokens after a 17-token / 43-frame flow prompt: the prompt
    conditions the solve, its region is dropped and the boundary trim cuts
    int(43 * 0.2) frames; z and HiFT's draws are JAX's own."""
    jcfg, _, _, jpipe, tpipe, _ = pair
    rng = np.random.default_rng(4)
    tok = rng.integers(0, 128, (1, 31)).astype(np.int32)
    ptok = rng.integers(0, 128, (1, 17)).astype(np.int32)
    pfeat = (rng.standard_normal((1, 43, 80)) * 2 - 6).astype(np.float32)
    key = jax.random.PRNGKey(5)
    mel2, trim = int(31 / 50 * 22050 / 256), int(43 * 0.2)
    want = jpipe._t2w_jit(jpipe.flow_params, jpipe.hift_params, key, jnp.asarray(tok),
                          jnp.asarray(ptok), jnp.asarray(pfeat), jnp.asarray(SPK), None,
                          trim=trim)
    T = 43 + mel2
    got = tpipe.token2wav(tok, SPK, ptok, pfeat, **_draws(jcfg, key, T + T % 2, mel2 - trim))
    assert got.shape == ((1, (mel2 - trim) * 256)) == np.asarray(want).shape
    assert_close(got, np.asarray(want), **TOL)


def test_vc_route_bypasses_the_llm(pair):
    """source_speech_token goes straight to token2wav with the flow prompt
    and embedding (the llm arguments are not read), whole and streamed."""
    _, _, _, _, tpipe, _ = pair
    rng = np.random.default_rng(6)
    src = rng.integers(0, 128, (1, 150))
    ptok, pfeat = rng.integers(0, 128, (1, 11)), rng.standard_normal((1, 19, 80)).astype(
        np.float32)
    kw = dict(source_speech_token=src, flow_prompt_speech_token=ptok, prompt_feat=pfeat,
              flow_embedding=SPK, seed=8)
    got = next(tpipe.synthesize(**kw))["tts_speech"]
    want = tpipe.token2wav(src, SPK, ptok, pfeat, generator=tpipe._wav_generator(8, 0, 0))
    np.testing.assert_array_equal(got, want)
    chunks = [c["tts_speech"] for c in tpipe.synthesize(stream=True, **kw)]
    cur = StreamCursor(SPK, 8, 0, tpipe.first_hop, prompt_token=ptok, prompt_feat=pfeat)
    want = list(tpipe.stream_chunks(cur, src, True))
    assert len(chunks) == len(want) == 2
    for g, w in zip(chunks, want):
        np.testing.assert_array_equal(g, w)


def test_streamed_prompted_synthesis_windows(pair):
    """A zero-shot stream: the decode's prefix carries the prompt text and
    speech tokens, and every window takes the flow prompt (the port's own
    token2wav per window, the same generators)."""
    _, tcfg, _, _, tpipe, _ = pair
    rng = np.random.default_rng(9)
    text, ptext = _ids(4, 10), _ids(3, 11)
    ptok, pfeat = rng.integers(0, 128, (1, 9)), rng.standard_normal((1, 17, 80)).astype(
        np.float32)
    got = [c["tts_speech"] for c in tpipe.synthesize(
        text, prompt_text=ptext, prompt_speech_token=ptok, prompt_feat=pfeat,
        spk_embedding=SPK, stream=True, seed=4, max_len_cap=24)]
    tokens = tpipe.generate_tokens(text, SPK, 24, tpipe._decode_generator(4, 0),
                                   prompt_text=ptext, prompt_speech_token=ptok)
    cur = StreamCursor(SPK, 4, 0, tpipe.first_hop, prompt_token=ptok, prompt_feat=pfeat)
    want = list(tpipe.stream_chunks(cur, tokens, True))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)


# -- the API ---------------------------------------------------------------


def _speech_tokenizer(wav16k):
    n = max(1, int(len(wav16k) / 16000 * 50))
    return np.random.default_rng(len(wav16k)).integers(0, 128, n)


def _spk_encoder(wav16k):
    return np.random.default_rng(len(wav16k) + 1).standard_normal(192).astype(np.float32)


def _tiny_api(pair, seed=0) -> CosyVoice:
    _, tcfg, _, _, _, mods = pair
    api = CosyVoice.__new__(CosyVoice)
    api.model_dir = "unused"
    api.cfg, api.sample_rate, api.device = tcfg, tcfg.sample_rate, torch.device("cpu")
    api.frontend = Frontend(None, tcfg.sample_rate, speech_tokenizer=_speech_tokenizer,
                            spk_encoder=_spk_encoder, device="cpu")
    api.model = TTSPipeline(tcfg, *mods, SHORT, finetuned_norm=True)
    api._seed, api._n = seed, 0
    return api


@pytest.fixture(scope="module")
def api(pair):
    return _tiny_api(pair)


PROMPT = (0.3 * np.sin(np.arange(8000) / 9.0)).astype(np.float32)


def _finite_chunks(gen):
    chunks = [c["tts_speech"] for c in gen]
    assert chunks and all(c.ndim == 2 and c.shape[0] == 1 and c.dtype == np.float32
                          and np.isfinite(c).all() for c in chunks)
    return chunks


def test_api_modes_yield_finite_chunks(api):
    """Every mode through the public methods: zero-shot (whole and
    streamed), a registered zero-shot speaker, cross-lingual, sft,
    instruct, vc."""
    _finite_chunks(api.inference_zero_shot("Hi.", "Hello there.", PROMPT))
    assert len(_finite_chunks(api.inference_zero_shot("Hi.", "Hello there.", PROMPT,
                                                      stream=True))) >= 1
    assert api.add_zero_shot_spk("Hello there.", PROMPT, "alice")
    assert "alice" in api.list_available_spks()
    _finite_chunks(api.inference_zero_shot("Hi.", "", None, zero_shot_spk_id="alice"))
    _finite_chunks(api.inference_cross_lingual("Hi.", PROMPT))
    api.frontend.spk2info["spk_a"] = {"embedding": SPK}
    _finite_chunks(api.inference_sft("Good day.", "spk_a"))
    _finite_chunks(api.inference_instruct("Good day.", "spk_a", "speak slowly"))
    # a speaker registered by add_zero_shot_spk serves sft and instruct too
    _finite_chunks(api.inference_instruct("Good day.", "alice", "speak slowly"))
    src = (0.2 * np.cos(np.arange(12000) / 7.0)).astype(np.float32)
    out = _finite_chunks(api.inference_vc(src, PROMPT))
    # VC: the source's tokens bypass the LLM; the prompt's mel region is
    # dropped and the boundary trim cuts a fifth of its length more
    d = api.frontend.frontend_vc(src, PROMPT)
    n_src, n_feat = d["source_speech_token"].shape[1], d["prompt_speech_feat"].shape[1]
    assert out[0].shape[1] == 256 * (int(n_src / 50 * 22050 / 256) - int(n_feat * 0.2))


def test_instruct_omits_the_llm_speaker_row(api, pair):
    """frontend_instruct drops the LLM embedding: the prefix has no speaker
    row (the instruction is the LLM's prompt text), the flow keeps it."""
    api.frontend.spk2info["spk_a"] = {"embedding": SPK}
    d = api.frontend.frontend_instruct("good day.", "spk_a", "speak slowly")
    kw = api._model_kwargs(d)
    assert kw["llm_embedding"] is None and kw["flow_embedding"] is not None
    pre, _, _ = api.model._build_prefix(kw["text_tokens"], kw["prompt_text"], None, None, 2048)
    with_row, _, _ = api.model._build_prefix(kw["text_tokens"], kw["prompt_text"], None, SPK,
                                             2048)
    n = kw["text_tokens"].shape[1] + kw["prompt_text"].shape[1]
    assert pre.shape[1] == n + 2 and with_row.shape[1] == n + 3


def test_api_seeds_are_deterministic(pair):
    """Request n draws from stream_seed(seed, n, 0): two APIs with one seed
    replay each other, and consecutive requests differ."""
    a, b = _tiny_api(pair, seed=3), _tiny_api(pair, seed=3)
    wa = [next(a.inference_cross_lingual("Hi.", PROMPT))["tts_speech"] for _ in range(2)]
    wb = [next(b.inference_cross_lingual("Hi.", PROMPT))["tts_speech"] for _ in range(2)]
    for x, y in zip(wa, wb):
        np.testing.assert_array_equal(x, y)
    assert a._n == 2 and a._next_seed() == stream_seed(3, 3, 0) == 3 + (3 << 32)


def test_cosyvoice_loads_a_model_dir(pair, tmp_path):
    """CosyVoice(model_dir, device="cpu") loads llm/flow/hift.pt strictly and
    synthesizes; without a card and without device it raises; a saved
    speaker registry is read back."""
    _, tcfg, flats, _, _, _ = pair
    for part in ("llm", "flow", "hift"):
        save_torch_checkpoint(flats[part], str(tmp_path / f"{part}.pt"))
    api = CosyVoice(str(tmp_path), model_cfg=tcfg, infer_cfg=SHORT, device="cpu")
    api.frontend.speech_tokenizer, api.frontend.spk_encoder = _speech_tokenizer, _spk_encoder
    _finite_chunks(api.inference_cross_lingual("Hi.", PROMPT))
    api.add_zero_shot_spk("Hello.", PROMPT, "bob")
    api.save_spkinfo()
    again = CosyVoice(str(tmp_path), model_cfg=tcfg, device="cpu")
    assert again.list_available_spks() == ["bob"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            CosyVoice(str(tmp_path), model_cfg=tcfg)


class _Spy:
    """Records the keyword arguments of synthesize and yields one chunk."""

    def __init__(self):
        self.calls = []

    def synthesize(self, **kw):
        self.calls.append(kw)
        yield {"tts_speech": np.zeros((1, 4), np.float32)}


def test_cosyvoice2_instruct2_drops_the_llm_speech_prompt():
    api = CosyVoice2.__new__(CosyVoice2)
    api.sample_rate = 24000
    api.frontend = Frontend(None, 24000, speech_tokenizer=_speech_tokenizer,
                            spk_encoder=_spk_encoder, device="cpu")
    api.model, api._seed, api._n = _Spy(), 0, 0
    list(api.inference_instruct2("Hi.", "Speak softly.", PROMPT))
    kw = api.model.calls[0]
    assert kw["llm_prompt_speech_token"] is None and "llm_embedding" not in kw
    assert kw["flow_prompt_speech_token"] is not None and kw["prompt_feat"] is not None
    want = api.frontend.extract_text_token("Speak softly.<|endofprompt|>")
    np.testing.assert_array_equal(kw["prompt_text"], want)
    list(api.inference_zero_shot("Hi.", "Hello.", PROMPT))
    assert api.model.calls[1]["llm_prompt_speech_token"] is not None
    with pytest.raises(NotImplementedError):
        api.inference_instruct("a", "b", "c")


# -- yaml ------------------------------------------------------------------


def _yaml_texts():
    src = open(os.path.join(os.path.dirname(__file__), "test_yaml_config.py")).read()
    texts = [m for m in re.findall(r'"""(.*?)"""', src, re.S) if "!new:" in m]
    assert len(texts) == 2
    return texts


@pytest.mark.parametrize("which", ["v1", "cv2"])
def test_yaml_config_matches_jax(which):
    text = _yaml_texts()[0 if which == "v1" else 1]
    if which == "v1":
        assert dataclasses.asdict(TY.model_config_from_yaml(text)) == \
            dataclasses.asdict(JY.model_config_from_yaml(text))
        assert dataclasses.asdict(TY.inference_config_from_yaml(text)) == \
            dataclasses.asdict(JY.inference_config_from_yaml(text))
        assert TY.parse_hyperyaml(text) == JY.parse_hyperyaml(text)
    else:
        got, want = TY.cv2_configs_from_yaml(text), JY.cv2_configs_from_yaml(text)
        for g, w in zip(got[:3], want[:3]):
            assert dataclasses.asdict(g) == dataclasses.asdict(w)
        assert got[3] == want[3] == 24000
