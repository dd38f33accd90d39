"""The port's text frontend, feature ops and inference frontend on the CPU
against the JAX package: text normalization, paragraph splitting and the
number spell-outs on the JAX tests' own cases (tests/test_text_frontend.py
and tests/test_textnorm.py run against the port's functions, and the
results compared with JAX's), the tiktoken and Qwen tokenizers on
synthetic vocabularies, the mel frontend at 22.05 and 24 kHz, the whisper
log-mel and kaldi fbank against JAX and the torch-recorded goldens, and
all five ``Frontend`` builders equal to JAX's dicts with fallback and with
replica ONNX extractors.  Tolerance 2e-4 for features, exact for strings
and ids."""

import base64
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_text_frontend as jtf
import test_textnorm as jtn
from cosy_tpu.compat import replicas as JR
from cosy_tpu.data import frontend as JF
from cosy_tpu.data import prepare as JPR
from cosy_tpu.data import text as JT
from cosy_tpu.data import textnorm as JTN
from cosy_tpu.data import tokenizer as JTK
from cosy_tpu.ops import audio as JA
from cosy_tpu_torch.data import frontend as TF
from cosy_tpu_torch.data import prepare as TPR
from cosy_tpu_torch.data import text as TT
from cosy_tpu_torch.data import textnorm as TTN
from cosy_tpu_torch.data import tokenizer as TTK
from cosy_tpu_torch.ops import audio as TA
from test_torch_common import GOLDEN_DIR, assert_close
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=2e-4, rtol=2e-4)

# ---------------------------------------------------------------------------
# text
# ---------------------------------------------------------------------------

TEXT_NAMES = ["contains_chinese", "en_number_to_words", "remove_bracket", "replace_blank",
              "split_paragraph", "spell_out_numbers", "text_normalize", "zh_number_to_words"]
FRONTEND_TESTS = [n for n in dir(jtf) if n.startswith("test_")]
TEXTNORM_TESTS = ["test_ordinal_words", "test_text_normalize_end_to_end_zh",
                  "test_text_normalize_end_to_end_en", "test_no_digits_survive_normalization_fuzz"]


@pytest.mark.parametrize("name", FRONTEND_TESTS + TEXTNORM_TESTS)
def test_jax_text_tests_pass_on_the_port(name, monkeypatch):
    """The JAX package's text tests, run with the port's functions in place
    of JAX's."""
    mod = jtf if name in FRONTEND_TESTS else jtn
    for n in TEXT_NAMES + ["en_ordinal_words", "normalize_en", "normalize_zh"]:
        if hasattr(mod, n):
            monkeypatch.setattr(mod, n, getattr(TT, n, None) or getattr(TTN, n))
    getattr(mod, name)()


@pytest.mark.parametrize("lang", ["zh", "en"])
def test_normalize_cases_equal_jax(lang):
    cases = jtn.ZH_CASES if lang == "zh" else jtn.EN_CASES
    fn = "normalize_" + lang
    for raw, want in cases + [("会议定于2023-05-12举行", None), ("5-10个", None)]:
        got = getattr(TTN, fn)(raw)
        assert got == getattr(JTN, fn)(raw) and (want is None or got == want), raw
        assert TT.text_normalize(raw) == JT.text_normalize(raw), raw


def test_split_paragraph_equals_jax():
    byte_tok = lambda s: list(s.encode("utf-8"))  # noqa: E731
    texts = [("The 21st meeting costs $5.50. It starts at 9:30, ends at noon; bring notes! " * 6,
              "en"),
             ("今天是2024年5月1日，天气很好。我们去公园散步，然后吃午饭！" * 5, "zh")]
    for text, lang in texts:
        norm = TT.text_normalize(text)
        assert norm == JT.text_normalize(text)
        for kw in (dict(token_max_n=80, token_min_n=60, merge_len=20),
                   dict(token_max_n=30, token_min_n=10, merge_len=5)):
            got = TT.split_paragraph(norm, byte_tok, lang, **kw)
            assert got == JT.split_paragraph(norm, byte_tok, lang, **kw) and len(got) > 1


# ---------------------------------------------------------------------------
# tokenizers
# ---------------------------------------------------------------------------


def _tiktoken_vocab(path):
    """A byte-level rank file (all 256 bytes) with a few merges."""
    ranks = [bytes([b]) for b in range(256)] + [b"th", b"he", b" t", b"the", b" the", b"in",
                                                 b"ing", b"er", b"\xe4\xbd"]
    with open(path, "w") as f:
        for i, tok in enumerate(ranks):
            f.write(f"{base64.b64encode(tok).decode()} {i}\n")
    return str(path)


@pytest.mark.parametrize("n_vocab", [60515, 265 + 1679, 265 + 1600])
def test_text_tokenizer_equals_jax(tmp_path, n_vocab):
    pytest.importorskip("tiktoken")
    vocab = _tiktoken_vocab(tmp_path / "v.tiktoken")
    jt, tt = JTK.TextTokenizer(vocab, n_vocab), TTK.TextTokenizer(vocab, n_vocab)
    assert tt.vocab_size == jt.vocab_size == n_vocab
    for text in ("the thing in the ring", "你好, world<|endoftext|>!",
                 "<|en|><|zh|> [laughter] tell them", ""):
        ids = tt.encode(text)
        assert ids == jt.encode(text) and tt.decode(ids) == jt.decode(ids) == text
    assert tt.encode("<|en|> the", allowed_special=("<|en|>",)) == \
        jt.encode("<|en|> the", allowed_special=("<|en|>",))
    assert TTK.build_specials() == JTK.build_specials()
    assert TTK.QWEN_SPECIAL_TOKENS == JTK.QWEN_SPECIAL_TOKENS


def test_qwen_tokenizer_equals_jax(tmp_path):
    """The tiny HF tokenizer directory of tests/test_qwen_tokenizer.py."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {chr(c): i for i, c in enumerate(range(ord("a"), ord("z") + 1))}
    vocab.update({" ": 26, "<|endoftext|>": 27})
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[]))
    tok.pre_tokenizer = pre_tokenizers.Split("", "isolated")
    PreTrainedTokenizerFast(tokenizer_object=tok).save_pretrained(str(tmp_path))
    jq, tq = JTK.QwenTokenizer(str(tmp_path)), TTK.QwenTokenizer(str(tmp_path))
    assert tq.vocab_size == jq.vocab_size
    for text in ("abc", "hello world<|endofprompt|>", "[breath] a [laughter]"):
        ids = tq.encode(text)
        assert ids == jq.encode(text) and tq.decode(ids) == jq.decode(ids)


# ---------------------------------------------------------------------------
# feature ops
# ---------------------------------------------------------------------------


MEL24 = dict(sr=24000, n_fft=1920, hop=480, win=1920)


@pytest.mark.parametrize("kw", [{}, MEL24], ids=["22k05", "24k"])
def test_mel_spectrogram_equals_jax(kw):
    rng = np.random.default_rng(3)
    y = (0.3 * rng.standard_normal((2, 11025 + 77))).astype(np.float32)
    got = TA.mel_spectrogram(torch.from_numpy(y), **kw)
    want = np.asarray(JA.mel_spectrogram(jnp.asarray(y), **kw))
    n_fft, hop = kw.get("n_fft", 1024), kw.get("hop", 256)
    assert got.shape == want.shape == (2, 80, TA.num_mel_frames(y.shape[1], n_fft, hop))
    assert TA.num_mel_frames(y.shape[1], n_fft, hop) == JA.num_mel_frames(y.shape[1], n_fft, hop)
    assert_close(got, want, **TOL)
    # the prepadded form over a reflect-padded signal with a zero tail: its
    # first frames are the unpadded call's
    pad = (n_fft - hop) // 2
    yp = np.pad(np.pad(y, ((0, 0), (pad, pad)), mode="reflect"), ((0, 0), (0, 3 * hop)))
    gotp = TA.mel_spectrogram_prepadded(torch.from_numpy(yp), **kw)
    assert_close(gotp, np.asarray(JA.mel_spectrogram_prepadded(jnp.asarray(yp), **kw)), **TOL)
    assert_close(gotp[:, :, :want.shape[2]], want, **TOL)
    assert np.array_equal(TA.mel_filterbank(24000, 1920), JA.mel_filterbank(24000, 1920))


def test_stft_magnitude_golden():
    blob = np.load(os.path.join(GOLDEN_DIR, "stft.npz"))
    wav = torch.from_numpy(blob["in:wav"])
    pad = (1024 - 256) // 2
    y = torch.nn.functional.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
    assert_close(TA.stft_magnitude(y), blob["out:mag"], atol=1e-3, rtol=2e-4)


def test_whisper_log_mel_and_kaldi_fbank():
    g = np.load(os.path.join(GOLDEN_DIR, "whisper_mel.npz"))
    for name in ("noise_1s", "chirp_2p3s", "harm_1s"):
        wav = np.asarray(g[f"wav_{name}"])
        got = TPR.whisper_log_mel(wav)
        assert np.array_equal(got, JPR.whisper_log_mel(wav))
        assert_close(got, g[f"mel_{name}"], atol=1e-4, rtol=0, name=name)
        fb = TPR.kaldi_fbank(wav)
        assert fb.shape == (98 if name != "chirp_2p3s" else 228, 80)
        assert np.array_equal(fb, JPR.kaldi_fbank(wav))


# ---------------------------------------------------------------------------
# Frontend
# ---------------------------------------------------------------------------

CAMPPLUS = dict(fcm_ch=8, ch=32, growth=16, emb=24)
S3 = dict(d=32, heads=4, n_layers=2, n_codes=64, dv=16, max_t=512)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A model dir with replica campplus and S3 graphs, a spk2info.pt and a
    synthetic tiktoken vocabulary."""
    d = tmp_path_factory.mktemp("model_dir")
    (d / "campplus.onnx").write_bytes(JR.make_campplus_replica(seed=5, **CAMPPLUS)[1])
    (d / "speech_tokenizer_v1.onnx").write_bytes(JR.make_s3_replica(seed=6, **S3)[1])
    emb = torch.from_numpy(np.random.default_rng(7).standard_normal((1, 24)).astype(np.float32))
    torch.save({"spk1": {"embedding": emb}}, str(d / "spk2info.pt"))
    _tiktoken_vocab(d / "multilingual_zh_ja_yue_char_del.tiktoken")
    return str(d)


def _same_dict(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.integer):
            assert np.array_equal(g, w), k
        else:
            assert_close(g, w, **TOL, name=k)


@pytest.mark.parametrize("extractors", ["fallback", "replica"])
@pytest.mark.parametrize("sr", [22050, 24000])
def test_frontend_builders_equal_jax(model_dir, extractors, sr, tmp_path):
    if extractors == "replica":
        pytest.importorskip("tiktoken")
    mdir = model_dir if extractors == "replica" else str(tmp_path)
    if extractors == "fallback":  # speakers, but no model files
        torch.save(torch.load(os.path.join(model_dir, "spk2info.pt")), str(tmp_path / "spk2info.pt"))
    jf = JF.Frontend(mdir, sample_rate=sr)
    tf = TF.Frontend(mdir, sample_rate=sr, device="cpu")
    assert (tf.speech_tokenizer is None) == (extractors == "fallback")
    assert (tf.tokenizer is None) == (extractors == "fallback")
    rng = np.random.default_rng(sr)
    prompt = (0.2 * rng.standard_normal(24000)).astype(np.float32)  # 1.5 s at 16 kHz
    source = (0.2 * rng.standard_normal(17000)).astype(np.float32)
    for name, args in (("frontend_sft", ("the thing", "spk1")),
                       ("frontend_zero_shot", ("the thing 21", "in the ring", prompt)),
                       ("frontend_cross_lingual", ("你好 the", prompt)),
                       ("frontend_instruct", ("then", "spk1", "speak softly")),
                       ("frontend_vc", (source, prompt))):
        _same_dict(getattr(tf, name)(*args), getattr(jf, name)(*args))
    for text in ("The 21st meeting costs $5.50. " * 8, "今天是2024年5月1日，天气很好。" * 6):
        assert tf.normalize(text) == jf.normalize(text)
        assert tf.normalize(text, split=False) == jf.normalize(text, split=False)


def test_frontend_raises_on_a_broken_model_file(tmp_path):
    """Where a model file is present but does not load, the port raises (the
    JAX frontend warns and carries on with random tokens)."""
    (tmp_path / "campplus.onnx").write_bytes(b"\x08\x08not a graph")
    with pytest.raises(Exception):
        TF.Frontend(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="30s"):
        TF.Frontend(device="cpu").extract_speech_token(np.zeros(16000 * 31, np.float32))
