"""Inference frontend: text/audio -> model inputs (the port of the JAX
package's ``data/frontend.py``).

Reference behavior: cosyvoice/cli/frontend.py (CosyVoiceFrontEnd).  The
prompt mel runs on the frontend's device (CUDA unless the caller passes
another), the host features (whisper mel, kaldi fbank) in numpy; the two
frozen ONNX models (speech tokenizer, campplus speaker encoder) are the
extractors of data prep, run by the port's executor on the same device.
An absent model file selects the reference's deterministic fallback (data
behaviour); a model file that is present but fails to load raises (the JAX
frontend warns and carries on with random tokens).
"""

from __future__ import annotations

import os
import re
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops import audio as A
from ..params import resolve_device
from .prepare import (
    OnnxCampplus, OnnxSpeechTokenizer, fallback_embedding,
    fallback_speech_tokenizer, resample,
)
from .text import contains_chinese, split_paragraph, text_normalize
from .tokenizer import TextTokenizer, find_vocab_file


def is_only_punctuation(text: str) -> bool:
    return re.fullmatch(r"[\W_]*", text) is not None


class Frontend:
    """Builds the model-input dicts for every inference mode
    (frontend.py:190-254)."""

    def __init__(
        self,
        model_dir: Optional[str] = None,
        sample_rate: int = 22050,
        speech_tokenizer: Optional[Callable] = None,
        spk_encoder: Optional[Callable] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.sample_rate = sample_rate
        # mel parameters follow the model family's feat_extractor: CosyVoice
        # (22.05 kHz) uses the matcha mel defaults; CosyVoice2 (24 kHz) uses
        # n_fft 1920 / hop 480 / win 1920 (50 fps at token_mel_ratio 2) —
        # the 22.05 kHz defaults would produce a 93.75 fps mel with the
        # wrong filterbank for CV2 prompt conditioning
        self._mel_kw = ({"sr": 24000, "n_fft": 1920, "hop": 480, "win": 1920}
                        if sample_rate == 24000 else {})
        vocab = find_vocab_file(
            os.path.join(model_dir, "multilingual_zh_ja_yue_char_del.tiktoken")
            if model_dir else None)
        self.tokenizer = TextTokenizer(vocab) if vocab else None

        self.speech_tokenizer = speech_tokenizer
        self.spk_encoder = spk_encoder
        if model_dir:
            # v1 (CosyVoice-300M) and v2 (CosyVoice2) tokenizers share the
            # ONNX interface; pick whichever the model dir ships
            st_path = next(
                (q for q in (os.path.join(model_dir, "speech_tokenizer_v2.onnx"),
                             os.path.join(model_dir, "speech_tokenizer_v1.onnx"))
                 if os.path.exists(q)),
                os.path.join(model_dir, "speech_tokenizer_v1.onnx"))
            cp_path = os.path.join(model_dir, "campplus.onnx")
            if speech_tokenizer is None and os.path.exists(st_path):
                self.speech_tokenizer = OnnxSpeechTokenizer(st_path, self.device)
            if spk_encoder is None and os.path.exists(cp_path):
                self.spk_encoder = OnnxCampplus(cp_path, self.device)

        self.spk2info: Dict[str, dict] = {}
        if model_dir:
            spk_path = os.path.join(model_dir, "spk2info.pt")
            if os.path.exists(spk_path):
                try:
                    # a dict of tensors loads with weights_only=True; an
                    # arbitrary pickle only behind an explicit opt-in (the
                    # reference loads unsafely, frontend.py:71)
                    try:
                        raw = torch.load(spk_path, map_location="cpu", weights_only=True)
                    except Exception:  # noqa: BLE001
                        if not os.environ.get("COSY_TPU_UNSAFE_PICKLE"):
                            raise
                        raw = torch.load(spk_path, map_location="cpu", weights_only=False)
                    self.spk2info = {
                        k: {kk: np.asarray(vv) if hasattr(vv, "numpy") else vv
                            for kk, vv in v.items()}
                        for k, v in raw.items()
                    }
                except Exception as e:  # noqa: BLE001
                    print(f"[WARN] spk2info load failed: {e}")

    # -- feature extraction --------------------------------------------

    def extract_text_token(self, text: str) -> np.ndarray:
        if self.tokenizer is None:
            return np.asarray([list(text.encode("utf-8"))], np.int32)
        return np.asarray([self.tokenizer.encode(text)], np.int32)

    def extract_speech_token(self, wav16k: np.ndarray) -> np.ndarray:
        if len(wav16k) / 16000 > 30:
            raise ValueError("do not support extract speech token for audio longer than 30s")
        if self.speech_tokenizer is not None:
            return np.asarray(self.speech_tokenizer(wav16k), np.int32)[None]
        return fallback_speech_tokenizer(wav16k)[None].astype(np.int32)

    def extract_spk_embedding(self, wav16k: np.ndarray) -> np.ndarray:
        if self.spk_encoder is not None:
            return np.asarray(self.spk_encoder(wav16k), np.float32)[None]
        return fallback_embedding(seed=len(wav16k))[None]

    def extract_speech_feat(self, wav: np.ndarray) -> np.ndarray:
        """(T,) at sample_rate -> (1, T_mel, 80)."""
        y = torch.as_tensor(np.asarray(wav, np.float32)[None], device=self.device)
        return A.mel_spectrogram(y, **self._mel_kw).transpose(1, 2).cpu().numpy()

    # -- text normalization --------------------------------------------

    def normalize(self, text: str, split: bool = True,
                  text_frontend: bool = True):
        if text_frontend is False:
            # reference frontend.py:161-162: bypass normalization entirely
            # for pre-normalized input
            return [text] if split else text
        text = text_normalize(text)
        if not split:
            return text
        lang = "zh" if contains_chinese(text) else "en"
        tokenize = (self.tokenizer.encode if self.tokenizer
                    else (lambda t: list(t.encode("utf-8"))))
        texts = split_paragraph(text, tokenize, lang, token_max_n=80,
                                token_min_n=60, merge_len=20)
        return [t for t in texts if not is_only_punctuation(t)]

    # -- model-input builders (frontend.py:190-254) --------------------

    def frontend_sft(self, tts_text: str, spk_id: str) -> dict:
        """A registered speaker's embedding: ``embedding`` of a stock
        ``spk2info.pt`` entry, or the ``flow_embedding`` of a speaker that
        ``add_zero_shot_spk`` registered (it carries no ``embedding``)."""
        info = self.spk2info[spk_id]
        emb = info["embedding"] if "embedding" in info else info["flow_embedding"]
        emb = np.asarray(emb, np.float32).reshape(1, -1)
        return {"text": self.extract_text_token(tts_text),
                "llm_embedding": emb, "flow_embedding": emb}

    def frontend_zero_shot(self, tts_text: str, prompt_text: str,
                           prompt_speech_16k: np.ndarray,
                           zero_shot_spk_id: str = "") -> dict:
        out = {"text": self.extract_text_token(tts_text)}
        if zero_shot_spk_id:
            out.update(self.spk2info[zero_shot_spk_id])
            return out
        prompt_resampled = resample(prompt_speech_16k, 16000, self.sample_rate)
        speech_feat = self.extract_speech_feat(prompt_resampled)
        speech_token = self.extract_speech_token(prompt_speech_16k)
        emb = self.extract_spk_embedding(prompt_speech_16k)
        out.update({
            "prompt_text": self.extract_text_token(prompt_text) if prompt_text else np.zeros((1, 0), np.int32),
            "llm_prompt_speech_token": speech_token,
            "flow_prompt_speech_token": speech_token,
            "prompt_speech_feat": speech_feat,
            "llm_embedding": emb,
            "flow_embedding": emb,
        })
        return out

    def frontend_cross_lingual(self, tts_text: str, prompt_speech_16k: np.ndarray,
                               zero_shot_spk_id: str = "") -> dict:
        out = self.frontend_zero_shot(tts_text, "", prompt_speech_16k, zero_shot_spk_id)
        # cross-lingual: no prompt on the LLM side (frontend.py:220-228)
        out.pop("prompt_text", None)
        out.pop("llm_prompt_speech_token", None)
        return out

    def frontend_instruct(self, tts_text: str, spk_id: str, instruct_text: str) -> dict:
        out = self.frontend_sft(tts_text, spk_id)
        # instruct: drop llm spk embedding (information leakage), use instruct
        # text as the llm prompt (frontend.py:230-238)
        out.pop("llm_embedding", None)
        out["prompt_text"] = self.extract_text_token(instruct_text + "<endofprompt>")
        return out

    def frontend_vc(self, source_speech_16k: np.ndarray,
                    prompt_speech_16k: np.ndarray) -> dict:
        prompt_resampled = resample(prompt_speech_16k, 16000, self.sample_rate)
        return {
            "source_speech_token": self.extract_speech_token(source_speech_16k),
            "flow_prompt_speech_token": self.extract_speech_token(prompt_speech_16k),
            "prompt_speech_feat": self.extract_speech_feat(prompt_resampled),
            "flow_embedding": self.extract_spk_embedding(prompt_speech_16k),
        }
