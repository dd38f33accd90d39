"""Text tokenizer: GPT-2-style BPE over the CosyVoice multilingual vocab.

The port's copy of the JAX package's ``data/tokenizer.py`` (pure Python, no
tensor code); the port imports nothing of that package.

Reference behavior: cosyvoice/tokenizer/tokenizer.py:169-238 (tiktoken
Encoding built from a base64 rank file plus ~1.7k special tokens appended to
reach text_token_size=51866).

The rank file is a model ASSET (like the .pt weights), not code — it is loaded
at runtime from the pretrained model dir / a configurable path.  The
special-token tail (tokenizer.py:179-199: languages, audio events, emotions,
ASR SPECIAL_TOKENs, TTS vocal tokens, 1501 timestamps) is registered with the
reference's exact names and order, so text containing literal special-token
strings (``<|endoftext|>``, vocal-event markup …) encodes id-identically when
``allowed_special`` permits them.  58836 ranks + 1679 specials (all 105
languages) = text_token_size 60515.
"""

from __future__ import annotations

import base64
import os
from functools import lru_cache
from typing import List, Optional, Sequence, Union

# Whisper-style language codes, in registration order (reference
# tokenizer.py:11-117 LANGUAGES keys; the tail entries are CosyVoice
# additions: minnan/wuyu/dialect/zh-en code-switch markers).
LANGUAGES = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue", "minnan", "wuyu", "dialect", "zh/en", "en/zh",
)

# reference tokenizer.py:135-147 / 149-154
AUDIO_EVENTS = ("ASR", "AED", "SER", "Speech", "/Speech", "BGM", "/BGM",
                "Laughter", "/Laughter", "Applause", "/Applause")
EMOTIONS = ("HAPPY", "SAD", "ANGRY", "NEUTRAL")

# reference tokenizer.py:157-166
TTS_VOCAL_TOKENS = ("TTS/B", "TTS/O", "TTS/Q", "TTS/A", "TTS/CO", "TTS/CL",
                    "TTS/H") + tuple(f"TTS/SP{i:02d}" for i in range(1, 14))


def build_specials(num_languages: int = len(LANGUAGES)) -> List[str]:
    """The ordered special-token names (reference tokenizer.py:179-199)."""
    return [
        "<|endoftext|>",
        "<|startoftranscript|>",
        *[f"<|{lang}|>" for lang in LANGUAGES[:num_languages]],
        *[f"<|{ev}|>" for ev in AUDIO_EVENTS],
        *[f"<|{emo}|>" for emo in EMOTIONS],
        "<|translate|>",
        "<|transcribe|>",
        "<|startoflm|>",
        "<|startofprev|>",
        "<|nospeech|>",
        "<|notimestamps|>",
        *[f"<|SPECIAL_TOKEN_{i}|>" for i in range(1, 31)],   # ASR specials
        *[f"<|{tts}|>" for tts in TTS_VOCAL_TOKENS],         # TTS specials
        *[f"<|{i * 0.02:.2f}|>" for i in range(1501)],       # timestamps
    ]

_VOCAB_SEARCH_PATHS = [
    os.environ.get("COSY_TPU_TOKENIZER_VOCAB", ""),
    "pretrained_models/CosyVoice-300M/multilingual_zh_ja_yue_char_del.tiktoken",
]

# GPT-2 split pattern (public; openai/tiktoken)
_PAT_STR = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""

TEXT_TOKEN_SIZE = 60515  # CosyVoice-300M text_token_size (58836 ranks + specials)


def find_vocab_file(path: Optional[str] = None) -> Optional[str]:
    candidates = ([path] if path else []) + _VOCAB_SEARCH_PATHS
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None


class TextTokenizer:
    """Encode normalized text to LLM text-token ids."""

    def __init__(self, vocab_path: Optional[str] = None, explicit_n_vocab: int = TEXT_TOKEN_SIZE):
        import tiktoken

        vocab = find_vocab_file(vocab_path)
        if vocab is None:
            raise FileNotFoundError(
                "tokenizer vocab not found; set COSY_TPU_TOKENIZER_VOCAB or place "
                "multilingual_zh_ja_yue_char_del.tiktoken in the pretrained model dir")
        ranks = {
            base64.b64decode(tok): int(rank)
            for tok, rank in (line.split() for line in open(vocab) if line.strip())
        }
        n = len(ranks)
        names = build_specials()
        if explicit_n_vocab != n + len(names):
            # non-300M vocab build: register as many named specials as fit
            # (languages are trimmed first, like the reference's
            # num_languages knob), padding timestamps never get dropped
            n_special = max(1, explicit_n_vocab - n)
            drop = len(names) - n_special
            if drop > 0:
                names = names[:2 + len(LANGUAGES) - drop] + names[2 + len(LANGUAGES):]
            else:
                names = names + [f"<|special_{i}|>" for i in range(-drop)]
        special = {tok: n + i for i, tok in enumerate(names)}
        self.encoding = tiktoken.Encoding(
            name=os.path.basename(vocab),
            explicit_n_vocab=n + len(special),
            pat_str=_PAT_STR,
            mergeable_ranks=ranks,
            special_tokens=special,
        )
        self.vocab_size = n + len(special)

    def encode(self, text: str,
               allowed_special: Union[str, Sequence[str]] = "all") -> List[int]:
        # the reference frontend always encodes with allowed_special='all'
        # (cli/frontend.py:101,120)
        if allowed_special == "all":
            return self.encoding.encode(text, allowed_special="all")
        return self.encoding.encode(text, allowed_special=set(allowed_special))

    def decode(self, ids: List[int]) -> str:
        return self.encoding.decode(ids)


@lru_cache(maxsize=1)
def default_tokenizer() -> TextTokenizer:
    return TextTokenizer()


# ---------------------------------------------------------------------------
# CosyVoice2 text tokenizer (Qwen2 BPE)
# ---------------------------------------------------------------------------

# Reference: cosyvoice/tokenizer/tokenizer.py:241-261 — the exact special
# tokens CosyVoice2 appends to the stock Qwen2 tokenizer.  Order matters:
# added ids are assigned sequentially after the base vocab.
QWEN_SPECIAL_TOKENS = {
    "eos_token": "<|endoftext|>",
    "pad_token": "<|endoftext|>",
    "additional_special_tokens": [
        "<|im_start|>", "<|im_end|>", "<|endofprompt|>",
        "[breath]", "<strong>", "</strong>", "[noise]",
        "[laughter]", "[cough]", "[clucking]", "[accent]",
        "[quick_breath]",
        "<laughter>", "</laughter>",
        "[hissing]", "[sigh]", "[vocalized-noise]",
        "[lipsmack]", "[mn]",
    ],
}


class QwenTokenizer:
    """CosyVoice2 text tokenizer (reference tokenizer.py:241-279).

    Wraps the HF tokenizer found at ``token_path`` (the CosyVoice2 model dir
    ships the Qwen2 tokenizer files; the repository has no copy, so construction
    requires a real model dir) and registers the CosyVoice2 special-token
    set.  ``encode`` returns plain python ids; ``decode`` drops special
    tokens by default, matching the reference.
    """

    def __init__(self, token_path: str, skip_special_tokens: bool = True):
        from transformers import AutoTokenizer

        self.tokenizer = AutoTokenizer.from_pretrained(token_path)
        self.tokenizer.add_special_tokens(QWEN_SPECIAL_TOKENS)
        self.skip_special_tokens = skip_special_tokens

    @property
    def vocab_size(self) -> int:
        return len(self.tokenizer)

    def encode(self, text: str, **kwargs) -> List[int]:
        return self.tokenizer([text])["input_ids"][0]

    def decode(self, ids: List[int]) -> str:
        return self.tokenizer.batch_decode(
            [ids], skip_special_tokens=self.skip_special_tokens)[0]


@lru_cache(maxsize=None)
def get_qwen_tokenizer(token_path: str, skip_special_tokens: bool = True) -> QwenTokenizer:
    return QwenTokenizer(token_path, skip_special_tokens)
