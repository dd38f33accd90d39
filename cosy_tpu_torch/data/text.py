"""Lightweight text frontend: normalization + paragraph splitting.

The port's copy of the JAX package's ``data/text.py`` (pure Python, no
tensor code); the port imports nothing of that package.

Reference behavior: cosyvoice/cli/frontend.py:160-188 and
cosyvoice/utils/frontend_utils.py (the reference delegates heavy
normalization to ttsfrd/wetext/inflect; this is a self-contained
implementation of the same surface: punctuation/whitespace cleanup, number
verbalization for zh/en, and token-budget sentence splitting).
"""

from __future__ import annotations

import re
from typing import Callable, List

# ---------------------------------------------------------------------------
# number verbalization
# ---------------------------------------------------------------------------

_EN_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
            "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
            "sixteen", "seventeen", "eighteen", "nineteen"]
_EN_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
            "eighty", "ninety"]
_EN_SCALE = [(10 ** 9, "billion"), (10 ** 6, "million"), (1000, "thousand"), (100, "hundred")]

_ZH_DIGITS = "零一二三四五六七八九"
_ZH_UNITS = ["", "十", "百", "千"]
_ZH_SCALE = [(10 ** 8, "亿"), (10 ** 4, "万")]


def en_number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + en_number_to_words(-n)
    if n < 20:
        return _EN_ONES[n]
    if n < 100:
        t, r = divmod(n, 10)
        # hyphenated compounds (inflect/wetext convention, also what the
        # ordinal rule in textnorm.py keys on)
        return _EN_TENS[t] + ("" if r == 0 else "-" + _EN_ONES[r])
    for scale, name in _EN_SCALE:
        if n >= scale:
            head, rest = divmod(n, scale)
            s = en_number_to_words(head) + " " + name
            return s if rest == 0 else s + " " + en_number_to_words(rest)
    return str(n)


def zh_number_to_words(n: int) -> str:
    if n < 0:
        return "负" + zh_number_to_words(-n)
    if n == 0:
        return "零"
    for scale, name in _ZH_SCALE:
        if n >= scale:
            head, rest = divmod(n, scale)
            s = zh_number_to_words(head) + name
            if rest == 0:
                return s
            pad = "零" if rest < scale // 10 else ""
            return s + pad + zh_number_to_words(rest)
    out = []
    digits = [int(d) for d in str(n)]
    L = len(digits)
    for i, d in enumerate(digits):
        unit = _ZH_UNITS[L - 1 - i]
        if d == 0:
            if out and out[-1] != "零" and i < L - 1:
                out.append("零")
        else:
            if d == 1 and unit == "十" and i == 0:
                out.append(unit)  # 10..19: 十X not 一十X
            else:
                out.append(_ZH_DIGITS[d] + unit)
    return "".join(out).rstrip("零") or "零"


def contains_chinese(text: str) -> bool:
    return re.search(r"[一-鿿]", text) is not None


def spell_out_numbers(text: str, lang: str) -> str:
    def repl(m):
        s = m.group(0)
        if "." in s:
            intp, frac = s.split(".", 1)
            if lang == "zh":
                return zh_number_to_words(int(intp or 0)) + "点" + "".join(
                    _ZH_DIGITS[int(d)] for d in frac if d.isdigit())
            return en_number_to_words(int(intp or 0)) + " point " + " ".join(
                _EN_ONES[int(d)] for d in frac if d.isdigit())
        n = int(s)
        return zh_number_to_words(n) if lang == "zh" else en_number_to_words(n)

    return re.sub(r"\d+(?:\.\d+)?", repl, text)


# ---------------------------------------------------------------------------
# cleanup + split (frontend_utils.py behavior)
# ---------------------------------------------------------------------------

_CORNER_MARKS = "「」『』【】《》〈〉〔〕（）()[]{}<>\"“”‘’"


def remove_bracket(text: str) -> str:
    return text.translate({ord(c): None for c in _CORNER_MARKS})


def replace_blank(text: str) -> str:
    """Drop spaces between non-ascii (CJK) characters (frontend_utils.py:124-134)."""
    out = []
    for i, c in enumerate(text):
        if c == " ":
            prev_ok = i > 0 and text[i - 1].isascii() and text[i - 1] != " "
            next_ok = i + 1 < len(text) and text[i + 1].isascii() and text[i + 1] != " "
            if prev_ok and next_ok:
                out.append(c)
        else:
            out.append(c)
    return "".join(out)


def replace_corner_mark(text: str) -> str:
    """² / ³ -> spoken forms (frontend_utils.py:26-29)."""
    return text.replace("²", "平方").replace("³", "立方")


def text_normalize(text: str) -> str:
    """Normalize raw text for tokenization (frontend.py:160-188 surface).

    Structured TN (dates, times, units, phones, ordinals …) lives in
    textnorm.py — the self-contained replacement for the reference's
    wetext/inflect dependency."""
    from .textnorm import normalize_en, normalize_zh

    text = text.strip()
    lang = "zh" if contains_chinese(text) else "en"
    text = remove_bracket(text)
    if lang == "zh":
        text = normalize_zh(text)
        text = text.replace("\n", "").replace("…", "。").replace(" - ", "，")
        text = replace_corner_mark(text)
        # decimals were consumed by normalize_zh; remaining dots end sentences
        text = text.replace(".", "。")
        text = re.sub(r"[，,、]+$", "。", text)
        text = replace_blank(text)
    else:
        text = normalize_en(text)
        text = re.sub(r"\s+", " ", text)
    return text


def split_paragraph(
    text: str,
    tokenize: Callable[[str], List[int]],
    lang: str = "zh",
    token_max_n: int = 80,
    token_min_n: int = 60,
    merge_len: int = 20,
    comma_split: bool = False,
) -> List[str]:
    """Token-budget sentence splitter (frontend_utils.py:65-120 semantics):
    split at sentence punctuation, pack up to token_max_n, merge a short tail."""

    def length(t: str) -> int:
        return len(t) if lang == "zh" else len(tokenize(t))

    if lang == "zh":
        pounc = ["。", "？", "！", "；", "：", "、", ".", "?", "!", ";"]
    else:
        pounc = [".", "?", "!", ";", ":"]
    if comma_split:
        pounc += ["，", ","]
    if not text:
        return []
    if text[-1] not in pounc:
        text += "。" if lang == "zh" else "."

    utts: List[str] = []
    st = 0
    for i, c in enumerate(text):
        if c in pounc:
            if len(text[st:i]) > 0:
                utts.append(text[st:i] + c)
            if i + 1 < len(text) and text[i + 1] in ['"', "”"]:
                utts[-1] += text[i + 1]
                st = i + 2
            else:
                st = i + 1

    final: List[str] = []
    cur = ""
    for utt in utts:
        if length(cur + utt) > token_max_n and length(cur) > token_min_n:
            final.append(cur)
            cur = ""
        cur += utt
    if cur:
        if final and length(cur) < merge_len:
            final[-1] += cur
        else:
            final.append(cur)
    return final
