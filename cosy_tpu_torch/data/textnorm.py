"""Production-grade text normalization (TN) for the TTS frontend.

The port's copy of the JAX package's ``data/textnorm.py`` (pure Python, no
tensor code); the port imports nothing of that package.

The reference delegates to ttsfrd or wetext + inflect
(cosyvoice/cli/frontend.py:160-188); neither is a dependency here, so this is
a self-contained rule engine covering the wetext subset actually reachable
from TTS input: dates, clock times, fractions, percentages, measure units,
currency, phone numbers (digit reading with 幺), ranges, decimals and
negatives for Chinese; ordinals, decimals, percentages, currency, times and
inflect-style number words for English.

Rules are ordered: structured patterns (dates, times, phones …) consume
their digits first, then the plain-number pass verbalizes whatever is left.
"""

from __future__ import annotations

import re

from .text import en_number_to_words, zh_number_to_words, _ZH_DIGITS, _EN_ONES

# ---------------------------------------------------------------------------
# Chinese
# ---------------------------------------------------------------------------

# digit-by-digit reading, 1 -> 幺 (telephone convention)
_ZH_TEL_DIGITS = "零幺二三四五六七八九"


def _zh_digits(s: str, tel: bool = False) -> str:
    table = _ZH_TEL_DIGITS if tel else _ZH_DIGITS
    return "".join(table[int(c)] for c in s if c.isdigit())


def _zh_num(s: str) -> str:
    """Integer or decimal -> Chinese reading."""
    neg = s.startswith("-")
    s = s.lstrip("-")
    if "." in s:
        intp, frac = s.split(".", 1)
        out = zh_number_to_words(int(intp or 0)) + "点" + _zh_digits(frac)
    else:
        out = zh_number_to_words(int(s))
    return ("负" if neg else "") + out


# measure units (wetext zh measure grammar subset); longest-match first
_ZH_UNITS_TABLE = [
    ("km/h", "公里每小时"), ("m/s", "米每秒"),
    ("kwh", "千瓦时"), ("kw", "千瓦"),
    ("mm", "毫米"), ("cm", "厘米"), ("km", "公里"),
    ("kg", "千克"), ("mg", "毫克"),
    ("ml", "毫升"), ("ghz", "吉赫兹"), ("mhz", "兆赫兹"), ("hz", "赫兹"),
    ("gb", "吉字节"), ("mb", "兆字节"), ("kb", "千字节"),
    ("°c", "摄氏度"), ("℃", "摄氏度"),
    ("%", None),  # handled by the percent rule, kept here to stop unit regex
]
_ZH_UNIT_RE = re.compile(
    r"(-?\d+(?:\.\d+)?)\s*(km/h|m/s|kwh|kw|mm|cm|km|kg|mg|ml|ghz|mhz|hz|gb|mb|kb|°C|℃|°c)",
    re.IGNORECASE)

# 2 reads 两 before a classifier (wetext convention)
_ZH_CLASSIFIERS = "个只条本位名张次件间辆瓶杯台部颗座扇枚页分钟"


def normalize_zh(text: str) -> str:
    # dates: 2024年5月1日 -> 二零二四年五月一日 (year digit-by-digit)
    text = re.sub(
        r"(\d{2,4})年(\d{1,2})月(\d{1,2})[日号]",
        lambda m: (_zh_digits(m.group(1)) + "年" + zh_number_to_words(int(m.group(2)))
                   + "月" + zh_number_to_words(int(m.group(3))) + "日"),
        text)
    text = re.sub(r"(\d{2,4})年",
                  lambda m: _zh_digits(m.group(1)) + "年", text)
    text = re.sub(
        r"(\d{1,2})月(\d{1,2})[日号]",
        lambda m: (zh_number_to_words(int(m.group(1))) + "月"
                   + zh_number_to_words(int(m.group(2))) + "日"),
        text)
    # ISO dates 2023-05-12 / 2023/5/12: must run BEFORE the range rule, or
    # '2023-05' reads as a range and '-12' as a negative number
    text = re.sub(
        r"(?<!\d)(\d{4})[-/.](\d{1,2})[-/.](\d{1,2})(?!\d)",
        lambda m: (_zh_digits(m.group(1)) + "年" + zh_number_to_words(int(m.group(2)))
                   + "月" + zh_number_to_words(int(m.group(3))) + "日"),
        text)

    # clock time: 8:05 -> 八点零五分, 17:30:20 -> 十七点三十分二十秒
    def _time(m):
        h, mi, se = m.group(1), m.group(2), m.group(3)
        out = zh_number_to_words(int(h)) + "点"
        out += ("零" if mi[0] == "0" and int(mi) > 0 else "") + \
            zh_number_to_words(int(mi)) + "分" if int(mi) else "整"
        if se:
            out += zh_number_to_words(int(se)) + "秒"
        return out
    text = re.sub(r"(\d{1,2}):(\d{2})(?::(\d{2}))?(?!\d)", _time, text)

    # phone numbers: 11-digit mobile / 3-4 digit area code with hyphen ->
    # digit-by-digit with 幺
    text = re.sub(r"(?<!\d)(1[3-9]\d{9})(?!\d)",
                  lambda m: _zh_digits(m.group(1), tel=True), text)
    text = re.sub(r"(?<!\d)(\d{3,4})-(\d{7,8})(?!\d)",
                  lambda m: _zh_digits(m.group(1), tel=True) +
                  _zh_digits(m.group(2), tel=True), text)

    # percent / fraction: 3.5% -> 百分之三点五, 3/4 -> 四分之三
    text = re.sub(r"(-?\d+(?:\.\d+)?)[%％]",
                  lambda m: "百分之" + _zh_num(m.group(1)), text)
    text = re.sub(r"(?<![\d.])(\d+)/(\d+)(?![\d.])",
                  lambda m: _zh_num(m.group(2)) + "分之" + _zh_num(m.group(1)),
                  text)

    # measure units: 5kg -> 五千克, 25℃ -> 二十五摄氏度
    def _unit(m):
        unit = m.group(2).lower()
        for pat, word in _ZH_UNITS_TABLE:
            if unit == pat and word:
                return _zh_num(m.group(1)) + word
        return m.group(0)
    text = _ZH_UNIT_RE.sub(_unit, text)

    # currency: 9.9元 handled by plain numbers; $5 / 5美元 -> 五美元
    text = re.sub(r"[$＄](\d+(?:\.\d+)?)",
                  lambda m: _zh_num(m.group(1)) + "美元", text)
    text = re.sub(r"[¥￥](\d+(?:\.\d+)?)",
                  lambda m: _zh_num(m.group(1)) + "元", text)

    # ranges: 5-10个 -> 五到十个 (only between small plain numbers)
    text = re.sub(r"(?<!\d)(\d{1,4})[-~—](\d{1,4})(?![-~—\d])",
                  lambda m: _zh_num(m.group(1)) + "到" + _zh_num(m.group(2)),
                  text)

    # 2 + classifier -> 两
    text = re.sub(r"(?<!\d)2([" + _ZH_CLASSIFIERS + r"])", r"两\1", text)

    # remaining plain numbers (incl. decimals and signs)
    text = re.sub(r"-?\d+(?:\.\d+)?", lambda m: _zh_num(m.group(0)), text)
    return text


# ---------------------------------------------------------------------------
# English
# ---------------------------------------------------------------------------

_EN_ORD_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def en_ordinal_words(n: int) -> str:
    words = en_number_to_words(n)
    head, _, last = words.rpartition(" ")
    if "-" in last:
        tens, _, unit = last.rpartition("-")
        last = tens + "-" + _EN_ORD_IRREGULAR.get(unit, unit + "th")
    elif last in _EN_ORD_IRREGULAR:
        last = _EN_ORD_IRREGULAR[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    return (head + " " + last) if head else last


def _en_num(s: str) -> str:
    neg = s.startswith("-")
    s = s.lstrip("-")
    if "." in s:
        intp, frac = s.split(".", 1)
        out = (en_number_to_words(int(intp)) if intp else "zero") + \
            " point " + " ".join(_EN_ONES[int(d)] for d in frac)
    else:
        out = en_number_to_words(int(s))
    return ("minus " if neg else "") + out


def normalize_en(text: str) -> str:
    # ordinals: 21st -> twenty-first
    text = re.sub(r"(?<!\d)(\d+)(?:st|nd|rd|th)\b",
                  lambda m: en_ordinal_words(int(m.group(1))), text)

    # currency: $5.50 -> five dollars fifty cents, $5 -> five dollars
    def _cur(m):
        whole, cents = m.group(1), m.group(2)
        out = en_number_to_words(int(whole)) + \
            (" dollar" if int(whole) == 1 else " dollars")
        if cents and int(cents):
            out += " " + en_number_to_words(int(cents)) + \
                (" cent" if int(cents) == 1 else " cents")
        return out
    text = re.sub(r"[$＄](\d+)(?:\.(\d{2}))?", _cur, text)

    # percent: 3.5% -> three point five percent
    text = re.sub(r"(-?\d+(?:\.\d+)?)[%％]",
                  lambda m: _en_num(m.group(1)) + " percent", text)

    # clock time: 5:30 -> five thirty, 5:05 -> five oh five, 5:00 -> five o'clock
    def _time(m):
        h, mi = int(m.group(1)), m.group(2)
        out = en_number_to_words(h)
        if int(mi) == 0:
            return out + " o'clock"
        if mi[0] == "0":
            return out + " oh " + en_number_to_words(int(mi))
        return out + " " + en_number_to_words(int(mi))
    text = re.sub(r"(?<!\d)(\d{1,2}):(\d{2})(?!\d)", _time, text)

    # remaining plain numbers
    text = re.sub(r"-?\d+(?:\.\d+)?", lambda m: _en_num(m.group(0)), text)
    return text
