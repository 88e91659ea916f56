"""NLTK's word tokenizer, without nltk.

A copy of `NLTKWordTokenizer.tokenize` from nltk 3.10.0
(`nltk/tokenize/destructive.py`, with the contraction lists of its
`MacIntyreContractions`), Copyright (C) 2001-2026 NLTK Project, Apache
License 2.0. The JAX package splits words with it for the DPO repetition
filter (`slamkit_tpu/data/preference.py::get_repetition_filter_fn`) and for
GenPPL's auto-BLEU (`slamkit_tpu/metric/generative_metric.py::asr_perplexity`).
The card's host has no nltk, and a whitespace split drops other rows, so the
port carries the rules themselves: a fixed sequence of regex substitutions,
then a split on whitespace. `tests/test_torch_word_tokenize.py` holds it to
`nltk.tokenize.NLTKWordTokenizer().tokenize`.
"""
from __future__ import annotations

import re
from typing import List

STARTING_QUOTES = [
    (re.compile("([«“‘„]|[`]+)", re.U), r" \1 "),
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
    (re.compile(r"(?i)(\')(?!re|ve|ll|m|t|s|d|n)(\w)\b", re.U), r"\1 \2"),
]

ENDING_QUOTES = [
    (re.compile("([»”’])", re.U), r" \1 "),
    (re.compile(r"''"), " '' "),
    (re.compile(r'"'), " '' "),
    (re.compile(r"\s+"), " "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]

PUNCTUATION = [
    (re.compile(r'([^\.])(\.)([\]\)}>"\'' "»”’ " r"]*)\s*$", re.U), r"\1 \2 \3 "),
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.{2,}", re.U), r" \g<0> "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    (re.compile(r"[‒-―]", re.UNICODE), r" \g<0> "),
    (re.compile(r'([^\.])(\.)([\]\)}>"\']*)\s*$'), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
    (re.compile(r"[*]", re.U), r" \g<0> "),
]

PARENS_BRACKETS = (re.compile(r"[\]\[\(\)\{\}\<\>]"), r" \g<0> ")
DOUBLE_DASHES = (re.compile(r"--"), r" -- ")

CONTRACTIONS2 = [re.compile(p) for p in (
    r"(?i)\b(can)(?#X)(not)\b",
    r"(?i)\b(d)(?#X)('ye)\b",
    r"(?i)\b(gim)(?#X)(me)\b",
    r"(?i)\b(gon)(?#X)(na)\b",
    r"(?i)\b(got)(?#X)(ta)\b",
    r"(?i)\b(lem)(?#X)(me)\b",
    r"(?i)\b(more)(?#X)('n)\b",
    r"(?i)\b(wan)(?#X)(na)(?=\s)",
)]
CONTRACTIONS3 = [re.compile(p) for p in (r"(?i) ('t)(?#X)(is)\b", r"(?i) ('t)(?#X)(was)\b")]


class NLTKWordTokenizer:
    """`tokenize(text)` -> words, as nltk's NLTKWordTokenizer (without its
    convert_parentheses option)."""

    def tokenize(self, text: str) -> List[str]:
        for regexp, substitution in STARTING_QUOTES:
            text = regexp.sub(substitution, text)
        for regexp, substitution in PUNCTUATION:
            text = regexp.sub(substitution, text)
        regexp, substitution = PARENS_BRACKETS
        text = regexp.sub(substitution, text)
        regexp, substitution = DOUBLE_DASHES
        text = regexp.sub(substitution, text)
        text = " " + text + " "
        for regexp, substitution in ENDING_QUOTES:
            text = regexp.sub(substitution, text)
        for regexp in CONTRACTIONS2:
            text = regexp.sub(r" \1 \2 ", text)
        for regexp in CONTRACTIONS3:
            text = regexp.sub(r" \1 \2 ", text)
        return text.split()


def word_tokenize(text: str) -> List[str]:
    return NLTKWordTokenizer().tokenize(text)
