"""The port's copy of NLTK's word tokenizer (`utils/word_tokenize.py`)
against `nltk.tokenize.NLTKWordTokenizer().tokenize`, word for word, on ~200
fixed sentences (quotes of every kind, contractions, brackets, ellipses,
dashes, numbers with commas and points, URLs, e-mail, non-ASCII); and the
DPO repetition filter on rows where NLTK's split and a whitespace split give
different verdicts: the port must keep and drop exactly what the JAX filter
keeps and drops with nltk installed."""
import itertools

import numpy as np
import pytest

nltk_tokenize = pytest.importorskip("nltk.tokenize")

from slamkit_tpu.data import preference as jax_preference
from slamkit_tpu_torch.data import preference
from slamkit_tpu_torch.utils.calculation_utils import calc_auto_bleu
from slamkit_tpu_torch.utils.word_tokenize import NLTKWordTokenizer, word_tokenize

FIXED = [
    "Good muffins cost $3.88 (roughly 3,36 euros)\nin New York.  Please buy me\ntwo of them.\nThanks.",
    "They'll save and invest more.", "hi, my name can't hello,", "I cannot go; I won't.",
    "\"Hello,\" she said. 'Hi,' he replied.", "``Quoted'' text and ''more''.",
    "It's 5 o'clock... isn't it?", "Wait -- what?!", "The price: 1,000,000 dollars.",
    "See https://example.com/a?b=c&d=e for details.", "Mail me at someone@example.org!",
    "Café, naïve, coöperate — déjà vu.", "«Bonjour», dit-il. „Hallo“, sagte sie.",
    "‘Single’ and “double” curly quotes.", "Ellipsis…and more.... even more.....",
    "(Parentheses) [brackets] {braces} <angles>.", "A 3.14 value, 2,5 and 10:30 p.m.",
    "gonna wanna gotta gimme lemme 'tis 'twas d'ye more'n", "GONNA Cannot 'TIS",
    "He said: \"I'm done\".", "Rock 'n' roll isn't dead, y'all.", "U.S.A. and U.K. are here.",
    "50% off; #1 deal & @home $5.", "dash‒figure–en—em―bar", "**bold** and *em*",
    "ends with a quote.'", "ends with a quote.\"", "ends with a bracket.)", "...leading dots",
    "multiple   spaces\tand\ttabs\n\nnewlines", "", " ", "'", "\"", "''", "``", "a'b'c",
    "don't DON'T Don'T we're WE'RE I've I'VE you'd YOU'D she'll SHE'LL",
    "O'Neil's book", "'quoted start", "end quoted'", "price: $3,000, or 3.000,5",
    "日本語の文。中文句子，还有标点！", "Привет, мир! Как дела?", "مرحبا، بالعالم.",
    "emoji 😀 test, ok?", "x,y,z and 1,2,3", ":colon start", "end colon:", "comma,",
    "Mr. Smith went to Washington.", "e.g. this, i.e. that.", "3.", "a.", ".", "?!", "--",
]
WORDS = ["the", "cat", "it's", "can't", "I'm", "New York", "3,000", "4.5", "$12",
         "(note)", "[1]", "{x}", "<tag>", "\"quote\"", "'single'", "“curly”", "‘curl’",
         "«chev»", "...", "…", "--", "—", "http://a.b/c", "a@b.co", "naïve", "Zoë",
         "gonna", "cannot", "'tis", "wanna", "U.S.", "50%", "#tag", "&", ";", ":", ",", "!",
         "?", "*", "don't", "you'll", "they've", "she'd", "O'Brien", "``", "''"]


def _generated(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        words = [WORDS[i] for i in rng.integers(0, len(WORDS), int(rng.integers(1, 12)))]
        joins = [" " if rng.random() < 0.8 else "" for _ in words]
        s = "".join(w + j for w, j in zip(words, joins)).strip()
        out.append(s + ("" if rng.random() < 0.3 else rng.choice([".", "?", "!", ".\"", ".'"])))
    return out


SENTENCES = FIXED + _generated(200 - len(FIXED))


@pytest.mark.parametrize("chunk", range(4))
def test_word_tokenize_equals_nltk(chunk):
    ref, port = nltk_tokenize.NLTKWordTokenizer(), NLTKWordTokenizer()
    part = SENTENCES[chunk::4]
    assert len(part) == 50
    for s in part:
        assert port.tokenize(s) == ref.tokenize(s), repr(s)
        assert word_tokenize(s) == ref.tokenize(s)


def _pref_rows(n: int, seed: int = 0):
    """prompt_text / chosen_text pairs of fragments whose bigrams repeat or
    not depending on how punctuation and contractions split."""
    rng = np.random.default_rng(seed)
    frags = ["hi,", "hi", "you,", "you", "it's", "it", "'s", "fine.", "fine", "ok,", "ok",
             "well,", "well", "no.", "no", "can't", "ca", "n't", "so", "so,"]
    rows = []
    for _ in range(n):
        text = [frags[i] for i in rng.integers(0, len(frags), int(rng.integers(4, 10)))]
        cut = int(rng.integers(1, len(text)))
        rows.append({"prompt_text": " ".join(text[:cut]), "chosen_text": " ".join(text[cut:])})
    return rows


def test_repetition_filter_follows_nltk_where_the_splits_disagree(monkeypatch):
    """Rows whose keep-or-drop verdict under NLTK's words differs from a
    whitespace split's; on them (and on all rows) the port's filter, with
    nltk blocked as on the card's host, equals the JAX filter with nltk."""
    rows = _pref_rows(400)
    n, limit = 2, 0.3
    ws = jax_preference._WhitespaceTokenizer()
    nltk_tok = nltk_tokenize.NLTKWordTokenizer()
    text = lambda r: r["prompt_text"] + " " + r["chosen_text"]  # noqa: E731
    differ = [r for r in rows if (calc_auto_bleu(text(r), ws, n) < limit)
              != (calc_auto_bleu(text(r), nltk_tok, n) < limit)]
    assert len(differ) >= 20
    want = [jax_preference.get_repetition_filter_fn(n, limit)(r) for r in rows]
    monkeypatch.setitem(__import__("sys").modules, "nltk", None)
    monkeypatch.setitem(__import__("sys").modules, "nltk.tokenize", None)
    got = [preference.get_repetition_filter_fn(n, limit)(r) for r in rows]
    assert got == want
    fallback = [jax_preference.get_repetition_filter_fn(n, limit)(r) for r in differ]
    assert [preference.get_repetition_filter_fn(n, limit)(r) for r in differ] == [
        not f for f in fallback]


def test_sentences_cover_the_rule_groups():
    """The fixed set reaches every rule group of the tokenizer at least once."""
    joined = "".join(SENTENCES)
    for ch in ("«", "“", "‘", "„", "`", "»", "”", "’", "...", "…", "—", "(", "[", "{", "<",
               "--", "n't", "'ll", "gonna", "'tis", "$", "%", "#", "&", "@", ";", ":", ",",
               "?", "!", "*", "http", "1,000", "3.14"):
        assert ch in joined, ch
    assert len(set(itertools.chain.from_iterable(map(word_tokenize, SENTENCES)))) > 150
