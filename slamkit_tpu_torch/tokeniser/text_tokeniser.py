"""A text tokeniser read from a local HF `tokenizer.json`, or from a GPT-2
`vocab.json` + `merges.txt` pair, without transformers.

The interleaving tokeniser of the JAX package wraps
`transformers.AutoTokenizer.from_pretrained(text_tokeniser_path)`
(`slamkit_tpu/tokeniser/interleaving_tokeniser.py:116-125`). The card's host
has neither transformers nor tokenizers, so the port reads the directory's
`tokenizer.json` (plus `tokenizer_config.json` and `special_tokens_map.json`
where present) itself. A directory without `tokenizer.json` but with
`vocab.json` and `merges.txt` (a GPT-2 slow tokenizer, as `facebook/opt-125m`,
the shipped default of config/tokeniser/interleaved_hubert_25.yaml, ships)
is converted as transformers' `GPT2Converter` converts it (`_gpt2_spec`), and
then read as that tokenizer.json would be. Either way it gives exactly the
surface the interleaving tokeniser uses: `add_tokens`,
`convert_tokens_to_ids`, `len`, the pad / bos /
eos ids, `__call__` over a list of strings (right or left pads,
`return_tensors="np"`), `decode` and `batch_decode`; the generative metrics
read Whisper's and the text LM's tokenizers with it too.

Encoding follows the tokenizers library's pipeline: added tokens are split out
first (those with `normalized: false` on the raw text, then the others on the
normalized text, leftmost-longest), the remaining pieces are normalized,
pre-tokenized and run through the model, and the post-processor adds the
special tokens. What it reads:
  * normalizers: NFC, NFD, NFKC, NFKD, Lowercase, Sequence;
  * pre-tokenizers: Whitespace, WhitespaceSplit, ByteLevel (with or without
    the GPT-2 regex, `add_prefix_space`), Split (Isolated, Removed), Sequence;
  * models: WordLevel, BPE (merges as "a b" strings or pairs, `ignore_merges`,
    `unk_token`);
  * post-processors: TemplateProcessing, ByteLevel, Sequence;
  * decoders: ByteLevel, or none (tokens joined by spaces), and
    `clean_up_tokenization_spaces`.
Anything else raises, naming the component. The regexes' `\\p{L}`, `\\p{N}`,
`\\w` and `\\s` become explicit classes of Unicode's definitions built from
`unicodedata` (Python's own `\\w` and `\\s` differ from them).
`tests/test_torch_text_tokeniser.py` holds ids, masks, lengths and decodes
equal to transformers on four kinds of tokenizer.
"""
from __future__ import annotations

import functools
import json
import os
import re
import sys
import unicodedata
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

#: model_input_names of transformers' generic fast tokenizer; the named
#: classes below return no token_type_ids
_DEFAULT_INPUT_NAMES = ("input_ids", "token_type_ids", "attention_mask")
_NO_TYPE_IDS_CLASSES = ("GPT2Tokenizer", "GPT2TokenizerFast", "GPTNeoXTokenizer",
                        "GPTNeoXTokenizerFast", "Qwen2Tokenizer", "Qwen2TokenizerFast",
                        "LlamaTokenizer", "LlamaTokenizerFast")

#: the GPT-2 pre-tokenizer regex of the ByteLevel pre-tokenizer
_GPT2_PATTERN = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""


@functools.lru_cache(maxsize=None)
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@functools.lru_cache(maxsize=None)
def _unicode_to_bytes() -> Dict[str, int]:
    return {c: b for b, c in _bytes_to_unicode().items()}


#: Unicode White_Space, the tokenizers library's `\s` (Python's `\s` also
#: takes U+001C-U+001F)
_WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0), (0x1680, 0x1680),
                (0x2000, 0x200A), (0x2028, 0x2029), (0x202F, 0x202F), (0x205F, 0x205F),
                (0x3000, 0x3000))
#: Other_Alphabetic code points outside the marks (circled and squared Latin
#: letters), which Unicode's word class takes
_OTHER_ALPHABETIC = ((0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169),
                     (0x1F170, 0x1F189))


def _is_word(cp: int) -> bool:
    """Unicode's `\\w` as the tokenizers library's regexes read it: letters,
    marks, decimal digits, letter numbers, connector punctuation and the
    joiners (Python's `\\w` takes every number, and no mark or joiner)."""
    cat = unicodedata.category(chr(cp))
    return (cat[0] in "LM" or cat in ("Nd", "Nl", "Pc") or cp in (0x200C, 0x200D)
            or any(lo <= cp <= hi for lo, hi in _OTHER_ALPHABETIC))


@functools.lru_cache(maxsize=None)
def _class_body(name: str) -> str:
    """The body of a regex character class for `\\p{L}`, `\\p{N}`, `\\w` or
    `\\s` as the tokenizers library's regexes read them."""
    if name == "s":
        spans = _WHITE_SPACE
    else:
        test = {"L": lambda cp: unicodedata.category(chr(cp))[0] == "L",
                "N": lambda cp: unicodedata.category(chr(cp))[0] == "N", "w": _is_word}[name]
        spans, start = [], None
        for cp in range(sys.maxunicode + 2):
            inside = cp <= sys.maxunicode and test(cp)
            if inside and start is None:
                start = cp
            elif not inside and start is not None:
                spans.append((start, cp - 1))
                start = None
    return "".join(f"\\U{lo:08x}" if lo == hi else f"\\U{lo:08x}-\\U{hi:08x}"
                   for lo, hi in spans)


def _compile(pattern: str) -> "re.Pattern":
    """A pattern of the tokenizers library (Oniguruma syntax) as a Python
    regex: `\\p{L}`, `\\p{N}`, `\\w` and `\\s` (and their negations) become
    explicit classes of Unicode's definitions."""
    out, in_class, i = [], False, 0
    while i < len(pattern):
        c, name, negate, end = pattern[i], None, False, i + 2
        if c == "\\" and pattern[i + 1:i + 3] in ("p{", "P{"):
            end = pattern.index("}", i) + 1
            name, negate = pattern[i + 3:end - 1], pattern[i + 1] == "P"
            if name not in ("L", "N"):
                raise NotImplementedError(f"regex class \\p{{{name}}} in {pattern!r}")
        elif c == "\\" and pattern[i + 1:i + 2] in ("w", "W", "s", "S"):
            name, negate = pattern[i + 1].lower(), pattern[i + 1].isupper()
        if name is not None:
            body = _class_body(name)
            if in_class and negate:
                raise NotImplementedError(f"a negated class inside a class in {pattern!r}")
            out.append(body if in_class else f"[{'^' if negate else ''}{body}]")
            i = end
            continue
        if c == "\\":
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
        elif c == "]" and in_class:
            in_class = False
        out.append(c)
        i += 1
    return re.compile("".join(out))


def _trie_pattern(words: Sequence[str]) -> str:
    """A regex matching any of `words`, the longest where several match at
    one place (children are tried before a word ends)."""
    trie: dict = {}
    for w in words:
        node = trie
        for ch in w:
            node = node.setdefault(ch, {})
        node[""] = True

    def emit(node) -> str:
        alts = [re.escape(ch) + emit(child) for ch, child in sorted(node.items()) if ch]
        if "" in node:
            alts.append("")
        if len(alts) == 1:
            return alts[0]
        return "(?:" + "|".join(alts) + ")"

    return emit(trie)


# --------------------------------------------------------------------------- #
# normalizers
# --------------------------------------------------------------------------- #
def _normalizer(spec: Optional[dict]):
    if spec is None:
        return lambda s: s
    kind = spec["type"]
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda s: unicodedata.normalize(kind, s)
    if kind == "Lowercase":
        return str.lower
    if kind == "Sequence":
        steps = [_normalizer(n) for n in spec["normalizers"]]
        return functools.reduce(lambda f, g: (lambda s: g(f(s))), steps, lambda s: s)
    raise NotImplementedError(f"tokenizer.json normalizer {kind!r}")


# --------------------------------------------------------------------------- #
# pre-tokenizers: str -> list of pieces
# --------------------------------------------------------------------------- #
def _split(text: str, regex: "re.Pattern", removed: bool) -> List[str]:
    """The matches of `regex` and the text between them, in order (the
    matches dropped when `removed`)."""
    pieces, last = [], 0
    for m in regex.finditer(text):
        if m.end() == m.start():
            continue
        if m.start() > last:
            pieces.append(text[last:m.start()])
        if not removed:
            pieces.append(m.group())
        last = m.end()
    if last < len(text):
        pieces.append(text[last:])
    return pieces


def _pre_tokenizer(spec: Optional[dict]):
    if spec is None:
        return lambda s: [s] if s else []
    kind = spec["type"]
    if kind == "Whitespace":
        return _compile(r"\w+|[^\w\s]+").findall
    if kind == "WhitespaceSplit":
        return str.split
    if kind == "ByteLevel":
        table = _bytes_to_unicode()
        regex = _compile(_GPT2_PATTERN) if spec.get("use_regex", True) else None
        prefix = bool(spec.get("add_prefix_space", False))

        def byte_level(s: str) -> List[str]:
            if prefix and not s.startswith(" "):
                s = " " + s
            pieces = [m for m in regex.findall(s) if m] if regex is not None else [s]
            return ["".join(table[b] for b in p.encode("utf-8")) for p in pieces if p]

        return byte_level
    if kind == "Split":
        if spec.get("invert", False):
            raise NotImplementedError("tokenizer.json Split with invert: true")
        pattern = spec["pattern"]
        regex = (_compile(pattern["Regex"]) if "Regex" in pattern
                 else re.compile(re.escape(pattern["String"])))
        if spec["behavior"] not in ("Isolated", "Removed"):
            raise NotImplementedError(f"tokenizer.json Split behavior {spec['behavior']!r}")
        return lambda s: _split(s, regex, spec["behavior"] == "Removed")
    if kind == "Sequence":
        steps = [_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def sequence(s: str) -> List[str]:
            pieces = [s]
            for step in steps:
                pieces = [q for p in pieces for q in step(p)]
            return pieces

        return sequence
    raise NotImplementedError(f"tokenizer.json pre_tokenizer {kind!r}")


# --------------------------------------------------------------------------- #
# models: pre-token -> ids
# --------------------------------------------------------------------------- #
class _WordLevel:
    def __init__(self, spec: dict):
        self.vocab: Dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token")

    def __call__(self, word: str) -> List[int]:
        if word in self.vocab:
            return [self.vocab[word]]
        if self.unk is None or self.unk not in self.vocab:
            raise ValueError(f"WordLevel: {word!r} is not in the vocabulary and there is no "
                             f"unk_token")
        return [self.vocab[self.unk]]


class _BPE:
    def __init__(self, spec: dict):
        for key in ("continuing_subword_prefix", "end_of_word_suffix", "dropout", "fuse_unk",
                    "byte_fallback"):
            if spec.get(key):
                raise NotImplementedError(f"tokenizer.json BPE with {key}={spec[key]!r}")
        self.vocab: Dict[str, int] = spec["vocab"]
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                  for m in spec.get("merges", [])]
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.unk = spec.get("unk_token")
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.cache: Dict[str, List[int]] = {}

    def _symbols(self, word: str) -> List[Optional[str]]:
        """The word's characters; None (unk) for one the vocabulary lacks,
        which is dropped where there is no unk_token."""
        return [ch if ch in self.vocab else None for ch in word
                if ch in self.vocab or self.unk is not None]

    def __call__(self, word: str) -> List[int]:
        hit = self.cache.get(word)
        if hit is not None:
            return hit
        if self.ignore_merges and word in self.vocab:
            ids = [self.vocab[word]]
        else:
            syms = self._symbols(word)
            while len(syms) > 1:
                best, best_rank = None, None
                for a, b in zip(syms, syms[1:]):
                    r = self.ranks.get((a, b)) if a is not None and b is not None else None
                    if r is not None and (best_rank is None or r < best_rank):
                        best, best_rank = (a, b), r
                if best is None:
                    break
                merged, i = [], 0
                while i < len(syms):
                    if i + 1 < len(syms) and (syms[i], syms[i + 1]) == best:
                        merged.append(best[0] + best[1])
                        i += 2
                    else:
                        merged.append(syms[i])
                        i += 1
                syms = merged
            ids = [self.vocab[self.unk] if s is None else self.vocab[s] for s in syms]
        self.cache[word] = ids
        return ids


def _model(spec: dict):
    kind = spec.get("type") or ("BPE" if "merges" in spec else "WordLevel")
    if kind == "WordLevel":
        return _WordLevel(spec)
    if kind == "BPE":
        return _BPE(spec)
    raise NotImplementedError(f"tokenizer.json model {kind!r}")


# --------------------------------------------------------------------------- #
# post-processors: ids -> ids with the special tokens
# --------------------------------------------------------------------------- #
def _post_processor(spec: Optional[dict]):
    if spec is None:
        return lambda ids: ids
    kind = spec["type"]
    if kind == "ByteLevel":
        return lambda ids: ids
    if kind == "TemplateProcessing":
        special = {k: list(v["ids"]) for k, v in spec.get("special_tokens", {}).items()}
        items = []
        for piece in spec["single"]:
            if "SpecialToken" in piece:
                items.append(special[piece["SpecialToken"]["id"]])
            else:
                items.append(None)

        def template(ids):
            out = []
            for it in items:
                out.extend(ids if it is None else it)
            return out

        return template
    if kind == "Sequence":
        steps = [_post_processor(p) for p in spec["processors"]]
        return functools.reduce(lambda f, g: (lambda ids: g(f(ids))), steps, lambda ids: ids)
    raise NotImplementedError(f"tokenizer.json post_processor {kind!r}")


def _decoder(spec: Optional[dict]):
    if spec is None:
        return " ".join
    kind = spec["type"]
    if kind == "ByteLevel":
        table = _unicode_to_bytes()

        def byte_level(tokens: List[str]) -> str:
            out = bytearray()
            for t in tokens:
                if all(c in table for c in t):
                    out.extend(table[c] for c in t)
                else:
                    out.extend(t.encode("utf-8"))
            return out.decode("utf-8", errors="replace")

        return byte_level
    raise NotImplementedError(f"tokenizer.json decoder {kind!r}")


def clean_up_tokenization(text: str) -> str:
    """transformers' clean_up_tokenization: spaces before punctuation and
    English contractions removed."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                 (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
                 (" 're", "'re")):
        text = text.replace(a, b)
    return text


def _token_content(value) -> Optional[str]:
    if isinstance(value, dict):
        return value.get("content")
    return value


#: GPT2Tokenizer's special-token attributes, in the order transformers adds
#: the ones missing from the vocabulary (ids after it, in this order)
_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token",
                 "cls_token", "mask_token")
#: GPT2Tokenizer's defaults for the tokens its config leaves out
_GPT2_DEFAULTS = {"bos_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
                  "unk_token": "<|endoftext|>", "tokenizer_class": "GPT2Tokenizer"}


def _gpt2_spec(folder: str, config: dict) -> dict:
    """The tokenizer.json that transformers builds from a GPT-2 slow
    tokenizer's files (`GPT2Tokenizer` read by `GPT2Converter`): a byte-level
    BPE over vocab.json with merges.txt's merges in file order (its first
    line, the `#version` header, and its last, empty after the final
    newline, dropped as `GPT2Tokenizer` drops them), no unk token; the
    ByteLevel pre-tokenizer with the GPT-2 regex and the config's
    `add_prefix_space`; the ByteLevel decoder; a post-processor prepending
    the bos token when `add_bos_token` is true, else ByteLevel's. Added
    tokens, in transformers' order: added_tokens.json's (non-special), then
    the special tokens (those of `_SPECIAL_KEYS`, then
    `additional_special_tokens`) where not yet added, each at its vocabulary
    id or else at the next id. A special token given as a string is
    normalized unless it is an additional one; one given as a dict keeps its
    own flags. Fills `config` with GPT2Tokenizer's defaults for what it
    leaves out."""
    for k, v in _GPT2_DEFAULTS.items():
        config.setdefault(k, v)
    with open(os.path.join(folder, "vocab.json"), encoding="utf-8") as f:
        vocab: Dict[str, int] = json.load(f)
    with open(os.path.join(folder, "merges.txt"), encoding="utf-8") as f:
        lines = f.read().split("\n")[1:-1]
    merges = [m.split() for m in lines if m.split()]
    added: Dict[str, dict] = {}
    next_id = max(vocab.values(), default=-1) + 1

    def add(content: str, special: bool, normalized: bool, token_id: Optional[int] = None,
            flags: Optional[dict] = None):
        nonlocal next_id
        if content in added:
            return
        if token_id is None:
            token_id = vocab.get(content, next_id)
        next_id = max(next_id, token_id + 1)
        entry = {"id": int(token_id), "content": content, "single_word": False,
                 "lstrip": False, "rstrip": False, "normalized": normalized,
                 "special": special}
        entry.update({k: v for k, v in (flags or {}).items() if k in entry and k != "id"})
        added[content] = entry

    added_json = os.path.join(folder, "added_tokens.json")
    if os.path.isfile(added_json):
        with open(added_json, encoding="utf-8") as f:
            for content, token_id in sorted(json.load(f).items(), key=lambda kv: kv[1]):
                add(content, False, True, token_id)
    specials = [(config.get(k), True) for k in _SPECIAL_KEYS]
    specials += [(t, False) for t in config.get("additional_special_tokens", [])]
    for tok, named in specials:
        if tok is None:
            continue
        if isinstance(tok, dict):
            add(tok["content"], True, bool(tok.get("normalized", named)), flags=tok)
        else:
            add(tok, True, named)
    bos = _token_content(config["bos_token"])
    if config.get("add_bos_token", False):
        post = {"type": "TemplateProcessing",
                "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                           {"Sequence": {"id": "A", "type_id": 0}}],
                "special_tokens": {bos: {"id": bos, "ids": [added[bos]["id"]],
                                         "tokens": [bos]}}}
    else:
        post = {"type": "ByteLevel", "trim_offsets": False}
    return {"added_tokens": sorted(added.values(), key=lambda a: a["id"]),
            "normalizer": None,
            "pre_tokenizer": {"type": "ByteLevel",
                              "add_prefix_space": bool(config.get("add_prefix_space", False)),
                              "use_regex": True},
            "post_processor": post, "decoder": {"type": "ByteLevel"},
            "model": {"type": "BPE", "vocab": vocab, "merges": merges, "unk_token": None}}


class TextTokeniser:
    """A tokenizer.json with the part of the transformers tokenizer surface
    the interleaving tokeniser uses."""

    def __init__(self, spec: dict, config: Optional[dict] = None):
        config = dict(config or {})
        self._normalize = _normalizer(spec.get("normalizer"))
        self._pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self._model = _model(spec["model"])
        self._post_process = _post_processor(spec.get("post_processor"))
        self._decode = _decoder(spec.get("decoder"))
        self._id_to_model_token = {i: t for t, i in self._model.vocab.items()}
        # added tokens: content -> (id, special, normalized)
        self._added: Dict[str, tuple] = {}
        for tok in spec.get("added_tokens", []):
            for key in ("single_word", "lstrip", "rstrip"):
                if tok.get(key):
                    raise NotImplementedError(f"added token {tok['content']!r} with {key}")
            self._added[tok["content"]] = (int(tok["id"]), bool(tok.get("special")),
                                           bool(tok.get("normalized", not tok.get("special"))))
        self._refresh_added()
        self.padding_side = config.get("padding_side", "right")
        self.clean_up_tokenization_spaces = bool(config.get("clean_up_tokenization_spaces",
                                                            False))
        names = config.get("model_input_names")
        if names is None:
            names = (("input_ids", "attention_mask")
                     if config.get("tokenizer_class") in _NO_TYPE_IDS_CLASSES
                     else _DEFAULT_INPUT_NAMES)
        self.model_input_names = list(names)
        self._special_tokens = {k: _token_content(config.get(k)) for k in
                                ("bos_token", "eos_token", "pad_token", "unk_token")}

    @classmethod
    def from_pretrained(cls, path: str) -> "TextTokeniser":
        """Read a local directory (or a tokenizer.json file): its
        tokenizer.json, or else its GPT-2 vocab.json + merges.txt."""
        tok_file = path if os.path.isfile(path) else os.path.join(path, "tokenizer.json")
        folder = os.path.dirname(tok_file)
        config: dict = {}
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            p = os.path.join(folder, name)
            if os.path.isfile(p):
                with open(p, encoding="utf-8") as f:
                    config.update({k: v for k, v in json.load(f).items() if v is not None})
        if os.path.isfile(tok_file):
            with open(tok_file, encoding="utf-8") as f:
                spec = json.load(f)
        elif all(os.path.isfile(os.path.join(folder, n)) for n in ("vocab.json", "merges.txt")):
            spec = _gpt2_spec(folder, config)
        else:
            raise FileNotFoundError(
                f"no tokenizer.json, and no vocab.json + merges.txt, at {path!r}: the text "
                f"tokeniser is read from a local directory holding tokenizer.json or a GPT-2 "
                f"vocab.json and merges.txt (nothing is downloaded)")
        return cls(spec, config)

    # -- vocabulary ---------------------------------------------------------------
    def _refresh_added(self):
        self._added_by_id = {i: t for t, (i, _, _) in self._added.items()}
        raw = [t for t, (_, _, norm) in self._added.items() if not norm]
        normed = [t for t, (_, _, norm) in self._added.items() if norm]
        self._raw_split = re.compile(_trie_pattern(raw)) if raw else None
        self._norm_split = re.compile(_trie_pattern(normed)) if normed else None

    def __len__(self) -> int:
        return len(set(self._model.vocab) | set(self._added))

    def add_tokens(self, tokens: Sequence[str]) -> int:
        """Add non-special tokens (matched on the normalized text), as
        transformers' `add_tokens` does; returns how many were new."""
        n_model = len(self._model.vocab)
        added = 0
        for t in tokens:
            if t in self._added or t in self._model.vocab:
                continue
            top = max((i for i, _, _ in self._added.values()), default=None)
            new_id = n_model if top is None or top < n_model else top + 1
            self._added[t] = (new_id, False, True)
            added += 1
        self._refresh_added()
        return added

    def _token_to_id(self, token: str) -> Optional[int]:
        if token in self._added:
            return self._added[token][0]
        return self._model.vocab.get(token)

    def convert_tokens_to_ids(self, tokens: Union[str, Sequence[str]]):
        if isinstance(tokens, str):
            i = self._token_to_id(tokens)
            return self.unk_token_id if i is None else i
        return [self.convert_tokens_to_ids(t) for t in tokens]

    def convert_ids_to_tokens(self, ids):
        if isinstance(ids, (int, np.integer)):
            return self._added_by_id.get(int(ids), self._id_to_model_token.get(int(ids)))
        return [self.convert_ids_to_tokens(i) for i in ids]

    def _special_id(self, key: str) -> Optional[int]:
        token = self._special_tokens.get(key)
        return None if token is None else self._token_to_id(token)

    @property
    def unk_token_id(self) -> Optional[int]:
        return self._special_id("unk_token")

    @property
    def bos_token_id(self) -> Optional[int]:
        return self._special_id("bos_token")

    @property
    def eos_token_id(self) -> Optional[int]:
        return self._special_id("eos_token")

    @property
    def pad_token_id(self) -> Optional[int]:
        return self._special_id("pad_token")

    @pad_token_id.setter
    def pad_token_id(self, value: int):
        self._special_tokens["pad_token"] = self.convert_ids_to_tokens(int(value))

    # -- encoding ---------------------------------------------------------------
    @staticmethod
    def _split_on(pieces: List[tuple], regex) -> List[tuple]:
        """(text, is_added) pieces with `regex`'s matches split out."""
        if regex is None:
            return pieces
        out = []
        for text, is_added in pieces:
            if is_added:
                out.append((text, True))
                continue
            last = 0
            for m in regex.finditer(text):
                if m.start() > last:
                    out.append((text[last:m.start()], False))
                out.append((m.group(), True))
                last = m.end()
            if last < len(text):
                out.append((text[last:], False))
        return out

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        pieces = self._split_on([(text, False)], self._raw_split)
        pieces = [(p if added else self._normalize(p), added) for p, added in pieces]
        pieces = self._split_on(pieces, self._norm_split)
        ids: List[int] = []
        for p, added in pieces:
            if added:
                ids.append(self._added[p][0])
                continue
            for word in self._pre_tokenize(p):
                ids.extend(self._model(word))
        return self._post_process(ids) if add_special_tokens else ids

    def __call__(self, text: Union[str, Sequence[str]], add_special_tokens: bool = True,
                 padding: Union[bool, str] = False, return_tensors: Optional[str] = None,
                 padding_side: Optional[str] = None, **kwargs) -> dict:
        if kwargs.get("truncation") or kwargs.get("max_length") is not None:
            raise NotImplementedError("TextTokeniser: truncation is not supported")
        single = isinstance(text, str)
        seqs = [self.encode(t, add_special_tokens) for t in ([text] if single else text)]
        masks = [[1] * len(s) for s in seqs]
        if padding == "max_length":
            raise NotImplementedError("TextTokeniser: padding='max_length'")
        if padding in (True, "longest"):
            side = padding_side or self.padding_side
            width = max((len(s) for s in seqs), default=0)
            pad = self.pad_token_id
            if pad is None and any(len(s) < width for s in seqs):
                raise ValueError("padding needs a pad token")
            for s, m in zip(seqs, masks):
                fill = width - len(s)
                if side == "right":
                    s.extend([pad] * fill)
                    m.extend([0] * fill)
                else:
                    s[:0] = [pad] * fill
                    m[:0] = [0] * fill
        out = {"input_ids": seqs}
        if "token_type_ids" in self.model_input_names:
            out["token_type_ids"] = [[0] * len(s) for s in seqs]
        out["attention_mask"] = masks
        if return_tensors == "np":
            return {k: np.asarray(v, dtype=np.int64) for k, v in out.items()}
        if return_tensors is not None:
            raise NotImplementedError(f"return_tensors={return_tensors!r} (only 'np')")
        if single:
            out = {k: v[0] for k, v in out.items()}
        return out

    # -- decoding ---------------------------------------------------------------
    def decode(self, ids, skip_special_tokens: bool = False,
               clean_up_tokenization_spaces: Optional[bool] = None) -> str:
        ids = np.asarray(ids).reshape(-1).tolist() if not isinstance(ids, list) else ids
        tokens = []
        for i in ids:
            i = int(i)
            tok = self._added_by_id.get(i)
            if tok is not None:
                if skip_special_tokens and self._added[tok][1]:
                    continue
            else:
                tok = self._id_to_model_token.get(i)
                if tok is None:
                    continue
            tokens.append(tok)
        text = self._decode(tokens)
        clean = (self.clean_up_tokenization_spaces if clean_up_tokenization_spaces is None
                 else clean_up_tokenization_spaces)
        return clean_up_tokenization(text) if clean else text

    def batch_decode(self, sequences, skip_special_tokens: bool = False,
                     clean_up_tokenization_spaces: Optional[bool] = None) -> List[str]:
        """`decode` of each row of `sequences`."""
        return [self.decode(s, skip_special_tokens, clean_up_tokenization_spaces)
                for s in sequences]
