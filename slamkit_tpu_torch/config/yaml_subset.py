"""A reader for the YAML subset of the `config/` tree, without PyYAML.

The JAX composer reads its YAML with PyYAML (`slamkit_tpu/config/compose.py:27`),
which the card's host does not have. This reader gives the same values as
PyYAML's safe loader with the composer's one change (an unquoted `1e-3` is a
float, as OmegaConf reads it; quoted it stays a string) for the subset the
tree and the command-line override values use:

  * block mappings and block sequences (a sequence may sit at its key's
    indentation), with `- key: value` entries;
  * full-line and trailing `#` comments;
  * plain scalars, single-quoted scalars, and double-quoted scalars with
    YAML's escapes (`\\"`, `\\n`, `\\\\`, ...), each on one line;
  * flow sequences and flow mappings on one line (`[4,2]`, `{'min_lr': 5e-5}`);
  * PyYAML's YAML 1.1 resolution of plain scalars: `null` / `~` / empty,
    booleans (`true`, `yes`, `off`, ...), ints (decimal, `0x`, `0b`, octal,
    `6:00:00` in base 60) and floats (`.5`, `1.0e+3`, `.inf`, `.nan`);
  * `???` stays the string `???`, which the config nodes read as missing.

What lies outside the subset raises `YamlUnsupported` (anchors, aliases, tags,
block scalars, complex keys, multi-document streams, timestamps, merge keys,
scalars over several lines); malformed text raises `YamlError`. Both name the
file and the line. Nothing is guessed.
"""
from __future__ import annotations

import re
from typing import Any, List, NamedTuple, Tuple

__all__ = ["YamlError", "YamlUnsupported", "load", "load_file", "parse_value"]


class YamlError(ValueError):
    """Malformed YAML, where PyYAML raises too."""


class YamlUnsupported(YamlError):
    """Valid YAML outside the subset this reader implements."""


# PyYAML's implicit resolvers (yaml/resolver.py), tried in this order for a
# plain scalar whose first character is in the resolver's list
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                      r"|on|On|ON|off|Off|OFF)$")
_FLOAT_RE = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT_RE = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_MERGE_RE = re.compile(r"^(?:<<)$")
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP_RE = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_VALUE_RE = re.compile(r"^(?:=)$")
_RESOLVERS = (("bool", _BOOL_RE, "yYnNtTfFoO"), ("float", _FLOAT_RE, "-+0123456789."),
              ("int", _INT_RE, "-+0123456789"), ("merge", _MERGE_RE, "<"),
              ("null", _NULL_RE, "~nN"), ("timestamp", _TIMESTAMP_RE, "0123456789"),
              ("value", _VALUE_RE, "="))
# OmegaConf's floats without a dot ('1e-3'), which YAML 1.1 leaves strings
# (the JAX composer's `_SCI_FLOAT_RE`)
_SCI_FLOAT_RE = re.compile(r"^[-+]?(\d+(\.\d*)?|\.\d+)[eE][-+]?\d+$")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_KEY_SEP_RE = re.compile(r":(?: |$)")


class _Line(NamedTuple):
    no: int        # 1-based line number
    indent: int
    text: str      # without indentation, comment and trailing blanks


def _sexagesimal(value: str, cast):
    total, base = cast(0), 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def _construct_int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _construct_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


class _Reader:
    def __init__(self, source: str):
        self.source = source

    def fail(self, no: int, msg: str, unsupported: bool = False):
        raise (YamlUnsupported if unsupported else YamlError)(f"{self.source}:{no}: {msg}")

    # -- scalars ------------------------------------------------------------
    def plain(self, text: str, no: int):
        """A plain scalar, resolved as PyYAML's safe loader does."""
        first = text[:1]
        if first and first in "&*!|>":
            self.fail(no, f"{text!r}: anchors, aliases, tags and block scalars are "
                          f"outside the supported YAML subset", unsupported=True)
        if first and (first in "%@`" or (first in "?-" and text[1:2] in ("", " "))):
            self.fail(no, f"{text!r} is not a plain scalar here")
        if _KEY_SEP_RE.search(text):
            self.fail(no, f"{text!r}: a mapping value is not allowed here")
        kind = next((name for name, regex, first in _RESOLVERS
                     if (text[:1] in first if text else name == "null")
                     and regex.match(text)), None)
        if kind == "bool":
            return text.lower() in ("yes", "true", "on")
        if kind == "float":
            return _construct_float(text)
        if kind == "int":
            return _construct_int(text)
        if kind == "null":
            return None
        if kind in ("merge", "timestamp"):
            self.fail(no, f"{text!r}: {kind} scalars are outside the supported YAML subset",
                      unsupported=True)
        if kind == "value":
            self.fail(no, f"{text!r}: no constructor for the value tag")
        return float(text) if _SCI_FLOAT_RE.match(text) else text

    def quoted(self, text: str, pos: int, no: int) -> Tuple[str, int]:
        """The quoted scalar starting at text[pos]; returns (value, end)."""
        quote, out, i = text[pos], [], pos + 1
        while i < len(text):
            ch = text[i]
            if quote == "'":
                if ch == "'":
                    if text[i + 1:i + 2] == "'":
                        out.append("'")
                        i += 2
                        continue
                    return "".join(out), i + 1
                out.append(ch)
                i += 1
                continue
            if ch == '"':
                return "".join(out), i + 1
            if ch == "\\":
                code = text[i + 1:i + 2]
                if code in _ESCAPES:
                    out.append(_ESCAPES[code])
                    i += 2
                elif code in _HEX_ESCAPES:
                    digits = text[i + 2:i + 2 + _HEX_ESCAPES[code]]
                    if len(digits) != _HEX_ESCAPES[code] or not re.fullmatch(
                            r"[0-9a-fA-F]+", digits):
                        self.fail(no, f"bad \\{code} escape in a double-quoted scalar")
                    out.append(chr(int(digits, 16)))
                    i += 2 + len(digits)
                else:
                    self.fail(no, f"unknown escape \\{code} in a double-quoted scalar")
                continue
            out.append(ch)
            i += 1
        self.fail(no, "unterminated quoted scalar (a quoted scalar must end on its line)")

    def inline(self, text: str, no: int):
        """A value written on one line: a quoted or plain scalar or a flow
        collection."""
        if text[:1] in ("[", "{", "'", '"'):
            value, end = self.flow(text, 0, no, top=True)
            if text[end:].strip():
                self.fail(no, f"unexpected text after the value: {text[end:].strip()!r}")
            return value
        return self.plain(text, no)

    # -- flow collections ----------------------------------------------------
    @staticmethod
    def _skip(text: str, i: int) -> int:
        while i < len(text) and text[i] == " ":
            i += 1
        return i

    def _flow_plain(self, text: str, i: int, no: int) -> Tuple[str, int]:
        j = i
        while j < len(text) and text[j] not in ",[]{}":
            if text[j] == ":" and (j + 1 == len(text) or text[j + 1] in " ,[]{}"):
                break
            j += 1
        return text[i:j].rstrip(), j

    def flow(self, text: str, i: int, no: int, top: bool = False):
        """The flow node at text[i]; returns (value, end)."""
        i = self._skip(text, i)
        if i >= len(text):
            self.fail(no, "unterminated flow collection")
        ch = text[i]
        if ch in "'\"":
            return self.quoted(text, i, no)
        if ch == "[":
            items, i = [], i + 1
            while True:
                i = self._skip(text, i)
                if text[i:i + 1] == "]":
                    return items, i + 1
                value, i = self.flow(text, i, no)
                i = self._skip(text, i)
                if text[i:i + 1] == ":":
                    self.fail(no, "a single-pair mapping inside a flow sequence is outside "
                                  "the supported YAML subset", unsupported=True)
                items.append(value)
                if text[i:i + 1] == ",":
                    i += 1
                elif text[i:i + 1] != "]":
                    self.fail(no, "expected ',' or ']' in a flow sequence")
        if ch == "{":
            out, i = {}, i + 1
            while True:
                i = self._skip(text, i)
                if text[i:i + 1] == "}":
                    return out, i + 1
                if text[i:i + 1] in ("[", "{"):
                    self.fail(no, "complex mapping keys are outside the supported YAML subset",
                              unsupported=True)
                key, i = self.flow(text, i, no)
                i = self._skip(text, i)
                value = None
                if text[i:i + 1] == ":":
                    i = self._skip(text, i + 1)
                    if text[i:i + 1] not in (",", "}"):
                        value, i = self.flow(text, i, no)
                        i = self._skip(text, i)
                out[key] = value
                if text[i:i + 1] == ",":
                    i += 1
                elif text[i:i + 1] != "}":
                    self.fail(no, "expected ',' or '}' in a flow mapping")
        if ch in ",]}":
            self.fail(no, f"unexpected {ch!r} in a flow collection")
        raw, end = self._flow_plain(text, i, no)
        return self.plain(raw, no), end

    # -- lines and blocks ----------------------------------------------------
    def lines(self, text: str) -> List[_Line]:
        out = []
        for no, raw in enumerate(text.splitlines(), 1):
            body = raw.lstrip(" ")
            indent = len(raw) - len(body)
            if body.startswith("\t"):
                self.fail(no, "a tab in the indentation", unsupported=True)
            body = self._strip_comment(body, no).rstrip(" \t")
            if not body:
                continue
            if indent == 0 and (body.startswith("%") or body in ("---", "...")
                                or body.startswith(("--- ", "... "))):
                self.fail(no, "directives and document markers are outside the supported "
                              "YAML subset", unsupported=True)
            out.append(_Line(no, indent, body))
        return out

    def _strip_comment(self, body: str, no: int) -> str:
        """`body` without its comment: a `#` at the start or after a blank,
        outside quoted scalars. A quote opens a scalar only where one can
        start (the line's start, after `- `, `: `, `[`, `{` or `,`)."""
        i, last = 0, ""     # last: the previous non-blank character
        gap = True          # blanks since `last`
        while i < len(body):
            ch = body[i]
            if ch == "#" and (i == 0 or body[i - 1] in " \t"):
                return body[:i]
            if ch in "'\"" and (last in ("", "[", "{", ",") or (last in (":", "-") and gap)):
                _, i = self.quoted(body, i, no)
                last, gap = ch, False
                continue
            if ch in " \t":
                gap = True
            else:
                last, gap = ch, False
            i += 1
        return body

    @staticmethod
    def _is_seq(text: str) -> bool:
        return text == "-" or text.startswith("- ")

    def _split_key(self, line: _Line):
        """(key, rest) when the line is a mapping entry, else None."""
        text = line.text
        if text.startswith("? ") or text == "?":
            self.fail(line.no, "complex mapping keys are outside the supported YAML subset",
                      unsupported=True)
        if text[0] in "'\"":
            key, end = self.quoted(text, 0, line.no)
            rest = text[end:].lstrip(" ")
            if rest == ":" or rest.startswith(": "):
                return key, rest[1:].strip()
            return None
        if text[0] in "[{":
            return None
        m = _KEY_SEP_RE.search(text)
        if m is None:
            return None
        return self.plain(text[:m.start()].rstrip(), line.no), text[m.end():].strip()

    def node(self, lines: List[_Line], i: int) -> Tuple[Any, int]:
        line = lines[i]
        if self._is_seq(line.text):
            return self.sequence(lines, i, line.indent)
        if self._split_key(line) is not None:
            return self.mapping(lines, i, line.indent)
        return self.inline(line.text, line.no), i + 1

    def _nested(self, lines: List[_Line], i: int, indent: int, seq_same_indent: bool):
        """The block under the entry at lines[i - 1] (indented deeper, or a
        sequence at the entry's own indentation), or None when there is none."""
        if i < len(lines) and lines[i].indent > indent:
            return self.node(lines, i)
        if seq_same_indent and i < len(lines) and lines[i].indent == indent \
                and self._is_seq(lines[i].text):
            return self.sequence(lines, i, indent)
        return None, i

    def mapping(self, lines: List[_Line], i: int, indent: int) -> Tuple[dict, int]:
        out = {}
        while i < len(lines) and lines[i].indent == indent:
            line = lines[i]
            split = self._split_key(line)
            if split is None:
                self.fail(line.no, f"expected a 'key: value' entry, got {line.text!r}")
            key, rest = split
            if rest:
                value, i = self.inline(rest, line.no), i + 1
            else:
                value, i = self._nested(lines, i + 1, indent, seq_same_indent=True)
            out[key] = value
        if i < len(lines) and lines[i].indent > indent:
            self.fail(lines[i].no, "unexpected indentation (scalars over several lines are "
                                   "outside the supported YAML subset)")
        return out, i

    def sequence(self, lines: List[_Line], i: int, indent: int) -> Tuple[list, int]:
        items = []
        while i < len(lines) and lines[i].indent == indent and self._is_seq(lines[i].text):
            line = lines[i]
            rest = line.text[1:].lstrip(" ")
            if not rest:
                value, i = self._nested(lines, i + 1, indent, seq_same_indent=False)
            elif self._is_seq(rest):
                self.fail(line.no, "a sequence opened on its parent's '- ' line is outside "
                                   "the supported YAML subset", unsupported=True)
            else:
                # the entry's content as a line of its own, at its own column
                inner = _Line(line.no, indent + len(line.text) - len(rest), rest)
                if self._split_key(inner) is not None:
                    value, i = self.mapping([*lines[:i], inner, *lines[i + 1:]], i,
                                            inner.indent)
                else:
                    value, i = self.inline(rest, line.no), i + 1
            items.append(value)
        if i < len(lines) and lines[i].indent > indent:
            self.fail(lines[i].no, "unexpected indentation")
        return items, i

    def document(self, text: str):
        lines = self.lines(text)
        if not lines:
            return None
        value, i = self.node(lines, 0)
        if i < len(lines):
            self.fail(lines[i].no, f"unexpected {lines[i].text!r} after the document's "
                                   f"top-level node")
        return value


def load(text: str, source: str = "<string>"):
    """The value of one YAML document in the subset (None for an empty one)."""
    return _Reader(source).document(text)


def load_file(path: str):
    with open(path, "r") as f:
        return load(f.read(), path)


def parse_value(text: str) -> Any:
    """A command-line override value: read as YAML, and kept as the raw text
    where it is malformed YAML (as the JAX composer's `_parse_value` keeps
    the text on PyYAML's errors). Valid YAML outside the subset raises."""
    if text == "???":
        return "???"
    try:
        return load(text, "<override>")
    except YamlUnsupported:
        raise
    except YamlError:
        return text
