"""A reader and writer for the YAML subset of the repo's config files.

The card's machine has no pyyaml, so ``Config.from_yaml`` reads its files
here.  The subset is what ``configs/*.yaml`` use:

* block mappings, nested by indentation (spaces only);
* block lists (``- x``) of scalars, under a key at its own indentation or
  deeper;
* flow lists of scalars and flow lists (``[8, 1, 1]``, ``[[512, 512]]``) on
  one line;
* plain, single-quoted and double-quoted scalars on one line;
* comments, whole-line and trailing (`` # ...``).

Plain scalars resolve as ``yaml.safe_load`` resolves them (YAML 1.1), not
as Python would: ``1e-6`` (no dot) is the string ``'1e-6'``, ``4.0e-7`` a
float, ``yes`` / ``on`` are ``True``, ``0x10`` is 16, ``~`` / ``null`` /
nothing are ``None``.  Anything outside the subset (anchors, tags, block
scalars, flow mappings, multi-line scalars, mappings inside lists,
timestamps, duplicate keys, tabs) raises ``YAMLSubsetError`` with its line
number; the reader never guesses.  ``dump`` writes a nested dict of
scalars and lists that ``load`` (and ``yaml.safe_load``) reads back to the
same dict.
"""
from __future__ import annotations

import json
import math
import re
from pathlib import Path
from typing import Any, List, Optional, Tuple

# YAML 1.1's implicit resolvers, as PyYAML's ``resolver.py`` states them
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_TIMESTAMP = re.compile(
    r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
    r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
    r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$")
_TRUE = ("yes", "true", "on")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# a plain scalar may not start with these indicators (anchors, aliases,
# tags, block scalars, directives, reserved characters, flow mappings)
_UNSUPPORTED_START = "&*!|>%@`{}"
# a quote opens a quoted scalar only where a scalar can start
_SCALAR_STARTS = (None, ":", "-", "[", ",")


class YAMLSubsetError(ValueError):
    """Input outside the supported subset, or malformed."""


def _sexagesimal(text: str, cast) -> Any:
    value, base = 0, 1
    for part in reversed(text.split(":")):
        value += cast(part) * base
        base *= 60
    return value


def resolve_scalar(text: str) -> Any:
    """A plain scalar as ``yaml.safe_load`` resolves it: None, bool, int,
    float or str.  A timestamp raises (``safe_load`` would build a date)."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v[1:] if v[0] in "+-" else v
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v[1:] if v[0] in "+-" else v
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    if _TIMESTAMP.match(text):
        raise ValueError(f"timestamp {text!r} is outside the subset (quote "
                         "it for a string)")
    return text


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text = no, indent, text


def _strip_comment(raw: str, no: int) -> str:
    """``raw`` without its comment; '#' starts one at the line's start or
    after whitespace, outside quoted scalars."""
    quote, prev, i = None, None, 0
    while i < len(raw):
        ch = raw[i]
        if quote == '"':
            if ch == "\\":
                i += 1
            elif ch == '"':
                quote = None
        elif quote == "'":
            if ch == "'":
                if raw[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif ch in "\"'" and prev in _SCALAR_STARTS:
            quote = ch
        elif ch == "#" and (i == 0 or raw[i - 1] in " \t"):
            return raw[:i].rstrip()
        if ch not in " \t":
            prev = ch
        i += 1
    if quote is not None:
        raise YAMLSubsetError(f"line {no}: unterminated {quote}-quoted "
                              "scalar (multi-line scalars are outside the "
                              "subset)")
    return raw.rstrip()


def _lines(text: str) -> List[_Line]:
    out = []
    for no, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            raise YAMLSubsetError(f"line {no}: tab in the indentation")
        body = _strip_comment(body, no)
        if not body:
            continue
        if no == 1 and body.startswith("﻿"):
            body = body[1:]
        if body in ("---", "...") or body.startswith(("--- ", "%")):
            raise YAMLSubsetError(f"line {no}: document markers and "
                                  "directives are outside the subset")
        out.append(_Line(no, len(raw) - len(raw.lstrip(" ")), body))
    return out


def _quoted(text: str, no: int) -> Tuple[str, int]:
    """The quoted scalar at the start of ``text``: (value, characters
    consumed)."""
    q = text[0]
    out, i = [], 1
    while i < len(text):
        ch = text[i]
        if q == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and ch == '"':
            return "".join(out), i + 1
        if q == '"' and ch == "\\":
            esc = text[i + 1:i + 2]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                i += 2
                continue
            width = _HEX_ESCAPES.get(esc)
            digits = text[i + 2:i + 2 + (width or 0)]
            if width is None or len(digits) != width or not all(
                    c in "0123456789abcdefABCDEF" for c in digits):
                raise YAMLSubsetError(f"line {no}: bad escape in "
                                      f"{text!r}")
            out.append(chr(int(digits, 16)))
            i += 2 + width
            continue
        out.append(ch)
        i += 1
    raise YAMLSubsetError(f"line {no}: unterminated quoted scalar {text!r}")


def _plain(text: str, no: int, flow: bool) -> Any:
    if text[0] in _UNSUPPORTED_START or text in ("=", "<<"):
        raise YAMLSubsetError(f"line {no}: {text!r}: anchors, aliases, "
                              "tags, block scalars and flow mappings are "
                              "outside the subset")
    if text[0] in "-?:" and (len(text) == 1 or text[1] == " "):
        raise YAMLSubsetError(f"line {no}: {text!r}: nested block "
                              "collections on one line are outside the "
                              "subset")
    if ": " in text or text.endswith(":") or (flow and ":" in text):
        raise YAMLSubsetError(f"line {no}: {text!r}: a mapping is not "
                              "allowed here")
    try:
        return resolve_scalar(text)
    except ValueError as e:
        raise YAMLSubsetError(f"line {no}: {e}") from None


def _flow_list(text: str, no: int) -> Tuple[list, int]:
    """The flow list at the start of ``text``: (items, characters
    consumed)."""
    items: list = []
    i = 1
    expect_item = True
    while True:
        while i < len(text) and text[i] == " ":
            i += 1
        if i >= len(text):
            raise YAMLSubsetError(f"line {no}: unterminated flow list "
                                  "(multi-line flow lists are outside the "
                                  "subset)")
        ch = text[i]
        if ch == "]":
            if expect_item and items:
                raise YAMLSubsetError(f"line {no}: empty item in a flow "
                                      "list")
            return items, i + 1
        if not expect_item:
            if ch != ",":
                raise YAMLSubsetError(f"line {no}: expected ',' or ']' in "
                                      f"{text!r}")
            i += 1
            expect_item = True
            continue
        if ch == ",":
            raise YAMLSubsetError(f"line {no}: empty item in a flow list")
        if ch == "[":
            value, n = _flow_list(text[i:], no)
        elif ch in "\"'":
            value, n = _quoted(text[i:], no)
        else:
            m = re.match(r"[^,\[\]]*", text[i:])
            token = m.group(0).rstrip()
            value, n = _plain(token, no, flow=True), len(token)
        items.append(value)
        i += n
        expect_item = False


def _inline(text: str, no: int) -> Any:
    """A value written on its key's (or its dash's) line."""
    if text[0] == "[":
        value, n = _flow_list(text, no)
    elif text[0] in "\"'":
        value, n = _quoted(text, no)
    else:
        return _plain(text, no, flow=False)
    if text[n:].strip():
        raise YAMLSubsetError(f"line {no}: unexpected {text[n:].strip()!r} "
                              "after the value")
    return value


def _is_item(line: _Line) -> bool:
    return line.text == "-" or line.text.startswith("- ")


def _split_key(line: _Line) -> Tuple[Any, str]:
    text = line.text
    if text[0] in "\"'":
        key, n = _quoted(text, line.no)
        rest = text[n:]
        if not (rest == ":" or rest.startswith(": ")):
            raise YAMLSubsetError(f"line {line.no}: expected ':' after the "
                                  f"key in {text!r}")
        return key, rest[1:].strip()
    m = re.search(r":( |$)", text)
    if m is None:
        raise YAMLSubsetError(f"line {line.no}: expected 'key: value', got "
                              f"{text!r}")
    key = _plain(text[:m.start()].rstrip(), line.no, flow=True)
    if isinstance(key, float) and math.isnan(key):
        raise YAMLSubsetError(f"line {line.no}: a NaN key")
    return key, text[m.end():].strip()


class _Parser:
    def __init__(self, lines: List[_Line]):
        self.lines = lines
        self.i = 0

    def peek(self) -> Optional[_Line]:
        return self.lines[self.i] if self.i < len(self.lines) else None

    def block(self, indent: int) -> Any:
        line = self.peek()
        return (self.sequence(indent) if _is_item(line)
                else self.mapping(indent))

    def _nested(self, indent: int, allow_same_item: bool) -> Any:
        """The value of a key or dash with nothing after it: a deeper
        block, a list at the key's own indentation, or null."""
        nxt = self.peek()
        if nxt is not None and nxt.indent > indent:
            return self.block(nxt.indent)
        if (allow_same_item and nxt is not None and nxt.indent == indent
                and _is_item(nxt)):
            return self.sequence(indent)
        return None

    def _end_of_value(self, indent: int) -> None:
        nxt = self.peek()
        if nxt is not None and nxt.indent > indent:
            raise YAMLSubsetError(f"line {nxt.no}: unexpected indentation "
                                  "(multi-line scalars are outside the "
                                  "subset)")

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise YAMLSubsetError(f"line {line.no}: unexpected "
                                      "indentation")
            if _is_item(line):
                raise YAMLSubsetError(f"line {line.no}: a list item where "
                                      "a mapping key was expected")
            key, rest = _split_key(line)
            if key in out:
                raise YAMLSubsetError(f"line {line.no}: duplicate key "
                                      f"{key!r}")
            self.i += 1
            if rest:
                out[key] = _inline(rest, line.no)
                self._end_of_value(indent)
            else:
                out[key] = self._nested(indent, allow_same_item=True)

    def sequence(self, indent: int) -> list:
        out: list = []
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent or not _is_item(line):
                if line.indent == indent:  # a key after a key's list
                    return out
                raise YAMLSubsetError(f"line {line.no}: unexpected "
                                      "indentation in a list")
            self.i += 1
            rest = line.text[1:].strip()
            if not rest:
                out.append(self._nested(indent, allow_same_item=False))
                continue
            if re.search(r":( |$)", rest) and rest[0] not in "\"'[":
                raise YAMLSubsetError(f"line {line.no}: mappings inside "
                                      "lists are outside the subset")
            out.append(_inline(rest, line.no))
            self._end_of_value(indent)


def load(text: str, source: str = "<string>") -> Any:
    """The document in ``text``: a dict or a list, or None when it is
    empty."""
    try:
        lines = _lines(text)
        if not lines:
            return None
        parser = _Parser(lines)
        value = parser.block(lines[0].indent)
        if parser.peek() is not None:
            raise YAMLSubsetError(f"line {parser.peek().no}: unexpected "
                                  "indentation")
        return value
    except YAMLSubsetError as e:
        raise YAMLSubsetError(f"{source}: {e}") from None


def load_file(path) -> Any:
    return load(Path(path).read_text(encoding="utf-8"), source=str(path))


# ---------------------------------------------------------------- writer

def _dump_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        mantissa, _, exp = text.partition("e")
        if "." not in mantissa:  # YAML 1.1 floats need the dot
            mantissa += ".0"
        return mantissa + ("e" + exp if exp else "")
    if isinstance(value, Path):
        value = str(value)
    if isinstance(value, str):
        return json.dumps(value, ensure_ascii=False)
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_dump_scalar(v) for v in value) + "]"
    raise TypeError(f"cannot write {type(value).__name__} {value!r} as YAML")


def _dump_key(key: Any) -> str:
    if isinstance(key, str) and re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", key) \
            and resolve_scalar(key) == key:
        return key
    return _dump_scalar(key)


def dump(data: dict) -> str:
    """A nested dict as block mappings; lists as flow lists."""
    out: List[str] = []

    def walk(d: dict, indent: int) -> None:
        for k, v in d.items():
            pad = " " * indent + _dump_key(k) + ":"
            if isinstance(v, dict) and v:
                out.append(pad)
                walk(v, indent + 2)
            elif isinstance(v, dict):
                raise TypeError(f"empty mapping at {k!r} cannot be written")
            else:
                out.append(f"{pad} {_dump_scalar(v)}")

    walk(data, 0)
    return "\n".join(out) + "\n"
