"""A YAML reader for the configuration files, with the standard library only.

It reads the subset of YAML 1.1 that ``cfg/`` uses, to the values PyYAML's
``SafeLoader`` gives (with ``!include`` resolved relative to the including
file, as ``common/settings.py`` has always resolved it):

- block mappings and block sequences (also ``- key: value`` items and a
  sequence at its parent key's indent);
- flow sequences and mappings on one line, nested too (``k: [[1.0, 0.0], ...]``);
- plain scalars resolved as PyYAML resolves them: null (``~``, ``null``,
  ``Null``, ``NULL``, empty), ``true``/``True``/``TRUE`` and the false ones,
  decimal ints, floats (a dot required, ``1.e-8``; ``1e-3`` without a dot is a
  string, as in PyYAML), ``.inf``/``.nan`` (the metrics files' non-finite
  values); single- and double-quoted strings;
- comments, anchors (``&name``) and aliases (``*name``; the alias is the same
  object, as in PyYAML);
- the ``!include path`` tag.

Anything else (block scalars ``|``/``>``, other tags, merge keys, multi-line
flow collections or plain scalars, document markers, tabs in indentation,
YAML 1.1's ``yes``/``no``/``on``/``off`` booleans, hex, octal, binary and
sexagesimal ints, timestamps) raises ``YamlError`` naming the file and line.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE"}
_FALSE = {"false", "False", "FALSE"}
# YAML 1.1 booleans and int forms that PyYAML resolves and cfg/ does not use.
_UNREAD_WORDS = {"yes", "Yes", "YES", "no", "No", "NO", "on", "On", "ON", "off", "Off", "OFF"}
_UNREAD_INT = re.compile(r"[-+]?(?:0[0-7_]+|0x[0-9a-fA-F_]+|0b[0-1_]+)$")
_INT_DEC = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
_SEXAGESIMAL = re.compile(r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_TIMESTAMP = re.compile(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}


class YamlError(ValueError):
    """A file this reader does not take, with its file and line."""


def load_file(path: str) -> Any:
    """The YAML file ``path``, ``!include`` resolved relative to it."""
    path = os.path.expanduser(path)
    with open(path, "r") as f:
        return loads(f.read(), path)


def loads(text: str, path: str = "<string>") -> Any:
    """The YAML document ``text``; ``path`` names it in errors and anchors
    ``!include``."""
    return _Parser(text, path).document()


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str) -> None:
        self.no, self.indent, self.text = no, indent, text


def _strip_comment(line: str) -> str:
    """``line`` without a comment: ``#`` at the start or after a blank, outside quotes."""
    quote = None
    i = 0
    while i < len(line):
        c = line[i]
        if quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif quote == "'":
            if c == "'":
                if i + 1 < len(line) and line[i + 1] == "'":
                    i += 1
                else:
                    quote = None
        elif c in "\"'" and (i == 0 or line[i - 1] in " \t[{,:-?"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        i += 1
    return line


def _is_seq_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Parser:
    def __init__(self, text: str, path: str) -> None:
        self.path = path
        self.anchors: Dict[str, Any] = {}
        self.lines: List[_Line] = []
        for no, raw in enumerate(text.splitlines(), start=1):
            body = _strip_comment(raw).rstrip()
            if not body.strip():
                continue
            stripped = body.lstrip(" ")
            if stripped.startswith("\t"):
                self.fail(no, "a tab in the indentation")
            if stripped in ("---", "...") or stripped.startswith(("--- ", "%")):
                self.fail(no, "document markers and directives are not read")
            self.lines.append(_Line(no, len(body) - len(stripped), stripped))
        self.i = 0

    def fail(self, no: int, what: str):
        raise YamlError(f"{self.path}:{no}: {what}")

    # -- block structure -------------------------------------------------------
    def document(self) -> Any:
        if not self.lines:
            return None
        node = self.block(self.lines[0].indent)
        if self.i < len(self.lines):
            self.fail(self.lines[self.i].no, "content after the document's top node")
        return node

    def block(self, indent: int) -> Any:
        line = self.lines[self.i]
        if _is_seq_item(line.text):
            return self.sequence(indent)
        if self.key_split(line) is not None:
            return self.mapping(indent)
        self.i += 1
        node = self.value(line.text, line, indent)
        return node

    def mapping(self, indent: int) -> Dict[Any, Any]:
        out: Dict[Any, Any] = {}
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if line.indent < indent:
                break
            if line.indent > indent:
                self.fail(line.no, "unexpected indentation")
            if _is_seq_item(line.text):
                break
            split = self.key_split(line)
            if split is None:
                self.fail(line.no, "expected 'key: value' in a mapping")
            key, rest = split
            if key == "<<":
                self.fail(line.no, "merge keys ('<<') are not read")
            self.i += 1
            out[key] = self.value(rest, line, indent, seq_at_indent=True)
        return out

    def sequence(self, indent: int) -> List[Any]:
        out: List[Any] = []
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if line.indent < indent:
                break
            if line.indent > indent:
                self.fail(line.no, "unexpected indentation")
            if not _is_seq_item(line.text):
                break
            rest = line.text[1:]
            body = rest.lstrip(" ")
            if body and (_is_seq_item(body) or self.key_split(_Line(line.no, 0, body))):
                # A compact nested node: re-read this line as its first line.
                inner = indent + 1 + len(rest) - len(body)
                self.lines[self.i] = _Line(line.no, inner, body)
                out.append(self.block(inner))
            else:
                self.i += 1
                out.append(self.value(body, line, indent))
        return out

    def key_split(self, line: _Line) -> Optional[Tuple[Any, str]]:
        """(key, rest) if the line opens a mapping entry, else None."""
        text = line.text
        if not text or text[0] in "[{&*!|>%@`" or _is_seq_item(text):
            return None
        if text[0] in "\"'":
            end = self.quoted_end(text, 0, line.no)
            after = text[end:].lstrip(" ")
            if not (after == ":" or after.startswith(": ")):
                return None
            return self.quoted(text[:end], line.no), after[1:].strip()
        if text.startswith("? "):
            self.fail(line.no, "complex keys ('? ') are not read")
        m = re.search(r":(?: |$)", text)
        if m is None:
            return None
        key = text[: m.start()].rstrip()
        return self.resolve(key, line.no), text[m.end():].strip()

    # -- one node ----------------------------------------------------------------
    def value(self, rest: str, line: _Line, indent: int, seq_at_indent: bool = False) -> Any:
        """The node that ``rest`` (the text after ``key:`` or ``-``) opens; a node
        on the following lines when ``rest`` holds only properties."""
        anchor = tag = None
        rest = rest.strip()
        while rest[:1] in ("&", "!"):
            token, _, rest = rest.partition(" ")
            rest = rest.strip()
            if token[0] == "&":
                anchor = token[1:]
            elif token == "!include":
                tag = token
            else:
                self.fail(line.no, f"the tag {token!r} is not read")
        if not rest:
            nxt = self.lines[self.i] if self.i < len(self.lines) else None
            if nxt is not None and (nxt.indent > indent or (
                    seq_at_indent and nxt.indent == indent and _is_seq_item(nxt.text))):
                node = self.block(nxt.indent)
            else:
                node = None
            if tag is not None:
                self.fail(line.no, "!include takes a path on its own line")
        else:
            if rest[0] in "|>":
                self.fail(line.no, "block scalars ('|', '>') are not read")
            if self.i < len(self.lines) and self.lines[self.i].indent > indent:
                self.fail(self.lines[self.i].no,
                          "a value continued on the next line (multi-line scalar) is not read")
            if rest[0] == "*":
                if anchor is not None or tag is not None:
                    self.fail(line.no, "properties on an alias")
                return self.alias(rest, line.no)
            if rest[0] in "[{":
                node, end = self.flow(rest, 0, line.no)
                if rest[end:].strip():
                    self.fail(line.no, f"text after a flow collection: {rest[end:].strip()!r}")
            elif rest[0] in "\"'":
                end = self.quoted_end(rest, 0, line.no)
                if rest[end:].strip():
                    self.fail(line.no, f"text after a quoted scalar: {rest[end:].strip()!r}")
                node = self.quoted(rest[:end], line.no)
            elif tag is not None:
                node = rest
            else:
                node = self.resolve(rest, line.no)
            if tag is not None:
                if not isinstance(node, str):
                    self.fail(line.no, "!include takes a path")
                node = load_file(os.path.join(os.path.dirname(self.path), node))
        if anchor is not None:
            self.anchors[anchor] = node
        return node

    def alias(self, text: str, no: int) -> Any:
        name = text[1:].strip()
        if name not in self.anchors:
            self.fail(no, f"unknown alias *{name}")
        return self.anchors[name]

    def resolve(self, text: str, no: int) -> Any:
        """A plain scalar, resolved as PyYAML's implicit resolvers resolve it."""
        if text in _NULL:
            return None
        if text in _TRUE:
            return True
        if text in _FALSE:
            return False
        if text[:1] in "&*!|>%@`" or (text[:1] in "?:" and text[1:2] in ("", " ")):
            self.fail(no, f"the plain scalar {text!r} starts with an indicator")
        if text in _UNREAD_WORDS or _UNREAD_INT.match(text) or (
                _SEXAGESIMAL.match(text) and ":" in text):
            self.fail(no, f"the scalar {text!r} (a YAML 1.1 boolean or int form) is not read")
        if _TIMESTAMP.match(text):
            self.fail(no, f"timestamps ({text!r}) are not read")
        digits = text.replace("_", "")
        if _INT_DEC.match(text):
            return int(digits)
        if _FLOAT.match(text):
            return float(digits)
        m = _INF.match(text)
        if m:
            return float("-inf") if m.group(1) == "-" else float("inf")
        if _NAN.match(text):
            return float("nan")
        return text

    # -- quoted scalars ----------------------------------------------------------
    def quoted_end(self, text: str, start: int, no: int) -> int:
        q = text[start]
        i = start + 1
        while i < len(text):
            if q == '"' and text[i] == "\\":
                i += 2
                continue
            if text[i] == q:
                if q == "'" and text[i + 1 : i + 2] == "'":
                    i += 2
                    continue
                return i + 1
            i += 1
        self.fail(no, "an unterminated (or multi-line) quoted scalar")

    def quoted(self, text: str, no: int) -> str:
        body = text[1:-1]
        if text[0] == "'":
            return body.replace("''", "'")
        out, i = [], 0
        while i < len(body):
            c = body[i]
            if c != "\\":
                out.append(c)
                i += 1
                continue
            e = body[i + 1 : i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
            elif e in ("x", "u", "U"):
                n = {"x": 2, "u": 4, "U": 8}[e]
                code = body[i + 2 : i + 2 + n]
                if len(code) != n or not all(ch in "0123456789abcdefABCDEF" for ch in code):
                    self.fail(no, f"a bad escape \\{e}{code}")
                out.append(chr(int(code, 16)))
                i += 2 + n
            else:
                self.fail(no, f"an unknown escape \\{e}")
        return "".join(out)

    # -- flow collections --------------------------------------------------------
    def flow(self, text: str, i: int, no: int) -> Tuple[Any, int]:
        """The flow node at ``text[i]``; returns (node, index after it)."""
        i = self.skip(text, i)
        if i >= len(text):
            self.fail(no, "an unterminated (or multi-line) flow collection")
        c = text[i]
        if c == "[":
            out: List[Any] = []
            i = self.skip(text, i + 1)
            while True:
                if i >= len(text):
                    self.fail(no, "an unterminated (or multi-line) flow sequence")
                if text[i] == "]":
                    return out, i + 1
                node, i = self.flow(text, i, no)
                out.append(node)
                i = self.skip(text, i)
                if text[i : i + 1] == ",":
                    i = self.skip(text, i + 1)
                elif text[i : i + 1] != "]":
                    self.fail(no, "expected ',' or ']' in a flow sequence")
        if c == "{":
            out_map: Dict[Any, Any] = {}
            i = self.skip(text, i + 1)
            while True:
                if i >= len(text):
                    self.fail(no, "an unterminated (or multi-line) flow mapping")
                if text[i] == "}":
                    return out_map, i + 1
                key, i = self.flow(text, i, no)
                i = self.skip(text, i)
                if text[i : i + 1] != ":":
                    self.fail(no, "expected ':' in a flow mapping")
                value, i = self.flow(text, i + 1, no)
                out_map[key] = value
                i = self.skip(text, i)
                if text[i : i + 1] == ",":
                    i = self.skip(text, i + 1)
                elif text[i : i + 1] != "}":
                    self.fail(no, "expected ',' or '}' in a flow mapping")
        if c in "\"'":
            end = self.quoted_end(text, i, no)
            return self.quoted(text[i:end], no), end
        if c == "*":
            m = re.compile(r"\*[^\s,\[\]{}]+").match(text, i)
            return self.alias(m.group(0), no), m.end()
        if c in "&!":
            self.fail(no, "properties inside a flow collection are not read")
        j = i
        while j < len(text) and text[j] not in ",[]{}" and not (
                text[j] == ":" and text[j + 1 : j + 2] in ("", " ", ",", "]", "}")):
            j += 1
        return self.resolve(text[i:j].strip(), no), j

    @staticmethod
    def skip(text: str, i: int) -> int:
        while i < len(text) and text[i] == " ":
            i += 1
        return i
