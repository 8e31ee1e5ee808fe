"""YAML text for flat settings dicts, without PyYAML.

The JAX package writes lowres.yaml with
`yaml.dump(d, sort_keys=False, default_flow_style=False)`; the card's
machine has no PyYAML, so the port writes the same text itself for the
value types an engine's state dict holds: str, int, float and bool. As
PyYAML does, a string is written plain where a YAML reader would read it
back as that string (folded after column 80 at single spaces), else
single-quoted where it is printable ASCII on one line (folded the same
way), else double-quoted with escapes; floats as repr() in lower case
with a ".0" mantissa before an exponent; bools as true/false.

`yml_load` reads that text back as PyYAML's SafeLoader does: block
mappings and block lists, plain, single- and double-quoted scalars (folded
over lines too), and the plain scalars' implicit types (null, bool, int,
float). Anything else (anchors, aliases, tags, flow collections, block
scalars, complex keys, timestamps) raises ValueError.
"""
from __future__ import annotations

import re

_WIDTH = 80  # PyYAML's best_width
_INDENT = 2  # continuation lines of a top-level mapping's value

# PyYAML's implicit resolvers (yaml/resolver.py): a plain scalar matching
# one of these would be read back as another type
_RESOLVERS = [re.compile(p, re.X) for p in (
    r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$",
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
    r"^(?:<<)$",
    r"^(?: ~ |null|Null|NULL| )$",
    r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
    (?:[Tt]|[ \t]+)[0-9][0-9]?
    :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
    r"^(?:=)$",
)]
_PRINTABLE = re.compile(r"^[\x20-\x7e]*$")


def _plain_ok(s: str) -> bool:
    """Whether PyYAML writes `s` plain in block context: printable ASCII, no
    leading or trailing space, no indicator that would start another node
    or a comment, and not read back as another type."""
    if not s or not _PRINTABLE.match(s) or s[0] == " " or s[-1] == " ":
        return False
    if s[0] in "#,[]{}&*!|>'\"%@`" or s.startswith(("- ", "? ", ": ")) or s in ("-", "?", ":"):
        return False
    if ": " in s or " #" in s or s.endswith(":") or s.startswith("---") or s.startswith("..."):
        return False
    return s[0] not in "~" and not any(r.match(s) for r in _RESOLVERS)


def _fold(text: str, column: int, edge: bool) -> str:
    """PyYAML's write_plain / write_single_quoted line folding: a single
    space after which the column already exceeds the width becomes a line
    break and the value's indent (edge: also not the text's first or last
    character, the single-quoted rule)."""
    out, start, end, spaces = [], 0, 0, False
    while end <= len(text):
        ch = text[end] if end < len(text) else None
        if spaces:
            if ch != " ":
                if start + 1 == end and column > _WIDTH and (not edge or (start != 0 and end != len(text))):
                    out.append("\n" + " " * _INDENT)
                    column = _INDENT
                else:
                    out.append(text[start:end])
                    column += end - start
                start = end
        elif ch is None or ch == " ":
            out.append(text[start:end])
            column += end - start
            start = end
        if ch is not None:
            spaces = ch == " "
        end += 1
    return "".join(out)


_ESCAPES = {"\0": "0", "\x07": "a", "\b": "b", "\t": "t", "\n": "n", "\x0b": "v", "\f": "f", "\r": "r",
            "\x1b": "e", '"': '"', "\\": "\\", "\x85": "N", "\xa0": "_", "\u2028": "L", "\u2029": "P"}


def _double_quoted(s: str) -> str:
    out = []
    for ch in s:
        if ch in _ESCAPES:
            out.append("\\" + _ESCAPES[ch])
        elif "\x20" <= ch <= "\x7e":
            out.append(ch)
        elif ch <= "\xff":
            out.append(f"\\x{ord(ch):02X}")
        elif ch <= "\uffff":
            out.append(f"\\u{ord(ch):04X}")
        else:
            out.append(f"\\U{ord(ch):08X}")
    return '"' + "".join(out) + '"'


def _scalar(value, column: int) -> str:
    """`value` as PyYAML writes it after "key: " (column: where it starts)."""
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return ".nan"
        if value in (float("inf"), float("-inf")):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = "{}.0e{}".format(*text.split("e"))
        return text
    if isinstance(value, str):
        if _plain_ok(value):
            return _fold(value, column, edge=False)
        if _PRINTABLE.match(value):
            return "'" + _fold(value.replace("'", "''"), column + 1, edge=True) + "'"
        return _double_quoted(value)
    raise TypeError(f"yaml_text: no YAML form for {type(value).__name__}")


def dump(d: dict) -> str:
    """A flat dict with str keys and str/int/float/bool values as YAML
    block-mapping text, keys in insertion order."""
    lines = []
    for k, v in d.items():
        if not isinstance(k, str) or not _plain_ok(k):
            raise ValueError(f"yaml_text: key {k!r} is not a plain YAML key")
        lines.append(f"{k}: {_scalar(v, len(k) + 2)}\n")
    return "".join(lines)


def yml_save(fp_yml: str, d: dict) -> None:
    with open(fp_yml, "w", encoding="utf-8") as f:
        f.write(dump(d))


# ------------------------------------------------------------------ reading

_BOOLS = {"yes": True, "true": True, "on": True, "no": False, "false": False, "off": False}
_UNESCAPES = {v: k for k, v in _ESCAPES.items()} | {"/": "/", " ": " ", "\t": "\t"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(text: str, cast):
    sign, value, base = 1, 0, 1
    if text[0] in "+-":
        sign, text = (-1 if text[0] == "-" else 1), text[1:]
    for part in reversed(text.split(":")):
        value += cast(part) * base
        base *= 60
    return sign * value


def _plain_value(text: str):
    """A plain scalar's value under PyYAML's implicit resolvers
    (SafeConstructor's construct_yaml_null/bool/int/float)."""
    bool_r, float_r, int_r, merge_r, null_r, time_r, value_r = _RESOLVERS
    if null_r.match(text):
        return None
    if bool_r.match(text):
        return _BOOLS[text.lower()]
    if int_r.match(text):
        t = text.replace("_", "")
        sign = -1 if t[0] == "-" else 1
        if t[0] in "+-":
            t = t[1:]
        if ":" in t:
            return sign * _sexagesimal(t, int)
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if t != "0" and t.startswith("0"):
            return sign * int(t, 8)
        return sign * int(t)
    if float_r.match(text):
        t = text.replace("_", "").lower()
        if t.lstrip("+-") == ".inf":
            return float("-inf") if t[0] == "-" else float("inf")
        if t == ".nan":
            return float("nan")
        return _sexagesimal(t, float) if ":" in t else float(t)
    if merge_r.match(text) or time_r.match(text) or value_r.match(text):
        raise ValueError(f"yml_load: {text!r} (a merge key, timestamp or value key) is not supported")
    return text


def _unescape(text: str) -> str:
    out, i = [], 0
    while i < len(text):
        ch = text[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        esc = text[i + 1:i + 2]
        if esc in _UNESCAPES:
            out.append(_UNESCAPES[esc])
            i += 2
        elif esc in _HEX_ESCAPES:
            n = _HEX_ESCAPES[esc]
            digits = text[i + 2:i + 2 + n]
            if len(digits) != n or not re.fullmatch(r"[0-9A-Fa-f]+", digits):
                raise ValueError(f"yml_load: bad escape \\{esc}{digits}")
            out.append(chr(int(digits, 16)))
            i += 2 + n
        else:
            raise ValueError(f"yml_load: unknown escape \\{esc}")
    return "".join(out)


def _fold_lines(pieces: list[str], double: bool) -> str:
    """YAML's line folding of a multi-line flow scalar: each line break
    becomes one space, or n line feeds where n empty lines follow it; a
    double-quoted line ending in an unescaped backslash joins the next line
    without a space. Leading and trailing blanks around breaks go."""
    out = pieces[0]
    joined_raw = False
    blank = 0
    for j, piece in enumerate(pieces[1:], start=1):
        last = j == len(pieces) - 1
        if not joined_raw and not blank:
            out = out.rstrip(" \t")
            escaped = double and (len(out) - len(out.rstrip("\\"))) % 2 == 1
            if escaped:
                out = out[:-1]
        else:
            escaped = joined_raw
        t = piece.lstrip(" \t")
        if not t and not last:
            blank += 1
            joined_raw = escaped
            continue
        out += "" if escaped else ("\n" * blank if blank else " ")
        out += t
        blank, joined_raw = 0, False
    return out


class _Reader:
    """Recursive descent over the text's lines for the block subset
    described in the module docstring."""

    def __init__(self, text: str):
        self.lines = [ln.rstrip("\r") for ln in text.split("\n")]
        self.i = 0

    def fail(self, what: str):
        raise ValueError(f"yml_load: line {self.i + 1}: {what}")

    @staticmethod
    def indent(line: str) -> int:
        return len(line) - len(line.lstrip(" "))

    def skip(self) -> bool:
        """Move past blank and comment lines; False at the end."""
        while self.i < len(self.lines):
            t = self.lines[self.i].strip()
            if t and not t.startswith("#"):
                if "\t" in self.lines[self.i][:self.indent(self.lines[self.i]) + 1]:
                    self.fail("tab in indentation")
                return True
            self.i += 1
        return False

    def document(self):
        if not self.skip():
            return {}
        if self.lines[self.i].strip() in ("---", "..."):
            self.fail("document markers are not supported")
        value = self.block(self.indent(self.lines[self.i]))
        if self.skip():
            self.fail("content after the document's top node")
        if not isinstance(value, dict):
            raise ValueError("yml_load: the top-level node is not a mapping")
        return value

    @staticmethod
    def is_item(text: str) -> bool:
        return text == "-" or text.startswith("- ")

    def block(self, ind: int):
        return self.seq(ind) if self.is_item(self.lines[self.i][ind:]) else self.mapping(ind)

    def nested(self, ind: int, same_indent_list: bool):
        """The node under a `key:` or `-` with nothing after it."""
        if not self.skip():
            return None
        li = self.indent(self.lines[self.i])
        if li > ind:
            return self.block(li)
        if li == ind and same_indent_list and self.is_item(self.lines[self.i][ind:]):
            return self.seq(ind)
        return None

    def split_key(self, text: str):
        """(key, rest) of `key: rest`, or None where text is no mapping entry."""
        if text[:1] in "'\"":
            end = self.quote_end(text, 1, text[0])
            if end < 0 or not (text[end + 1:].startswith(": ") or text[end + 1:] == ":"):
                return None
            return self.quoted_value([text[1:end]], text[0]), text[end + 2:]
        m = re.search(r":( |$)", text)
        if m is None:
            return None
        key = text[:m.start()]
        if key.startswith("? ") or key == "?":
            self.fail("complex keys are not supported")
        self.check_indicator(key)
        return _plain_value(key), text[m.end():]

    def mapping(self, ind: int) -> dict:
        out: dict = {}
        while self.skip():
            line = self.lines[self.i]
            li = self.indent(line)
            if li < ind:
                break
            if li > ind or self.is_item(line[ind:]):
                self.fail("unexpected indentation or list item inside a mapping")
            kv = self.split_key(line[ind:])
            if kv is None:
                self.fail(f"expected `key: value`, got {line.strip()!r}")
            key, rest = kv
            if key in out:
                self.fail(f"duplicate key {key!r}")
            self.i += 1
            rest = rest.strip(" ")
            if not rest or rest.startswith("#"):
                out[key] = self.nested(ind, same_indent_list=True)
            else:
                out[key] = self.scalar(rest, ind)
        return out

    def seq(self, ind: int) -> list:
        out = []
        while self.skip():
            line = self.lines[self.i]
            li = self.indent(line)
            if li < ind or (li == ind and not self.is_item(line[ind:])):
                break
            if li > ind:
                self.fail("unexpected indentation inside a list")
            rest = line[ind + 1:]
            body = rest.lstrip(" ")
            if not body or body.startswith("#"):
                self.i += 1
                out.append(self.nested(ind, same_indent_list=False))
                continue
            col = ind + 1 + len(rest) - len(body)
            if self.is_item(body) or self.split_key(body) is not None:
                # a list or a mapping that starts on the item's line: parse it
                # at the column of its first character
                self.lines[self.i] = " " * col + body
                out.append(self.block(col))
            else:
                self.i += 1
                out.append(self.scalar(body, ind))
        return out

    @staticmethod
    def check_indicator(text: str):
        if text[:1] in "&*!|>[]{}%@`" or text.startswith("? "):
            kinds = {"&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars", ">": "block scalars",
                     "[": "flow collections", "{": "flow collections", "?": "complex keys"}
            raise ValueError(f"yml_load: {kinds.get(text[0], 'reserved indicators')} are not supported: {text!r}")

    @staticmethod
    def quote_end(text: str, start: int, q: str) -> int:
        """Index of the closing quote in text[start:], or -1."""
        i = start
        while i < len(text):
            if q == "'" and text[i] == "'":
                if text[i + 1:i + 2] == "'":
                    i += 2
                    continue
                return i
            if q == '"':
                if text[i] == "\\":
                    i += 2
                    continue
                if text[i] == '"':
                    return i
            i += 1
        return -1

    @staticmethod
    def quoted_value(pieces: list[str], q: str) -> str:
        text = _fold_lines(pieces, double=q == '"')
        return text.replace("''", "'") if q == "'" else _unescape(text)

    def scalar(self, first: str, ind: int):
        """A value that starts with `first` on the line just consumed; its
        continuation lines are those indented past `ind`."""
        self.check_indicator(first)
        if first[0] in "'\"":
            q, pieces, text, start = first[0], [], first, 1
            while True:
                end = self.quote_end(text, start, q)
                if end >= 0:
                    pieces.append(text[start:end])
                    tail = text[end + 1:].strip(" ")
                    if tail and not tail.startswith("#"):
                        self.fail(f"text after a quoted scalar: {tail!r}")
                    return self.quoted_value(pieces, q)
                pieces.append(text[start:])
                if self.i >= len(self.lines):
                    self.fail("unterminated quoted scalar")
                text, start = self.lines[self.i], 0
                self.i += 1
        pieces = [first.split(" #")[0].rstrip(" ")]
        blank = 0
        while self.i < len(self.lines):
            line = self.lines[self.i]
            t = line.strip(" ")
            if t and (self.indent(line) <= ind or t.startswith("#")):
                break
            self.i += 1
            if not t:
                blank += 1
                continue
            if ": " in t or t.endswith(":"):
                self.fail("a mapping entry inside a plain scalar")
            pieces.extend([""] * blank + [t.split(" #")[0]])
            blank = 0
        self.i -= blank  # trailing blank lines are not part of the scalar
        return _plain_value(_fold_lines(pieces, double=False)) if len(pieces) > 1 else _plain_value(pieces[0])


def loads(text: str) -> dict:
    """The mapping a YAML text in the block subset above holds."""
    return _Reader(text).document()


def yml_load(fp_yml: str) -> dict:
    with open(fp_yml, encoding="utf-8") as f:
        return loads(f.read())
