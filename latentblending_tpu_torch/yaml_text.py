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
