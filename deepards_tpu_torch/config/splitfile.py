"""Split files: the subset of YAML that the cohort splitters write and read.

A split file is a flat mapping of keys to a list of str, one str or one
float, as ``deepards_tpu/cli/sim_dissim.py`` writes it with ``yaml.dump``
and ``cli/perform_data_splitting.py`` reads it.  This module writes and
reads that subset without PyYAML: keys sorted, lists in block style, a str
quoted wherever YAML 1.1 would read it as something else (so patient ids
such as '0012' or '123' stay str), floats as PyYAML spells them.  Anything
outside the subset is refused with a ``SplitFileError``.
"""
import math
import re

# YAML 1.1 implicit scalars (PyYAML's resolver): what a plain scalar
# becomes when it is not a str
_YAML_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN))$")
_YAML_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+"
    r"|[-+]?0[0-7_]+"
    r"|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_YAML_OTHER = re.compile(
    r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
    r"|on|On|ON|off|Off|OFF|~|null|Null|NULL|=|<<"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9])?$")
# plain scalars this module writes unquoted (and yaml.dump too)
_PLAIN = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]*$")
_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


class SplitFileError(ValueError):
    """A split file, or a mapping, outside the subset this module handles."""


def _resolves_to_other(text):
    return bool(_YAML_FLOAT.match(text) or _YAML_INT.match(text)
                or _YAML_OTHER.match(text))


def _str_scalar(value, where):
    if not isinstance(value, str):
        raise SplitFileError("{}: {!r} is not a str".format(where, value))
    if any(not ch.isprintable() for ch in value):
        raise SplitFileError(
            "{}: {!r} holds a character that is not printable".format(
                where, value))
    if _PLAIN.match(value) and not _resolves_to_other(value):
        return value
    return "'" + value.replace("'", "''") + "'"


def _float_scalar(value):
    """A float as PyYAML's representer spells it."""
    if math.isnan(value):
        return ".nan"
    if math.isinf(value):
        return ".inf" if value > 0 else "-.inf"
    text = repr(float(value)).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def dumps(mapping):
    """The split-file text of ``mapping``: {key: list of str | str |
    float}."""
    if not isinstance(mapping, dict):
        raise SplitFileError("a split file holds a mapping, not {}".format(
            type(mapping).__name__))
    lines = []
    for key in sorted(mapping):
        if not isinstance(key, str) or not _KEY.match(key):
            raise SplitFileError("key {!r} is not an identifier".format(key))
        value = mapping[key]
        if isinstance(value, (list, tuple)):
            if not value:
                lines.append("{}: []".format(key))
                continue
            lines.append("{}:".format(key))
            lines += ["- " + _str_scalar(v, key) for v in value]
        elif isinstance(value, str):
            lines.append("{}: {}".format(key, _str_scalar(value, key)))
        elif isinstance(value, (int, float)) and not isinstance(value, bool):
            lines.append("{}: {}".format(key, _float_scalar(value)))
        else:
            raise SplitFileError(
                "{}: {!r} is not a list of str, a str or a float".format(
                    key, value))
    return "\n".join(lines) + "\n"


def write(path, mapping):
    with open(path, "w") as f:
        f.write(dumps(mapping))


# a double-quoted scalar on one line and YAML's escapes in it (yaml.dump
# double-quotes a str with characters outside printable ASCII)
_DOUBLE_QUOTED = re.compile(
    r'^"((?:[^"\\]|\\(?:[0abt\tnvfre "/\\N_LP]|x[0-9A-Fa-f]{2}'
    r'|u[0-9A-Fa-f]{4}|U[0-9A-Fa-f]{8}))*)"$')
_ESCAPE = re.compile(r"\\(x[0-9A-Fa-f]{2}|u[0-9A-Fa-f]{4}|U[0-9A-Fa-f]{8}"
                     r"|.)")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}


def _unescape(match):
    code = match.group(1)
    if len(code) > 1:
        return chr(int(code[1:], 16))
    return _ESCAPES[code]


def _parse_float(text, where):
    body = text.replace("_", "")
    if ":" in body:
        raise SplitFileError("{}: sexagesimal number {}".format(where, text))
    low = body.lower()
    if low in (".nan",):
        return float("nan")
    if low.lstrip("+-") == ".inf":
        return float("-inf") if low.startswith("-") else float("inf")
    return float(body)


def _parse_scalar(text, where, in_list):
    """A scalar of a split file: quoted -> str; plain -> str, or float
    where YAML reads a number (refused in a list, whose items are str)."""
    if text.startswith("'"):
        if len(text) < 2 or not text.endswith("'") or \
                "'" in text[1:-1].replace("''", ""):
            raise SplitFileError("{}: bad single-quoted scalar {}".format(
                where, text))
        return text[1:-1].replace("''", "'")
    if text.startswith('"'):
        body = _DOUBLE_QUOTED.match(text)
        if body is None:
            raise SplitFileError("{}: bad double-quoted scalar {}".format(
                where, text))
        return _ESCAPE.sub(_unescape, body.group(1))
    if text[:1] in "[]{}&*!|>%@`#," or ": " in text or " #" in text:
        raise SplitFileError("{}: unsupported YAML {!r}".format(where, text))
    if _YAML_FLOAT.match(text) or (
            _YAML_INT.match(text) and re.match(r"^[-+]?(0|[1-9][0-9_]*)$",
                                               text)):
        if in_list:
            raise SplitFileError(
                "{}: list item {} reads as a number in YAML; a split file "
                "lists str (quote it)".format(where, text))
        return _parse_float(text, where)
    if _YAML_INT.match(text) or _YAML_OTHER.match(text):
        raise SplitFileError(
            "{}: {!r} reads as neither a str nor a decimal number in "
            "YAML".format(where, text))
    return text


def loads(text):
    """The mapping of a split file's text."""
    out = {}
    key = None  # the key whose block list is open

    def close(where):
        if key is not None and not out[key]:
            raise SplitFileError("{}: key {} has no value".format(where, key))

    for n, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        where = "line {}".format(n)
        if not line.strip() or line.lstrip().startswith("#") or \
                line == "---":
            continue
        if line.startswith("- ") or line == "-":
            if key is None:
                raise SplitFileError("{}: list item outside a key".format(
                    where))
            out[key].append(_parse_scalar(line[2:].strip(), where, True))
            continue
        if line[0].isspace():
            raise SplitFileError("{}: nested YAML is not a split file: "
                                 "{!r}".format(where, raw))
        name, sep, rest = line.partition(":")
        if not sep or not _KEY.match(name) or (rest and rest[0] != " "):
            raise SplitFileError("{}: expected 'key: value', got {!r}".format(
                where, raw))
        if name in out:
            raise SplitFileError("{}: key {} repeated".format(where, name))
        rest = rest.strip()
        close(where)
        key = None
        if not rest:
            out[name] = []
            key = name
        elif rest == "[]":
            out[name] = []
        else:
            out[name] = _parse_scalar(rest, where, False)
    close("end of file")
    return out


def read(path):
    with open(path) as f:
        return loads(f.read())
