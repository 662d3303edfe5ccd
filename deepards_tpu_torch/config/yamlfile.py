"""Experiment and split files: the subset of YAML the repo's files use,
read and written without PyYAML.

The reader takes what every ``.yml`` under ``deepards_tpu/config/`` uses:
a mapping of top-level keys, plain and quoted scalars on one line, block
lists (at their key's indentation or deeper), ``[]``, one nested mapping
level (an evaluate file's ``models:``, int keys holding block lists),
comments, blank lines and a leading ``---``.  Each plain scalar resolves
as PyYAML's YAML 1.1 resolver resolves it: ``1.0e-08`` is a float and
``1e-3`` a str, ``yes``/``no``/``on``/``off`` are bools, ``~`` and
``null`` are None, ``0012`` is the octal int 10, ``1_000`` is an int and
``80_20_random`` a str.  Anything else (anchors, aliases, tags, flow
collections, multi-line and block scalars, timestamps, a key repeated)
raises ``YamlSubsetError`` with its line.

The writer writes what ``yaml.safe_dump(mapping, default_flow_style=False,
sort_keys=True)`` writes for a mapping of str, int, float, bool and None
scalars, lists of them and one nested mapping level, byte for byte, with
one exception: a str outside printable ASCII is single-quoted, where
PyYAML escapes it in double quotes (both read back the same).
"""
import math
import re

# YAML 1.1 implicit scalars (PyYAML's resolver): what a plain scalar
# becomes when it is not a str
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN))$")
_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+"
    r"|[-+]?0[0-7_]+"
    r"|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
# timestamps, the value key '=' and the merge key '<<': outside the subset
_OTHER = re.compile(
    r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
    r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
    r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?"
    r"|=|<<)$")
_TRUE = ("yes", "true", "on")
# a double-quoted scalar on one line and YAML's escapes in it
_DOUBLE_QUOTED = re.compile(
    r'^"((?:[^"\\]|\\(?:[0abt\tnvfre "/\\N_LP]|x[0-9A-Fa-f]{2}'
    r'|u[0-9A-Fa-f]{4}|U[0-9A-Fa-f]{8}))*)"')
_ESCAPE = re.compile(r"\\(x[0-9A-Fa-f]{2}|u[0-9A-Fa-f]{4}|U[0-9A-Fa-f]{8}"
                     r"|.)")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_SINGLE_QUOTED = re.compile(r"^'((?:[^']|'')*)'")
# a key: plain, up to the first ':' followed by a space or the line's end
_KEY_LINE = re.compile(r"^(.*?):(?: +(.*))?$")
_KEY = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]*$")
WIDTH = 80  # PyYAML's best width: a longer line with a space would wrap


class YamlSubsetError(ValueError):
    """YAML outside the subset this module reads or writes."""


def scalar_kind(text):
    """What a plain scalar resolves to: 'float', 'int', 'bool', 'null',
    'other' (a timestamp, '=' or '<<') or 'str'."""
    for kind, pattern in (("float", _FLOAT), ("int", _INT), ("bool", _BOOL),
                          ("null", _NULL), ("other", _OTHER)):
        if pattern.match(text):
            return kind
    return "str"


def _sexagesimal(parts):
    value = 0
    for part in parts:
        value = value * 60 + part
    return value


def _construct_int(text):
    value = text.replace("_", "")
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
        return sign * _sexagesimal([int(p) for p in value.split(":")])
    return sign * int(value)


def _construct_float(text):
    value = text.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal([float(p) for p in value.split(":")])
    return sign * float(value)


def resolve(text, where="scalar"):
    """The value of a plain scalar, as PyYAML's resolver and safe
    constructor make it."""
    kind = scalar_kind(text)
    if kind == "float":
        return _construct_float(text)
    if kind == "int":
        return _construct_int(text)
    if kind == "bool":
        return text.lower() in _TRUE
    if kind == "null":
        return None
    if kind == "other":
        raise YamlSubsetError("{}: {!r} is a timestamp, '=' or '<<', outside "
                              "the subset".format(where, text))
    return text


def _unescape(match):
    code = match.group(1)
    if len(code) > 1:
        return chr(int(code[1:], 16))
    return _ESCAPES[code]


def _after(rest, where):
    """What follows a quoted scalar: nothing or a comment."""
    if rest.strip() and not re.match(r"^\s+#", rest):
        raise YamlSubsetError("{}: text after a quoted scalar: {!r}".format(
            where, rest))


def _scalar(text, where, plain):
    """The value of a scalar's text on one line (a trailing comment
    allowed): quoted -> str, plain -> ``plain(text, where)``."""
    if text.startswith("'"):
        match = _SINGLE_QUOTED.match(text)
        if match is None:
            raise YamlSubsetError("{}: bad single-quoted scalar {}".format(
                where, text))
        _after(text[match.end():], where)
        return match.group(1).replace("''", "'")
    if text.startswith('"'):
        match = _DOUBLE_QUOTED.match(text)
        if match is None:
            raise YamlSubsetError("{}: bad double-quoted scalar {}".format(
                where, text))
        _after(text[match.end():], where)
        return _ESCAPE.sub(_unescape, match.group(1))
    cut = re.search(r"\s#", text)
    if cut:
        text = text[:cut.start()]
    text = text.rstrip()
    if (text[:1] in tuple("[]{}&*!|>%@`#,") or text[:2] in ("- ", "? ", ": ")
            or text in ("-", "?", ":") or ": " in text or text.endswith(":")):
        raise YamlSubsetError("{}: unsupported YAML {!r}".format(where, text))
    return plain(text, where)


def _value(text, where, plain):
    """A key's or item's value on its own line: ``[]`` or a scalar."""
    if re.match(r"^\[\](?:\s+#.*)?$", text):
        return []
    return _scalar(text, where, plain)


def _content_lines(text):
    """(line number, indent, content) of each line that is not blank or a
    comment; a leading ``---`` is dropped."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        body = raw.strip()
        if not body or body.startswith("#"):
            continue
        indent = len(raw) - len(raw.lstrip(" "))
        if raw[indent:indent + 1] == "\t":
            raise YamlSubsetError("line {}: a tab in the indentation".format(
                n))
        if body == "---" and not lines and indent == 0:
            continue
        lines.append((n, indent, raw.rstrip()[indent:]))
    return lines


def _is_item(content):
    return content == "-" or content.startswith("- ")


def _key(content, where):
    """(key, the value's text) of a ``key: value`` line."""
    match = _KEY_LINE.match(content)
    if match is None or not _KEY.match(match.group(1)):
        raise YamlSubsetError("{}: expected 'key: value', got {!r}".format(
            where, content))
    key = resolve(match.group(1), where)
    if isinstance(key, (bool, float)) or key is None:
        raise YamlSubsetError("{}: key {!r} resolves to {!r}".format(
            where, match.group(1), key))
    rest = (match.group(2) or "").strip()
    return key, "" if rest.startswith("#") else rest


class _Reader:
    def __init__(self, lines, plain):
        self.lines = lines
        self.plain = plain
        self.i = 0

    def peek(self):
        return self.lines[self.i] if self.i < len(self.lines) else None

    def block_list(self, indent, where):
        """The items of a block list whose first item is at ``indent``."""
        items = []
        while True:
            line = self.peek()
            if line is None or line[1] < indent:
                return items
            n, at, content = line
            where = "line {}".format(n)
            if at != indent or not _is_item(content):
                if at == indent and items:
                    return items
                raise YamlSubsetError("{}: a list item at indentation {} "
                                      "expected, got {!r}".format(
                                          where, indent, content))
            text = content[2:].strip()
            if not text or text.startswith("#"):
                raise YamlSubsetError(
                    "{}: an empty or nested list item".format(where))
            items.append(_scalar(text, where, self.plain))
            self.i += 1

    def block_value(self, indent, where, nested_ok):
        """The value of a ``key:`` at ``indent`` with nothing after the
        colon: a block list, a nested mapping or None."""
        line = self.peek()
        if line is None or line[1] < indent or (
                line[1] == indent and not _is_item(line[2])):
            return None
        if _is_item(line[2]):
            return self.block_list(line[1], where)
        if not nested_ok:
            raise YamlSubsetError("line {}: a mapping nested deeper than one "
                                  "level: {!r}".format(line[0], line[2]))
        return self.mapping(line[1], nested_ok=False)

    def mapping(self, indent, nested_ok):
        out = {}
        while True:
            line = self.peek()
            if line is None or line[1] < indent:
                return out
            n, at, content = line
            where = "line {}".format(n)
            if at > indent:
                raise YamlSubsetError("{}: unexpected indentation (a "
                                      "multi-line scalar or a nested block "
                                      "outside the subset): {!r}".format(
                                          where, content))
            if _is_item(content):
                raise YamlSubsetError("{}: list item outside a key".format(
                    where))
            key, rest = _key(content, where)
            if key in out:
                raise YamlSubsetError("{}: key {} repeated".format(where, key))
            self.i += 1
            if rest:
                out[key] = _value(rest, where, self.plain)
            else:
                out[key] = self.block_value(indent, where, nested_ok)


def loads(text, plain=resolve):
    """The mapping of a file's text; ``plain(text, where)`` gives a plain
    scalar's value (default: PyYAML's resolution)."""
    lines = _content_lines(text)
    if len(lines) == 1 and lines[0][2] == "{}":
        return {}
    reader = _Reader(lines, plain)
    if lines and lines[0][1] != 0:
        raise YamlSubsetError("line {}: the top-level mapping is "
                              "indented".format(lines[0][0]))
    return reader.mapping(0, nested_ok=True)


def read(path, plain=resolve):
    """The mapping of the file at ``path``; an error names the file."""
    with open(path) as f:
        text = f.read()
    try:
        return loads(text, plain)
    except YamlSubsetError as e:
        raise type(e)("{}: {}".format(path, e)) from None


# -- the writer ---------------------------------------------------------------

def float_scalar(value):
    """A float as PyYAML's representer spells it."""
    if math.isnan(value):
        return ".nan"
    if math.isinf(value):
        return ".inf" if value > 0 else "-.inf"
    text = repr(float(value)).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def _plain_allowed(text):
    """PyYAML's emitter's test for a block plain scalar (one line of
    printable ASCII)."""
    if text.startswith(("---", "...")) or text[0] in "#,[]{}&*!|>'\"%@`":
        return False
    if text[0] in "?:-" and (len(text) == 1 or text[1] == " "):
        return False
    if text[0] == " " or text[-1] == " " or text.endswith(":"):
        return False
    return ": " not in text and " #" not in text


def str_scalar(value, where="value"):
    """A str as ``yaml.safe_dump`` writes it: plain where PyYAML writes
    it plain, else single-quoted."""
    if any(not ch.isprintable() for ch in value):
        raise YamlSubsetError(
            "{}: {!r} holds a character that is not printable".format(
                where, value))
    if (value and all(" " <= ch <= "~" for ch in value)
            and scalar_kind(value) == "str" and _plain_allowed(value)):
        return value
    return "'" + value.replace("'", "''") + "'"


def _scalar_text(value, where):
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        return float_scalar(value)
    if isinstance(value, str):
        return str_scalar(value, where)
    raise YamlSubsetError("{}: {!r} is not a str, int, float, bool or "
                          "None".format(where, value))


def _line(prefix, scalar):
    """One line; PyYAML would wrap a scalar with a space past the width."""
    if len(prefix) + len(scalar) > WIDTH and " " in scalar:
        raise YamlSubsetError("{!r} is longer than {} columns and would "
                              "wrap".format(prefix + scalar, WIDTH))
    return prefix + scalar


def _key_text(key, where):
    if isinstance(key, bool) or not isinstance(key, (str, int)):
        raise YamlSubsetError("{}: key {!r} is not a str or an int".format(
            where, key))
    text = _scalar_text(key, where)
    if isinstance(key, str) and text != key:
        raise YamlSubsetError("{}: key {!r} is not plain".format(where, key))
    return text


def _entries(mapping, indent, nested_ok):
    lines = []
    pad = " " * indent
    for key in sorted(mapping):
        name = _key_text(key, "key {!r}".format(key))
        value = mapping[key]
        where = "key {}".format(name)
        if isinstance(value, dict):
            if not nested_ok:
                raise YamlSubsetError("{}: a mapping nested deeper than one "
                                      "level".format(where))
            if not value:
                lines.append(pad + name + ": {}")
                continue
            lines.append(pad + name + ":")
            lines += _entries(value, indent + 2, nested_ok=False)
        elif isinstance(value, (list, tuple)):
            if not value:
                lines.append(pad + name + ": []")
                continue
            lines.append(pad + name + ":")
            lines += [_line(pad + "- ", _scalar_text(v, where))
                      for v in value]
        else:
            lines.append(_line(pad + name + ": ", _scalar_text(value, where)))
    return lines


def dumps(mapping):
    """``yaml.safe_dump(mapping, default_flow_style=False,
    sort_keys=True)``."""
    if not isinstance(mapping, dict):
        raise YamlSubsetError("a file holds a mapping, not {}".format(
            type(mapping).__name__))
    if not mapping:
        return "{}\n"
    return "\n".join(_entries(mapping, 0, nested_ok=True)) + "\n"


def write(path, mapping):
    text = dumps(mapping)
    with open(path, "w") as f:
        f.write(text)
