"""Split files: the subset of YAML that the cohort splitters write and read.

A split file is a flat mapping of keys to a list of str, one str or one
float, as ``deepards_tpu/cli/sim_dissim.py`` writes it with ``yaml.dump``
and ``cli/perform_data_splitting.py`` reads it.  This module writes and
reads that subset through ``config.yamlfile`` (no PyYAML): keys sorted,
lists in block style, a str quoted wherever YAML 1.1 would read it as
something else (so patient ids such as '0012' or '123' stay str), floats
as PyYAML spells them.  Anything outside the subset is refused with a
``SplitFileError``.
"""
import re

from deepards_tpu_torch.config import yamlfile

_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")
_DECIMAL = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")


class SplitFileError(yamlfile.YamlSubsetError):
    """A split file, or a mapping, outside the subset this module handles."""


def dumps(mapping):
    """The split-file text of ``mapping``: {key: list of str | str |
    float}."""
    if not isinstance(mapping, dict):
        raise SplitFileError("a split file holds a mapping, not {}".format(
            type(mapping).__name__))
    out = {}
    for key, value in mapping.items():
        if not isinstance(key, str) or not _KEY.match(key):
            raise SplitFileError("key {!r} is not an identifier".format(key))
        if isinstance(value, (list, tuple)):
            for v in value:
                if not isinstance(v, str):
                    raise SplitFileError("{}: {!r} is not a str".format(
                        key, v))
            out[key] = list(value)
        elif isinstance(value, str):
            out[key] = value
        elif isinstance(value, (int, float)) and not isinstance(value, bool):
            out[key] = float(value)
        else:
            raise SplitFileError(
                "{}: {!r} is not a list of str, a str or a float".format(
                    key, value))
    try:
        return yamlfile.dumps(out)
    except yamlfile.YamlSubsetError as e:
        raise SplitFileError(str(e)) from None


def write(path, mapping):
    text = dumps(mapping)
    with open(path, "w") as f:
        f.write(text)


def _plain(text, where):
    """A plain scalar of a split file: a str, or a float where YAML reads
    a decimal number."""
    kind = yamlfile.scalar_kind(text)
    if kind == "str":
        return text
    if (kind == "float" and ":" not in text) or (
            kind == "int" and _DECIMAL.match(text)):
        return float(yamlfile.resolve(text, where))
    raise SplitFileError(
        "{}: {!r} reads as neither a str nor a decimal number in "
        "YAML".format(where, text))


def loads(text):
    """The mapping of a split file's text."""
    try:
        mapping = yamlfile.loads(text, plain=_plain)
    except yamlfile.YamlSubsetError as e:
        raise SplitFileError(str(e)) from None
    for key, value in mapping.items():
        if not isinstance(key, str) or not _KEY.match(key):
            raise SplitFileError("key {!r} is not an identifier".format(key))
        if value is None:
            raise SplitFileError("key {} has no value".format(key))
        if isinstance(value, dict):
            raise SplitFileError("key {}: nested YAML is not a split "
                                 "file".format(key))
        if isinstance(value, list):
            for item in value:
                if not isinstance(item, str):
                    raise SplitFileError(
                        "key {}: list item {} reads as a number in YAML; a "
                        "split file lists str (quote it)".format(key, item))
    return mapping


def read(path):
    with open(path) as f:
        return loads(f.read())
