"""The port's experiment-file reader and writer (``config/yamlfile.py``)
and registry generator against PyYAML and the JAX package: every ``.yml``
under ``deepards_tpu/config/`` read as ``yaml.load``/``yaml.safe_load``
read it, planted scalars resolved as PyYAML's YAML 1.1 resolver does,
syntax outside the subset refused with its line, and the 228 generated
files written byte for byte as the JAX generator writes them."""
import glob
import math
import os
import sys

import pytest
import torch
import yaml

from deepards_tpu.cli import train as jtrain
from deepards_tpu.config import config as jconfig
from deepards_tpu.config import generate_experiments as jgen
from deepards_tpu_torch.cli import train as ttrain
from deepards_tpu_torch.config import config as tconfig
from deepards_tpu_torch.config import generate_experiments as tgen
from deepards_tpu_torch.config import yamlfile

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "deepards_tpu", "config")
GROUPS = {
    "hand_written": os.path.join(CONFIG, "experiment_files", "*.yml"),
    "generated": os.path.join(CONFIG, "experiment_files", "generated",
                              "*.yml"),
    "defaults": os.path.join(CONFIG, "defaults.yml"),
    "evaluate_config": os.path.join(CONFIG, "evaluate_config", "*.yml"),
}
# keys only the port's parser has (tests/test_torch_data_config.py)
PORT_ONLY = {"device", "siamese_time_layer"}


def same(a, b):
    """Equal values of equal types (NaN equal to NaN)."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_reader_equals_pyyaml_on_every_yml(group, monkeypatch):
    files = sorted(glob.glob(GROUPS[group]))
    assert files
    monkeypatch.setitem(sys.modules, "yaml", None)  # no fallback to PyYAML
    got = {f: yamlfile.read(f) for f in files}
    monkeypatch.undo()
    for f in files:
        with open(f) as fh:
            want = yaml.load(fh, Loader=yaml.FullLoader)
        with open(f) as fh:
            assert same(got[f], want) and same(got[f], yaml.safe_load(fh)), f
    if group == "generated":
        assert len(files) == 228


@pytest.mark.parametrize("scalar", [
    "1e-3", "1.0e-08", "0012", "yes", "~", "'0012'", "80_20_random",
    "1_000", "No", "ON", "off", "null", "NULL", "True", "-0.5", ".2", "1.",
    "+12", "-0", "0x1F", "0b101", "190:20:30", "1:30.5", ".inf", "-.INF",
    ".NaN", "1e+3", "1.5e3", "1.5e+3", "'yes'", '"a\\tb"', "'it''s'",
    "/fastdata/ardsdetection", "prototype_results/", "a:b", "-a",
    "anon-desc.csv", "value # a comment", "'quoted' # a comment", "[]",
    "'#'", '"\\u00fc"', "0o12", "1__0", "12e3",
])
def test_planted_scalars_resolve_as_pyyaml(scalar):
    text = "key: {}\n".format(scalar)
    want = yaml.safe_load(text)
    assert same(yamlfile.loads(text), want)
    assert same(yamlfile.loads(text), yaml.load(text,
                                                 Loader=yaml.FullLoader))


@pytest.mark.parametrize("text", [
    "a:\n- x\n- y\nb: 1\n",
    "a:\n  - x\n  - 'y'\nb: []\n",
    "---\n# a comment\na: 1  # trailing\n\nb: two\n",
    "models:\n  0:\n    - m0\n    - m1\n  1:\n  - m2\n  2: []\nnext: 3\n",
    "models:\n  0: a\n  x: 1\n",
    "a:\nb: 2\n",
    "{}\n",
])
def test_structures_read_as_pyyaml(text):
    assert same(yamlfile.loads(text), yaml.safe_load(text) or {})


@pytest.mark.parametrize("text,line,match", [
    ("a: 1\nb: &x 2\n", 2, "unsupported"),
    ("a: 1\nb: *x\n", 2, "unsupported"),
    ("a: 1\nb: {c: 1}\n", 2, "unsupported"),
    ("a: [1, 2]\n", 1, "unsupported"),
    ("a: !!str 1\n", 1, "unsupported"),
    ("a: |\n  x\n", 1, "unsupported"),
    ("a: >\n  x\n", 1, "unsupported"),
    ("a: b\n  c\n", 2, "unexpected indentation"),
    ("a: 2015-01-01\n", 1, "timestamp"),
    ("a: 1\na: 2\n", 2, "repeated"),
    ("a:\n  b:\n    c: 1\n", 3, "nested deeper"),
    ("a:\n\t- x\n", 2, "tab"),
    ("- x\n", 1, "outside a key"),
    ("a: 'x\n", 1, "single-quoted"),
    ("a: 'x' y\n", 1, "after a quoted"),
    ("a:\n- x\n  - y\n", 3, "list item"),
    ("a:\n-\n", 2, "empty or nested"),
    ("'a': 1\n", 1, "key: value"),
    ("yes: 1\n", 1, "resolves to"),
])
def test_outside_the_subset_raises_with_its_line(text, line, match):
    with pytest.raises(yamlfile.YamlSubsetError,
                       match=r"line {}\b.*{}".format(line, match)):
        yamlfile.loads(text)


def test_read_names_the_file(tmp_path):
    path = tmp_path / "bad.yml"
    path.write_text("a: 1\nb: [1]\n")
    with pytest.raises(yamlfile.YamlSubsetError,
                       match=r"bad\.yml: line 2"):
        yamlfile.read(str(path))


@pytest.mark.parametrize("value", [
    "x y", "a:b", "a: b", "a #b", "#a", "-a", "- a", "?a", "? a", ":a",
    "a:", "", " a", "a ", "0012", "12", "1.5", "yes", "null", "~", "o'brien",
    "2015-04-01", "2015-04-01 12:00:00", "=", "<<", "---a", "...", "a,b",
    "[a]", "{a}", "a[0]", "&a", "*a", "!a", "|", ">", "%a", "@a", "`a",
    "'a'", '"a"', "80_20_random", "1e-3", "a\\b", "a/b", "tcp://host:1",
])
def test_writer_equals_safe_dump(value):
    mapping = {"k": value, "items": [value, "x"], "n": None, "t": True,
               "f": 1.0e-08, "i": -3, "big": 1e20, "e": [], "nan": math.nan,
               "models": {0: [value], 1: [], 2: 7}}
    want = yaml.safe_dump(mapping, default_flow_style=False, sort_keys=True)
    assert yamlfile.dumps(mapping) == want
    assert same(yamlfile.loads(want), yaml.safe_load(want))


@pytest.mark.parametrize("mapping,match", [
    ([1], "mapping"), ({"a": {"b": {"c": 1}}}, "nested deeper"),
    ({"a": object()}, "not a str"), ({"a": "x\ny"}, "not printable"),
    ({"a: b": 1}, "not plain"), ({"k": "word " * 20}, "wrap"),
    ({(1,): 1}, "not a str or an int"),
])
def test_writer_refuses_other_content(mapping, match):
    with pytest.raises(yamlfile.YamlSubsetError, match=match):
        yamlfile.dumps(mapping)


def test_generator_equals_the_jax_generator(tmp_path):
    assert tgen.experiments() == jgen.experiments()
    assert tgen.reference_experiments() == jgen.reference_experiments()
    assert tgen.extra_experiments() == jgen.extra_experiments()
    got, want = tmp_path / "port", tmp_path / "jax"
    (got / "stale.yml").parent.mkdir()
    (got / "stale.yml").write_text("a: 1\n")
    assert tgen.write_all(str(got)) == jgen.write_all(str(want))
    names = sorted(os.listdir(str(want)))
    assert sorted(os.listdir(str(got))) == names and len(names) == 228
    committed = os.path.join(CONFIG, "experiment_files", "generated")
    for name in names:
        data = (got / name).read_bytes()
        assert data == (want / name).read_bytes(), name
        with open(os.path.join(committed, name), "rb") as f:
            assert data == f.read(), name


def test_every_registry_yml_gives_the_jax_configuration():
    """``cli.train -co`` of each hand-written and generated experiment
    file gives the JAX package's configuration, key by key."""
    files = sorted(glob.glob(GROUPS["hand_written"])
                   + glob.glob(GROUPS["generated"]))
    for f in files:
        argv = ["-co", f, "--data-path", "/data"]
        got = tconfig.Configuration(ttrain.build_parser().parse_args(argv))
        want = jconfig.Configuration(jtrain.build_parser().parse_args(argv))
        assert same({k: v for k, v in got.conf.items()
                     if k not in PORT_ONLY}, want.conf), f


def test_read_experiment_file_needs_no_pyyaml(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    conf = tconfig.read_experiment_file(os.path.join(
        CONFIG, "evaluate_config", "unpadded_centered_nb20_cnn_linear.yml"))
    assert conf["models"][0] == ["model-run-0-epoch1-fold0",
                                 "model-run-1-epoch1-fold0"]
    assert conf["oversample_minority"] is True
