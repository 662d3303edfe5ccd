"""The port's configuration, CLI flags, synthetic cohort, time parsing and
k-fold splits against the JAX package (and scikit-learn), exactly."""
import filecmp
import os

import numpy as np
import pytest
import yaml
from sklearn.model_selection import StratifiedKFold

import chip_smoke
from deepards_tpu.cli import train as jtrain
from deepards_tpu.config import config as jconfig
from deepards_tpu.data import sampling as jsampling
from deepards_tpu.data import synthetic as jsynthetic
from deepards_tpu_torch.cli import train as ttrain
from deepards_tpu_torch.config import config as tconfig
from deepards_tpu_torch.data import dataset as tdataset
from deepards_tpu_torch.data import sampling as tsampling
from deepards_tpu_torch.data import synthetic as tsynthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG1 = os.path.join(ROOT, "deepards_tpu", "config", "experiment_files",
                       "unpadded_centered_nb20_cnn_linear.yml")
# keys only the port's parser has: the device, and siamese_pretrained's
# time layer, which the JAX package reads from a yml only (the card's
# machine has no PyYAML)
PORT_ONLY = {"device", "siamese_time_layer"}


def _conf(module, parser_module, argv):
    return module.Configuration(parser_module.build_parser().parse_args(
        argv)).conf


def test_defaults_equal_defaults_yml():
    path = os.path.join(ROOT, "deepards_tpu", "config", "defaults.yml")
    with open(path) as f:
        assert tconfig.DEFAULTS == yaml.load(f, Loader=yaml.FullLoader)
    assert tconfig.load_defaults() == jconfig.load_defaults()


def test_config1_yml_gives_the_jax_configuration():
    argv = ["-co", CONFIG1, "--data-path", "/data", "--seed", "3"]
    got = _conf(tconfig, ttrain, argv)
    want = _conf(jconfig, jtrain, argv)
    assert {k: v for k, v in got.items() if k not in PORT_ONLY} == want
    assert got["device"] is None  # resolves to the card


def test_precedence_cli_over_yml_over_defaults(tmp_path):
    yml = tmp_path / "exp.yml"
    yml.write_text("epochs: 3\nbatch_size: 8\nclip_grad: true\n")
    argv = ["-co", str(yml), "--epochs", "7"]
    for module, parser in ((tconfig, ttrain), (jconfig, jtrain)):
        conf = _conf(module, parser, argv)
        assert conf["epochs"] == 7 and conf["batch_size"] == 8
        assert conf["clip_grad"] is True and conf["kfolds"] is None
        assert conf["learning_rate"] == 0.001
    overrides = tconfig.Configuration(overrides={"epochs": 1})
    assert overrides.epochs == 1 and overrides.get("missing", 5) == 5


def test_chip_smoke_flags_give_config1():
    """chip_smoke.py's flags give config 1's configuration, apart from
    epochs and the paths; a bool flag left unset (None) reads as the
    yml's false."""
    paths = ["--data-path", "/d", "--cohort-file", "/d/c.csv",
             "--results-dir", "/r", "--save-model", "m.pt",
             "--saved-models-dir", "/s", "--device", "cuda"]
    got = _conf(tconfig, ttrain,
                chip_smoke.CONFIG1_FLAGS + ["--epochs", "2"] + paths)
    want = _conf(tconfig, ttrain, ["-co", CONFIG1] + paths)
    assert got.pop("epochs") == 2 and want.pop("epochs") == 10
    got.pop("config_override")
    want.pop("config_override")
    for key in set(got) | set(want):
        a, b = got.get(key), want.get(key)
        if isinstance(a, bool) or isinstance(b, bool):
            assert bool(a) == bool(b), key
        else:
            assert a == b, key


def test_cli_keeps_the_jax_flag_surface():
    def options(parser):
        return {opt: action.dest for action in parser._actions
                for opt in action.option_strings}

    port = options(ttrain.build_parser())
    jax_flags = options(jtrain.build_parser())
    assert {k: v for k, v in port.items() if v not in PORT_ONLY} == jax_flags
    assert port["--device"] == "device"
    assert port["--siamese-time-layer"] == "siamese_time_layer"


def test_cli_refuses_platform_tpu():
    with pytest.raises(SystemExit):
        ttrain.main(["--platform", "tpu"])


def test_synthetic_cohorts_are_equal(tmp_path):
    kw = dict(n_patients=3, n_breaths_per_patient=150, seed=11,
              subdirs=("all_data", "aim1_70_30_training"))
    jcsv = jsynthetic.generate_cohort(str(tmp_path / "jax"), **kw)
    tcsv = tsynthetic.generate_cohort(str(tmp_path / "port"), **kw)
    with open(jcsv, "rb") as f, open(tcsv, "rb") as g:
        assert f.read() == g.read()
    for sub in ("all_data/raw", "aim1_70_30_training/raw"):
        for pt in ("1", "2", "3"):
            rel = os.path.join("experiment1", sub, pt)
            files = sorted(os.listdir(tmp_path / "jax" / rel))
            assert files == sorted(os.listdir(tmp_path / "port" / rel))
            for name in files:
                assert filecmp.cmp(tmp_path / "jax" / rel / name,
                                   tmp_path / "port" / rel / name,
                                   shallow=False), (rel, name)


def test_time_parsing():
    parse = tdataset._parse_cohort_time
    assert parse("2017-01-01 00:00:00") == parse("1/1/2017 00:00")
    assert parse("2017-03-05 12:30:00") == parse("3/5/2017 12:30:00")
    assert parse("3/5/2017").hour == 0
    for bad in ("yesterday", "2017/03/05 12:30", "2017-01-01T00:00:00+02:00"):
        with pytest.raises(ValueError):
            parse(bad)
    a = tdataset._parse_abs_bs("2017-01-01 00-00-02.340000")
    assert a == tdataset._parse_abs_bs(b"2017-01-01 00:00:02.340000")
    assert a.microsecond == 340000
    with pytest.raises(ValueError):
        tdataset._parse_abs_bs("02.34 s")


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("counts", [(5, 5), (6, 7), (13, 4), (30, 22)])
def test_stratified_kfold_matches_sklearn(shuffle, counts):
    by_class = {0: ["o{}".format(i) for i in range(counts[0])],
                1: ["a{}".format(i) for i in range(counts[1])]}
    got = tsampling.stratified_patient_kfold(by_class, 5, shuffle=shuffle,
                                             seed=42)
    want = jsampling.stratified_patient_kfold(by_class, 5, shuffle=shuffle,
                                              seed=42)
    assert got.keys() == want.keys()
    for k in want:
        for part in ("train", "test"):
            assert got[k][part].tolist() == want[k][part].tolist()
    y = np.array([0] * counts[0] + [1] * counts[1])
    skf = StratifiedKFold(5, shuffle=shuffle,
                          random_state=42 if shuffle else None)
    folds = np.empty(len(y), int)
    for k, (_, test) in enumerate(skf.split(y, y)):
        folds[test] = k
    assert tsampling.stratified_kfold_test_folds(
        y, 5, shuffle, 42).tolist() == folds.tolist()


def test_stratified_kfold_refuses_too_few_members():
    with pytest.raises(ValueError):
        tsampling.stratified_kfold_test_folds(np.array([0, 0, 1, 1]), 5)
    with pytest.raises(ValueError):
        tsampling.stratified_kfold_test_folds(np.array([0] * 4 + [1] * 4), 5)


@pytest.mark.parametrize("name", ["oversample_minority", "oversample_all",
                                  "bootstrap_split"])
def test_resamplers_draw_the_same_indexes(name):
    labels = np.array([0] * 9 + [1] * 4)
    idx = np.arange(100, 113)
    args = {
        "oversample_minority": (idx, labels),
        "oversample_all": (idx, labels, 1.7),
        "bootstrap_split": ({0: ["a", "b", "c", "d", "e"],
                             1: ["f", "g", "h", "i", "j"]},),
    }[name]
    got = getattr(tsampling, name)(*args, np.random.default_rng(5))
    want = getattr(jsampling, name)(*args, np.random.default_rng(5))
    if name == "bootstrap_split":
        got, want = got[0], want[0]
        assert {k: v.tolist() for k, v in got.items()} == {
            k: v.tolist() for k, v in want.items()}
    else:
        assert got.tolist() == want.tolist()
