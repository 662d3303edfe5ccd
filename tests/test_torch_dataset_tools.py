"""The port's dataset tools against the JAX package's, byte for byte:
``cli.create_datasets`` (its three commands on a synthetic cohort) and
``cli.anonymize_cohort`` (pandas' merge, dedup, date parsing and CSV
formatting redone with ``csv`` and ``datetime``), with pandas and PyYAML
blocked on the port's side; and ``utils.profiling``."""
import json
import os
import types

import pytest
import torch

import chip_smoke
from deepards_tpu.cli import anonymize_cohort as janon
from deepards_tpu.cli import create_datasets as jcreate
from deepards_tpu.utils import profiling as jprofiling
from deepards_tpu_torch.cli import anonymize_cohort as tanon
from deepards_tpu_torch.cli import create_datasets as tcreate
from deepards_tpu_torch.data.synthetic import generate_cohort
from deepards_tpu_torch.utils import profiling as tprofiling

torch.set_num_threads(1)

BLOCKED = ("pandas", "yaml", "pyarrow")


def _tree(root):
    """{relative path: file bytes, or the link's target} under ``root``."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        for name in dirnames + filenames:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if os.path.islink(path):
                out[rel] = "-> " + os.path.relpath(os.readlink(path), root)
            elif os.path.isfile(path):
                with open(path, "rb") as f:
                    out[rel] = f.read()
    return out


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("create")
    csv = generate_cohort(str(root / "cohort"), n_patients=12,
                          n_breaths_per_patient=120, seed=9)
    return str(root), str(root / "cohort"), csv


@pytest.mark.parametrize("command", [
    ["build-bm-corpus", "--n-clusters", "4", "--breaths-per-clust", "5"],
    ["build-bm-corpus"],
    ["build-contiguous", "--n-breaths", "50"],
])
def test_corpus_builders_write_the_jax_files(command, cohort, capsys):
    root, data, _ = cohort
    out = {}
    for name, module in (("jax", jcreate), ("port", tcreate)):
        path = os.path.join(root, "{}-{}".format(name, "-".join(command)))
        argv = command[:1] + ["-dp", data, "-o", path] + command[1:]
        if name == "port":
            with chip_smoke.blocked_modules(*BLOCKED):
                module.main(argv)
        else:
            module.main(argv)
        out[name] = _tree(path)
    assert out["port"] == out["jax"] and out["port"]
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == printed[1] and printed[0].startswith("wrote ")


def test_split_pretraining_links_the_jax_tree(cohort, tmp_path):
    root, data, csv = cohort
    trees = []
    for module in (jcreate, tcreate):
        copy = tmp_path / module.__name__.split(".")[0]
        exp = copy / "experiment1" / "all_data"
        exp.mkdir(parents=True)
        for kind in ("raw", "meta"):
            os.symlink(os.path.join(data, "experiment1", "all_data", kind),
                       str(exp / kind))
        # the cohort names half the patients
        with open(csv) as f:
            lines = f.read().splitlines()
        half = tmp_path / "half.csv"
        half.write_text("\n".join(lines[:7]) + "\n")
        if module is tcreate:
            with chip_smoke.blocked_modules(*BLOCKED):
                module.main(["split-pretraining", "-dp", str(copy), "-c",
                             str(half)])
        else:
            module.main(["split-pretraining", "-dp", str(copy), "-c",
                         str(half)])
        trees.append(_tree(str(copy / "experiment1")))
    assert trees[0] == trees[1]
    assert any(k.startswith("aim1_70_30_training/raw/") for k in trees[0])
    assert any(k.startswith("aim1_70_30_testing/raw/") for k in trees[0])


def test_split_pretraining_keeps_ids_as_spelled(tmp_path):
    """A cohort id of digits stays as the CSV spells it; the JAX
    package's pandas reads '0012' as 12, whose directory does not
    exist."""
    for module in (jcreate, tcreate):
        root = tmp_path / module.__name__.split(".")[0]
        for pt in ("0012", "0034"):
            (root / "experiment1" / "all_data" / "raw" / pt).mkdir(
                parents=True)
        cohort = tmp_path / "cohort.csv"
        cohort.write_text("Patient Unique Identifier,Pathophysiology\n"
                          "0012,ARDS\n")
        module.split_pretraining(str(root), str(cohort))
    testing = "experiment1/aim1_70_30_testing/raw"
    port = sorted(os.listdir(str(tmp_path / "deepards_tpu_torch" / testing)))
    jax = sorted(os.listdir(str(tmp_path / "deepards_tpu" / testing)))
    assert (port, jax) == (["0012"], [])


SHIFTS = ("patient_id,new_patient_id,shift_hours\n"
          "10,501,24.5\n2,502,-3\n1,503,100\n2,504,7\n7,505,1.25\n"
          "11,506,0\n")
COHORT = ("Patient Unique Identifier,Pathophysiology,"
          "Date when Berlin criteria first met (m/dd/yyy),vent_start_time,"
          "experiment_group\n"
          "1,ARDS,4/12/2015 13:45,4/12/2015 10:00,1\n"
          "2,COPD,,4/13/2015 09:30,1\n"
          "10,ARDS,5/01/2015 08:00,4/30/2015 22:15,1\n"
          "3,ARDS,5/02/2015 08:00,5/01/2015 22:15,1\n"
          "11,OTHER,,,1\n")


@pytest.mark.parametrize("shifts,cohort", [
    # a patient missing from the shift file (3), one missing from the
    # cohort (7), a duplicate (2), blank times, ids sorted as numbers
    (SHIFTS, COHORT),
    # ISO times, str ids (sorted as str)
    (SHIFTS.replace("\n1,", "\nP1,").replace("\n2,", "\nP2,")
     .replace("\n10,", "\nP10,"),
     COHORT.replace("\n1,", "\nP1,").replace("\n2,", "\nP2,")
     .replace("\n10,", "\nP10,").replace("4/12/2015 13:45",
                                         "2015-04-12 13:45:00")
     .replace("5/01/2015 08:00", "2015-05-01 08:00:00")
     .replace("5/02/2015 08:00", "2015-05-02 08:00:00")),
    # a numeric column made float by the merge (written 1.0)
    (SHIFTS, COHORT.replace(",ARDS,", ",1,").replace(",COPD,", ",0,")
     .replace(",OTHER,", ",0,")),
], ids=["numeric-ids", "str-ids-iso", "float-column"])
def test_anonymize_cohort_writes_the_jax_csv(shifts, cohort, tmp_path):
    (tmp_path / "shifts.csv").write_text(shifts)
    (tmp_path / "cohort.csv").write_text(cohort)
    args = [str(tmp_path / "shifts.csv"), str(tmp_path / "cohort.csv")]
    janon.anonymize_cohort(*args, str(tmp_path / "jax.csv"))
    with chip_smoke.blocked_modules(*BLOCKED):
        tanon.main(["--shift-file", args[0], "--non-anon-cohort-desc",
                    args[1], "-o", str(tmp_path / "port.csv")])
    want = (tmp_path / "jax.csv").read_bytes()
    assert (tmp_path / "port.csv").read_bytes() == want
    assert want.count(b"\n") == 6  # the header and 5 patients


def test_anonymize_cohort_refuses_what_pandas_refuses(tmp_path):
    """An int key against a str key, and a time that does not fit the
    column's first format, fail in both."""
    (tmp_path / "shifts.csv").write_text(SHIFTS)
    (tmp_path / "str_ids.csv").write_text(COHORT.replace("\n1,", "\nP1,"))
    (tmp_path / "mixed.csv").write_text(COHORT.replace(
        "4/13/2015 09:30", "2015-04-13 09:30:00"))
    for cohort in ("str_ids.csv", "mixed.csv"):
        args = [str(tmp_path / "shifts.csv"), str(tmp_path / cohort),
                str(tmp_path / "out.csv")]
        with pytest.raises(ValueError):
            janon.anonymize_cohort(*args)
        with pytest.raises(ValueError):
            tanon.anonymize_cohort(*args)


def test_step_timer_reports_as_the_jax_timer(monkeypatch):
    ticks = [0.0, 0.010, 0.030, 0.035, 0.045, 0.060]
    reports = []
    for module in (jprofiling, tprofiling):
        clock = iter(ticks)
        monkeypatch.setattr(module, "time", types.SimpleNamespace(
            perf_counter=lambda: next(clock)))
        timer = module.StepTimer()
        for _ in ticks:
            timer.tick()
        reports.append((timer.report(), timer.report(16)))
    assert reports[0] == reports[1]
    assert reports[1][0] == {"steps": 5, "mean_step_ms": pytest.approx(
        (0.005 + 0.010 + 0.015) / 3 * 1e3)}


def test_trace_writes_a_chrome_trace(tmp_path):
    timer = tprofiling.StepTimer(warmup=0)
    with tprofiling.trace(str(tmp_path / "trace")) as path:
        for step in range(3):
            with tprofiling.annotate("step{}".format(step)):
                torch.ones(64).sum()
            timer.tick()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") ==
             "user_annotation"}
    assert {"step0", "step1", "step2"} <= names
    assert timer.report()["steps"] == 2
