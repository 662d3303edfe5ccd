"""Synthetic ventilator-waveform cohort generator.

Counterpart of ``deepards_tpu/data/synthetic.py`` on the standard library
(``datetime``, ``csv``) in place of pandas.  For the same seed it writes
the same breath files and the same cohort CSV: the on-disk layout is
``<data_path>/experiment<N>/<subdir>/raw/<patient>/<file>.raw.npy`` plus a
cohort CSV.

Waveforms are physiologically shaped: a half-sine inspiratory limb
followed by an exponential-decay expiratory limb, with class-dependent
timing and compliance so ARDS / non-ARDS are learnably separable.
"""
import csv
import datetime
import os

import numpy as np

from deepards_tpu_torch.data.reader import write_processed_file

COHORT_COLUMNS = [
    "Patient Unique Identifier",
    "Pathophysiology",
    "Date when Berlin criteria first met (m/dd/yyy)",
    "vent_start_time",
    "experiment_group",
]

_BASE_TIME = datetime.datetime(2017, 1, 1)


def _ns(seconds):
    """Nanoseconds of a float number of seconds, truncated, as
    ``pandas.Timedelta(seconds=...)`` counts them."""
    return int(seconds * 1_000_000_000)


def _abs_bs(offset_ns):
    """Timestamp string of the base time plus ``offset_ns``, at
    microsecond resolution (nanoseconds truncated, as pandas formats)."""
    t = _BASE_TIME + datetime.timedelta(microseconds=offset_ns // 1000)
    return t.strftime("%Y-%m-%d %H-%M-%S.%f")


def synth_breath(rng, is_ards, dt=0.02):
    """One synthetic breath: (flow, pressure) float arrays in l/min, cmH2O."""
    # ARDS: faster, shallower breaths (lower compliance -> low tv, high RR)
    if is_ards:
        i_len = int(rng.uniform(30, 45))
        e_len = int(rng.uniform(45, 75))
        peak = rng.uniform(25, 40)
        decay = rng.uniform(8.0, 12.0)
    else:
        i_len = int(rng.uniform(45, 65))
        e_len = int(rng.uniform(75, 120))
        peak = rng.uniform(40, 60)
        decay = rng.uniform(4.0, 7.0)
    t_i = np.linspace(0, np.pi, i_len)
    insp = peak * np.sin(t_i)
    t_e = np.arange(e_len) * dt
    exp_peak = peak * rng.uniform(0.8, 1.1)
    expir = -exp_peak * np.exp(-decay * t_e)
    flow = np.concatenate([insp, expir])
    flow += rng.normal(0, 0.5, len(flow))
    pip = rng.uniform(25, 35) if is_ards else rng.uniform(15, 25)
    peep = rng.uniform(8, 12) if is_ards else rng.uniform(4, 6)
    pressure = np.concatenate([
        peep + (pip - peep) * np.sin(t_i / 2),
        peep + (pip - peep) * np.exp(-decay * t_e),
    ])
    return flow.astype(np.float32), pressure.astype(np.float32)


def generate_patient(rng, patient_id, is_ards, n_breaths,
                     vent_bn_gap_prob=0.02):
    """Generate one patient's breath list with realistic vent_bn gaps."""
    breaths = []
    vent_bn = int(rng.integers(1, 1000))
    t_ns = 0  # offset from the base time
    for rel_bn in range(1, n_breaths + 1):
        flow, pressure = synth_breath(rng, is_ards)
        breaths.append({
            "flow": flow,
            "pressure": pressure,
            "rel_bn": rel_bn,
            "vent_bn": vent_bn,
            "abs_bs": _abs_bs(t_ns),
        })
        t_ns += _ns(len(flow) * 0.02)
        vent_bn += 1
        if rng.random() < vent_bn_gap_prob:
            # simulated missing breaths (exercise the dropped-frame rule)
            gap = int(rng.integers(5, 40))
            vent_bn += gap
            t_ns += _ns(gap * 2.0)
    return breaths


def generate_cohort(
    data_path,
    n_patients=10,
    n_breaths_per_patient=400,
    experiment_num=1,
    seed=42,
    subdirs=("all_data",),
    cohort_file=None,
):
    """Write a full synthetic cohort to ``data_path``.

    Returns the path of the cohort CSV.  Patients alternate ARDS / OTHER.
    For holdout subdirs ('aim1_70_30_training' etc.) the same patients are
    symlinked rather than regenerated.
    """
    rng = np.random.default_rng(seed)
    rows = []
    primary = subdirs[0]
    exp_dir = os.path.join(data_path, "experiment{}".format(experiment_num))
    raw_dir = os.path.join(exp_dir, primary, "raw")
    meta_dir = os.path.join(exp_dir, primary, "meta")
    os.makedirs(raw_dir, exist_ok=True)
    os.makedirs(meta_dir, exist_ok=True)

    start = _BASE_TIME.strftime("%Y-%m-%d %H:%M:%S")
    for p in range(n_patients):
        patient_id = str(p + 1)
        is_ards = p % 2 == 1
        pt_raw = os.path.join(raw_dir, patient_id)
        os.makedirs(pt_raw, exist_ok=True)
        os.makedirs(os.path.join(meta_dir, patient_id), exist_ok=True)
        breaths = generate_patient(
            rng, patient_id, is_ards, n_breaths_per_patient
        )
        fname = os.path.join(pt_raw, "{}-vwd-1.raw.npy".format(patient_id))
        write_processed_file(breaths, fname)
        rows.append([
            patient_id,
            "ARDS" if is_ards else "COPD",
            start if is_ards else "",
            start,
            experiment_num,
        ])

    for sub in subdirs[1:]:
        sub_dir = os.path.join(exp_dir, sub)
        os.makedirs(sub_dir, exist_ok=True)
        for kind in ("raw", "meta"):
            dst = os.path.join(sub_dir, kind)
            src = os.path.abspath(os.path.join(exp_dir, primary, kind))
            if not os.path.exists(dst):
                os.symlink(src, dst)

    if cohort_file is None:
        cohort_file = os.path.join(data_path, "cohort-description.csv")
    with open(cohort_file, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(COHORT_COLUMNS)
        writer.writerows(rows)
    return cohort_file
