"""Rewrite a cohort CSV after dataset anonymization.

Counterpart of ``deepards_tpu/cli/anonymize_cohort.py`` (reference:
deepards/redo_cohort_desc_after_anonymization.py) on ``csv`` and
``datetime``, no pandas: merge the anonymization shift file
(patient_id -> new_patient_id, shift_hours) into the non-anonymized
cohort description, shift the Berlin-criteria and vent-start timestamps
by each patient's time shift, and write a fresh cohort CSV keyed by the
anonymous ids.  The output is the JAX package's byte for byte, so the
port keeps what its pandas calls do:

- ``read_csv`` reads a column of ints as ints, of numbers as floats
  (ints with a blank cell too), else as str; blank cells and pandas' NA
  spellings are missing;
- ``merge(how="outer")`` joins on ``patient_id`` and sorts the keys
  (numbers by value, str as str; a number against a str raises), pairs
  every left row with every right row of its key, and leaves a row
  matched on one side blank on the other, which makes an int column of
  the other side float;
- ``drop_duplicates`` keeps a patient's first row;
- ``to_datetime`` takes its format from the first value of the column
  and holds every other value to it; a blank time stays blank;
- ``to_csv(index=False)`` writes ints as ints, floats as Python spells
  them (an int column made float by the merge as ``7.0``) and a missing
  value as an empty cell.

  python -m deepards_tpu_torch.cli.anonymize_cohort --shift-file S.csv \\
      --non-anon-cohort-desc C.csv [-o anon-desc.csv]
"""
import argparse
import csv
import datetime

PT_COL = "Patient Unique Identifier"
ARDS_TIME_COL = "Date when Berlin criteria first met (m/dd/yyy)"
OTHER_TIME_COL = "vent_start_time"
OUT_FMT = "%Y-%m-%d %H:%M:%S"
# pandas' default NA spellings (read_csv's na_values)
NA_VALUES = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN",
             "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN",
             "None", "n/a", "nan", "null"}
# the formats to_datetime can take from a column's first value
TIME_FORMATS = ("%Y-%m-%d %H:%M:%S", "%Y-%m-%d %H:%M:%S.%f",
                "%Y-%m-%dT%H:%M:%S", "%Y-%m-%d %H:%M", "%Y-%m-%d",
                "%m/%d/%Y %H:%M:%S", "%m/%d/%Y %H:%M", "%m/%d/%Y",
                "%m/%d/%y %H:%M:%S", "%m/%d/%y %H:%M", "%m/%d/%y")


def _number(text, cast):
    try:
        return cast(text)
    except ValueError:
        return None


def _column(cells):
    """(kind, values) of a column's cells as read_csv types them: 'int',
    'float' or 'str', a missing cell None."""
    present = [c for c in cells if c is not None]
    for kind, cast in (("int", int), ("float", float)):
        if all(_number(c, cast) is not None for c in present):
            if kind == "int" and len(present) < len(cells):
                kind, cast = "float", float
            return kind, [None if c is None else cast(c) for c in cells]
    return "str", list(cells)


def read_table(path):
    """(column names, {name: kind}, rows of {name: value}) of a CSV."""
    with open(path, newline="") as f:
        lines = [row for row in csv.reader(f) if row]
    header, body = lines[0], lines[1:]
    kinds, columns = {}, {}
    for i, name in enumerate(header):
        cells = [row[i] if i < len(row) else "" for row in body]
        kinds[name], columns[name] = _column(
            [None if c in NA_VALUES else c for c in cells])
    rows = [{name: columns[name][j] for name in header}
            for j in range(len(body))]
    return header, kinds, rows


def _key_order(key, kind):
    """Sort order of a merge key, a missing key last."""
    return (key is None, key if key is not None else (0 if kind != "str"
                                                      else ""))


def outer_merge(left, right, on):
    """``left.merge(right, on=on, how="outer")`` of two ``read_table``
    results."""
    lnames, lkinds, lrows = left
    rnames, rkinds, rrows = right
    numeric = ("int", "float")
    if (lkinds[on] in numeric) != (rkinds[on] in numeric):
        raise ValueError("You are trying to merge on {} and {} columns for "
                         "key '{}'".format(lkinds[on], rkinds[on], on))
    names = lnames + [n for n in rnames if n != on]
    kinds = dict(rkinds, **lkinds)
    by_key = {}
    for side, rows in ((0, lrows), (1, rrows)):
        for row in rows:
            by_key.setdefault(row[on], ([], []))[side].append(row)
    merged = []
    for key in sorted(by_key, key=lambda k: _key_order(k, kinds[on])):
        lefts, rights = by_key[key]
        for lrow in lefts or [None]:
            for rrow in rights or [None]:
                row = dict.fromkeys(names)
                row.update(rrow or {})
                row.update(lrow or {})
                row[on] = key
                merged.append(row)
    for side_names, rows in ((lnames, lrows), (rnames, rrows)):
        for name in side_names:
            if kinds[name] == "int" and any(row[name] is None
                                            for row in merged):
                kinds[name] = "float"  # a blank cell makes the column float
                for row in merged:
                    if row[name] is not None:
                        row[name] = float(row[name])
    return names, kinds, merged


def to_datetime(values):
    """Each value parsed with the format of the column's first value
    (None stays None)."""
    present = [v for v in values if v is not None]
    if not present:
        return list(values)
    first = str(present[0])
    for fmt in TIME_FORMATS:
        try:
            datetime.datetime.strptime(first, fmt)
        except ValueError:
            continue
        break
    else:
        raise ValueError("no time format fits {!r}".format(first))
    return [None if v is None else datetime.datetime.strptime(str(v), fmt)
            for v in values]


def _cell(value, kind):
    if value is None:
        return ""
    if kind == "float":
        return repr(float(value))
    return str(value)


def anonymize_cohort(shift_file, cohort_file, out_path="anon-desc.csv"):
    shifts = read_table(shift_file)
    names, kinds, rows = read_table(cohort_file)
    cohort = ([("patient_id" if n == PT_COL else n) for n in names],
              {("patient_id" if n == PT_COL else n): k
               for n, k in kinds.items()},
              [{("patient_id" if n == PT_COL else n): v
                for n, v in row.items()} for row in rows])
    _, kinds, merged = outer_merge(shifts, cohort, "patient_id")
    merged = [row for row in merged if row["new_patient_id"] is not None]
    seen, kept = set(), []
    for row in merged:
        if row["patient_id"] not in seen:
            seen.add(row["patient_id"])
            kept.append(row)
    for col in (OTHER_TIME_COL, ARDS_TIME_COL):
        for row, when in zip(kept, to_datetime([r[col] for r in kept])):
            hours = row["shift_hours"]
            row[col] = (None if when is None or hours is None else (
                when + datetime.timedelta(hours=float(hours))).strftime(
                    OUT_FMT))
    with open(out_path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow([PT_COL, ARDS_TIME_COL, OTHER_TIME_COL,
                         "Pathophysiology"])
        for row in kept:
            writer.writerow([
                int(row["new_patient_id"]), _cell(row[ARDS_TIME_COL], "str"),
                _cell(row[OTHER_TIME_COL], "str"),
                _cell(row["Pathophysiology"], kinds["Pathophysiology"])])
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser(prog="deepards-anonymize-cohort-torch")
    parser.add_argument("--shift-file", required=True)
    parser.add_argument("--non-anon-cohort-desc", required=True)
    parser.add_argument("-o", "--output", default="anon-desc.csv")
    args = parser.parse_args(argv)
    path = anonymize_cohort(args.shift_file, args.non_anon_cohort_desc,
                            args.output)
    print("wrote", path)


if __name__ == "__main__":
    main()
