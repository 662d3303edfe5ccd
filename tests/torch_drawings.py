"""What matplotlib is asked to draw, recorded for the tests of the port's
PNGs against the JAX package's (``test_torch_plots*.py``).

``record(monkeypatch, root)`` patches the drawing calls both packages
make (``Axes.bar``, ``plot``, ``scatter``, ``imshow``, ``hist``,
``axvspan``, ``set_title``) to note their arguments, and
``Figure.savefig`` to file the notes under the figure's path (relative to
``root``, uuids masked) without writing it.  ``assert_same_drawings``
holds two records to each other: the same PNG paths, the same calls in
each, arrays within ``rtol`` of max(1, their largest magnitude) (NaN
where the other has NaN), other values equal.
"""
import os
import re

import matplotlib
import matplotlib.axes
import matplotlib.figure
import numpy as np

matplotlib.use("Agg")

UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                  r"[0-9a-f]{12}")
CALLS = ("bar", "plot", "scatter", "imshow", "hist", "axvspan", "set_title")


def _value(v):
    if isinstance(v, str) or v is None:
        return v
    if np.ndim(v) == 0 and not isinstance(v, (list, tuple)):
        return v
    return np.asarray(v)


def record(monkeypatch, root):
    """{PNG path relative to ``root``: [(call, args, kwargs)]}, filled as
    the figures are saved."""
    drawn, pending = {}, []
    for name in CALLS:
        def note(self, *args, _name=name, **kwargs):
            pending.append((_name, [_value(a) for a in args],
                            {k: _value(v) for k, v in kwargs.items()}))
        monkeypatch.setattr(matplotlib.axes.Axes, name, note)

    def savefig(self, path, **kwargs):
        rel = UUID.sub("<uuid>", os.path.relpath(str(path), str(root)))
        drawn.setdefault(rel, []).append(list(pending))
        pending.clear()

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", savefig)
    return drawn


def _same(got, want, rtol, where):
    if isinstance(want, np.ndarray) and want.dtype.kind in "fiu":
        got = np.asarray(got)
        assert got.shape == want.shape, where
        scale = max(1.0, float(np.nanmax(np.abs(want), initial=0.0)))
        np.testing.assert_allclose(got.astype(np.float64), want, rtol=0,
                                   atol=rtol * scale, err_msg=where)
    elif isinstance(want, np.ndarray):
        assert np.array_equal(np.asarray(got), want), where
    elif isinstance(want, float):
        assert abs(got - want) <= rtol * max(1.0, abs(want)), where
    else:
        assert got == want, where


def assert_same_drawings(got, want, rtol=1e-6):
    assert sorted(got) == sorted(want) and want
    for path, figures in want.items():
        assert len(got[path]) == len(figures), path
        for got_calls, want_calls in zip(got[path], figures):
            assert [c[0] for c in got_calls] == [c[0] for c in want_calls], \
                path
            for (name, g_args, g_kw), (_, w_args, w_kw) in zip(got_calls,
                                                              want_calls):
                where = "{} {}".format(path, name)
                assert len(g_args) == len(w_args) and g_kw.keys() == \
                    w_kw.keys(), where
                for g, w in zip(g_args, w_args):
                    _same(g, w, rtol, where)
                for k in w_kw:
                    _same(g_kw[k], w_kw[k], rtol, where + " " + k)
