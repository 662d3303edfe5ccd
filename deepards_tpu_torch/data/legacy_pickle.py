"""The reference's pickles without pandas and without the reference package.

The reference pickled whole objects (``deepards.dataset.ARDSRawDataset``,
``deepards.results.ModelCollection``) and pandas DataFrames
(``{time}_patient_results.pkl``, a dataset's cohort frame).  The JAX
package reads them through pandas; the port's ``LegacyUnpickler`` never
imports pandas or pyarrow:

- a ``deepards.*`` class becomes an empty stub whose instance takes the
  pickled attributes (``deepards_tpu/data/dataset.py:662-671``);
- pandas' ``DataFrame``, ``BlockManager``, ``_unpickle_block``,
  ``_new_Index``, ``Index`` and ``RangeIndex`` (and the numeric indexes of
  pandas < 2) become stubs that rebuild a frame as a ``Frame``: ordered
  columns of numpy arrays, each block's columns taken from its
  ``mgr_locs`` (a slice or an index array).  Both layouts of the block
  manager are read: the ``"0.14.1"`` state of pandas 0.14 to 2, and the
  ``BlockManager(blocks, axes)`` call of pandas 3;
- numpy 1's ``numpy.core`` names and numpy 2's ``numpy._core`` both load.

Any other pandas or pyarrow class (pandas 3's default
``ArrowStringArray``, a categorical, a datetime array) is kept as a
placeholder, and the frame that holds it raises ``LegacyPickleError``
naming the class and the column.  Unpickling runs code named by the
file: load only pickles from a trusted run.
"""
import pickle

import numpy as np

_NUMPY_CORE = ("numpy._core" if int(np.__version__.split(".")[0]) >= 2
               else "numpy.core")


class LegacyPickleError(ValueError):
    """A pickle this reader cannot decode."""


class _Stub(object):
    def __init__(self, *args, **kwargs):
        pass


class Foreign(object):
    """A pandas or pyarrow object this reader does not decode; ``name`` is
    its class as the pickle names it."""

    name = None

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


def _foreign(module, name):
    return type(name, (Foreign,), {"name": "{}.{}".format(module, name)})


class _Index(object):
    """pandas' Index (and Int64Index, UInt64Index, Float64Index)."""

    def __init__(self, data):
        self.values = data

    @classmethod
    def from_state(cls, d):
        return cls(d.get("data"))


class _RangeIndex(_Index):
    @classmethod
    def from_state(cls, d):
        return cls(np.arange(d["start"], d["stop"], d["step"]))


def _new_Index(cls, d):  # noqa: N802 - pandas' name
    if isinstance(cls, type) and issubclass(cls, _Index):
        return cls.from_state(d)
    return cls(d)


class _Block(object):
    def __init__(self, values, mgr_locs):
        self.values = values
        self.mgr_locs = mgr_locs


def _unpickle_block(values, mgr_locs, ndim=None):
    return _Block(values, mgr_locs)


class _BlockManager(object):
    """pandas' BlockManager: ``BlockManager(blocks, axes)`` (pandas 3) or
    an empty one given its ``"0.14.1"`` state (pandas 0.14 to 2)."""

    def __init__(self, blocks=(), axes=(), *args):
        self.blocks = list(blocks)
        self.axes = list(axes)

    def __setstate__(self, state):
        extra = state[3] if isinstance(state, tuple) and len(state) > 3 \
            else None
        if not isinstance(extra, dict) or "0.14.1" not in extra:
            raise LegacyPickleError(
                "a pandas BlockManager state without its '0.14.1' layout "
                "(pandas before 0.14)")
        layout = extra["0.14.1"]
        self.axes = list(layout["axes"])
        self.blocks = [_Block(b["values"], b["mgr_locs"])
                       for b in layout["blocks"]]


def _labels(axis):
    """The column labels of a frame's column index."""
    if not isinstance(axis, _Index):
        raise LegacyPickleError("the column index is a {}, which this "
                                "reader cannot decode".format(_name(axis)))
    if not isinstance(axis.values, np.ndarray):
        raise LegacyPickleError("the column index holds a {}, which this "
                                "reader cannot decode{}".format(
                                    _name(axis.values), _hint(axis.values)))
    return axis.values.tolist()


def _name(obj):
    return obj.name if isinstance(obj, Foreign) else type(obj).__name__


def _hint(obj):
    """How to write a frame of str columns this reader decodes."""
    if "String" in _name(obj):
        return " (pickle the frame with pandas' future.infer_string off)"
    return ""


def _positions(mgr_locs, n_columns):
    if isinstance(mgr_locs, slice):
        return list(range(*mgr_locs.indices(n_columns)))
    return [int(i) for i in np.asarray(mgr_locs).ravel()]


class Frame(object):
    """A pandas DataFrame as ordered columns of numpy arrays: ``columns``
    (the labels, in order), ``frame[label]`` (a column), ``rows()`` (a
    dict a row).  Made only by unpickling."""

    def __setstate__(self, state):
        manager = state.get("_mgr", state.get("_data"))
        if not isinstance(manager, _BlockManager):
            raise LegacyPickleError("a DataFrame whose data is a {}".format(
                _name(manager)))
        labels = _labels(manager.axes[0])
        columns = [None] * len(labels)
        for block in manager.blocks:
            at = _positions(block.mgr_locs, len(labels))
            names = [labels[i] for i in at]
            values = block.values
            if not isinstance(values, np.ndarray):
                raise LegacyPickleError(
                    "column(s) {} hold a {}, which this reader cannot "
                    "decode{}".format(", ".join(map(repr, names)),
                                      _name(values), _hint(values)))
            values = values.reshape(len(at), -1)
            for row, i in enumerate(at):
                columns[i] = values[row]
        if any(c is None for c in columns):
            raise LegacyPickleError("a DataFrame whose blocks miss columns")
        self.columns = labels
        self.data = dict(zip(labels, columns))

    def __contains__(self, label):
        return label in self.data

    def __getitem__(self, label):
        return self.data[label]

    def rows(self, columns=None):
        """A dict of Python values a row, over ``columns`` (default:
        all)."""
        columns = self.columns if columns is None else columns
        values = [self.data[c].tolist() for c in columns]
        return [dict(zip(columns, row)) for row in zip(*values)]


#: what a pandas class or function of a pickle becomes
_PANDAS = {
    "DataFrame": Frame,
    "BlockManager": _BlockManager,
    "_unpickle_block": _unpickle_block,
    "_new_Index": _new_Index,
    "Index": _Index,
    "Int64Index": _Index,
    "UInt64Index": _Index,
    "Float64Index": _Index,
    "RangeIndex": _RangeIndex,
}


class LegacyUnpickler(pickle.Unpickler):
    """Stubs for ``deepards.*`` and pandas, numpy's names of either major
    version; nothing of pandas or pyarrow is imported."""

    def find_class(self, module, name):
        if module.startswith("deepards"):
            return type(name, (_Stub,), {})
        root = module.split(".")[0]
        if root == "pandas" and name in _PANDAS:
            return _PANDAS[name]
        if root in ("pandas", "pyarrow"):
            return _foreign(module, name)
        for core in ("numpy.core", "numpy._core"):
            if module == core or module.startswith(core + "."):
                module = _NUMPY_CORE + module[len(core):]
                break
        return super().find_class(module, name)


def load(path):
    """The object pickled at ``path``."""
    with open(path, "rb") as f:
        return LegacyUnpickler(f).load()


def load_frame(path):
    """The DataFrame pickled at ``path``, as a ``Frame``."""
    frame = load(path)
    if not isinstance(frame, Frame):
        raise LegacyPickleError("{} holds a {}, not a DataFrame".format(
            path, _name(frame)))
    return frame
