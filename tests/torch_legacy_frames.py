"""Pickles as the reference's pandas (0.14 to 2) and numpy 1 wrote them,
made without either: stand-in classes pickled with protocol 2, whose
module names are then rewritten to pandas' and numpy 1's.

A frame is pickled as ``DataFrame`` with the state ``{"_data":
BlockManager, ...}``, the manager with its ``"0.14.1"`` state (one block a
dtype, its columns as a slice where they are contiguous, else an index
array) and its axes through ``_new_Index``.  pandas still reads this
layout, so a test can hold both readers to the same file.
"""
import copyreg
import pickle
import sys
import types

import numpy as np

_MODULE = "torch_legacy_frames_standins"
_RENAMES = {
    "DataFrame": "pandas.core.frame",
    "BlockManager": "pandas.core.internals.managers",
    "_new_Index": "pandas.core.indexes.base",
    "Index": "pandas.core.indexes.base",
    "RangeIndex": "pandas.core.indexes.range",
}


def _standins():
    module = types.ModuleType(_MODULE)

    def reduce_ex(self, protocol):
        return copyreg.__newobj__, (type(self),), self.state

    for name in ("DataFrame", "BlockManager", "Index", "RangeIndex"):
        cls = type(name, (object,), {"__reduce_ex__": reduce_ex,
                                     "__module__": _MODULE})
        setattr(module, name, cls)

    def _new_Index(cls, d):  # noqa: N802 - pandas' name
        raise AssertionError("stand-ins are written, not read")

    _new_Index.__module__ = _MODULE
    _new_Index.__qualname__ = "_new_Index"
    module._new_Index = _new_Index
    return module


class _Axis:
    """Pickles as ``_new_Index(cls, d)``."""

    def __init__(self, module, cls, d):
        self.args = (getattr(module, cls), d)
        self.new = module._new_Index

    def __reduce__(self):
        return self.new, self.args


def _blocks(columns):
    """One block a dtype, in order of first appearance: (values (k, n),
    mgr_locs)."""
    by_dtype = {}
    for i, values in enumerate(columns.values()):
        by_dtype.setdefault(np.asarray(values).dtype.str, []).append(i)
    names = list(columns)
    blocks = []
    for positions in by_dtype.values():
        values = np.stack([np.asarray(columns[names[i]])
                           for i in positions])
        if positions == list(range(positions[0], positions[-1] + 1)):
            locs = slice(positions[0], positions[-1] + 1, 1)
        else:
            locs = np.asarray(positions, np.int64)
        blocks.append({"values": values, "mgr_locs": locs})
    return blocks


def frame_bytes(columns, index=None):
    """The pickle of a DataFrame of ``columns`` ({label: 1-D values},
    object-dtype str columns as numpy object arrays) as pandas 0.14-2 and
    numpy 1 wrote it; ``index``: row labels (default a RangeIndex)."""
    module = _standins()
    n = len(next(iter(columns.values())))
    column_axis = _Axis(module, "Index", {
        "data": np.asarray(list(columns), dtype=object), "name": None})
    row_axis = (_Axis(module, "RangeIndex", {"name": None, "start": 0,
                                             "stop": n, "step": 1})
                if index is None else _Axis(module, "Index", {
                    "data": np.asarray(index), "name": None}))
    axes = [column_axis, row_axis]
    blocks = _blocks(columns)
    manager = module.BlockManager()
    manager.state = (axes, [b["values"] for b in blocks], [], {
        "0.14.1": {"axes": axes, "blocks": blocks}})
    frame = module.DataFrame()
    frame.state = {"_data": manager, "_typ": "dataframe", "_metadata": []}
    sys.modules[_MODULE] = module
    try:
        data = pickle.dumps(frame, protocol=2)
    finally:
        del sys.modules[_MODULE]
    for name, target in _RENAMES.items():
        data = data.replace("c{}\n{}\n".format(_MODULE, name).encode(),
                            "c{}\n{}\n".format(target, name).encode())
    data = data.replace(b"cnumpy._core.multiarray\n",
                        b"cnumpy.core.multiarray\n")
    assert _MODULE.encode() not in data
    return data


def stand_in_modules(name, classes):
    """Install stand-in ``deepards`` and ``deepards.<name>`` modules with
    ``classes`` (class names); returns (the classes by name, a function
    that removes the modules)."""
    top = types.ModuleType("deepards")
    sub = types.ModuleType("deepards." + name)
    made = {}
    for cls_name in classes:
        cls = type(cls_name, (object,), {"__module__": "deepards." + name})
        setattr(sub, cls_name, cls)
        made[cls_name] = cls
    setattr(top, name, sub)
    saved = {k: sys.modules.get(k) for k in ("deepards", "deepards." + name)}
    sys.modules.update({"deepards": top, "deepards." + name: sub})

    def remove():
        for key, module in saved.items():
            if module is None:
                sys.modules.pop(key, None)
            else:
                sys.modules[key] = module

    return made, remove
