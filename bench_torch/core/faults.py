"""Faults planted under a run, by the benchmark's tests on the CPU and by
faults.py at a cell's own size on the card. Each breaks the timed path in
one way, and the cell's output check has to come out not correct.

- `answer_altered`, `half_the_batch`: wrap a fault point of the program,
  a function whose first outputs are per-frame answers: the check's
  `FAULT_AT`, or the point of one of its `TIER_FAULTS`;
- `y_record_from_x`, `box_b_from_gamma`: wrap the program's DCD reader
  (`streaming.LazyDCD.read`), for the cells whose traffic reads a file."""

from __future__ import annotations

import importlib

import numpy as np
import torch


def altered(out):
    """An answer altered where it is produced: the first value of the first
    frame that is an answer moved by a tenth of its size or more. -1 is no
    answer: the angle kernel marks its empty slots so, and -1 * 1.1 + 0.1
    would leave one unchanged."""
    first = out[0]
    if isinstance(first, torch.Tensor):
        first = first.clone()
        flat = first.view(-1)
        i = int(torch.nonzero(flat != -1)[0])
        flat[i] = flat[i] * 1.1 + (0.1 if first.is_floating_point() else 1)
    else:
        first = first.copy()
        i = int(np.flatnonzero(first.reshape(-1) != -1)[0])
        first.flat[i] = first.flat[i] * 1.1 + 0.1
    return (first, *out[1:])


def half(out):
    """Half of the batch left out: the second half of the frames a copy of
    the first, so the statistics are taken over the rest."""
    def fold(t):
        t = t.clone() if isinstance(t, torch.Tensor) else t.copy()
        if t.ndim == 0 or t.shape[0] < 2:
            return t
        h = t.shape[0] // 2
        t[h:2 * h] = t[:h]
        return t
    return tuple(fold(t) for t in out[:2]) + tuple(out[2:])


def y_from_x(pos, boxes):
    """The Y record read where the X record is."""
    pos = pos.copy()
    pos[:, :, 1] = pos[:, :, 0]
    return pos, boxes


def b_from_gamma(pos, boxes):
    """The unit cell's B edge read from gamma (90 degrees)."""
    boxes = boxes.copy()
    boxes[:, 1] = 90.0
    return pos, boxes


AT_POINT = {"answer_altered": altered, "half_the_batch": half}
IN_READER = {"y_record_from_x": y_from_x, "box_b_from_gamma": b_from_gamma}


def points(check) -> dict:
    """The check's fault points by tier: "" for `FAULT_AT`, which the tiny
    CPU cells take, and each of its `TIER_FAULTS` (tier: {"at": (module,
    attr), "force": (module, attr) of the predicate that picks the tier})."""
    return {"": {"at": check.FAULT_AT}, **getattr(check, "TIER_FAULTS", {})}


def plant(fault: str, at=None, set_attr=setattr) -> list:
    """Plant `fault`: at `at` (module, attr) for one of AT_POINT, in the DCD
    reader for one of IN_READER. Returns [(object, attr, original)], what
    undoes it; `set_attr` may be pytest's monkeypatch.setattr."""
    if fault in AT_POINT:
        f = AT_POINT[fault]
        obj = importlib.import_module(at[0])
        name = at[1]
        orig = getattr(obj, name)

        def broken(*args, **kwargs):
            return f(orig(*args, **kwargs))

        for k in ("launches", "calls"):
            if hasattr(orig, k):
                setattr(broken, k, getattr(orig, k))
    elif fault in IN_READER:
        from waterorderlib_tpu_torch.io import streaming

        f, obj, name = IN_READER[fault], streaming.LazyDCD, "read"
        orig = obj.read

        def broken(self, start, count):
            return f(*orig(self, start, count))
    else:
        raise ValueError(f"no fault {fault!r}: {sorted(AT_POINT) + sorted(IN_READER)}")
    set_attr(obj, name, broken)
    return [(obj, name, orig)]


def force_tier(tier: dict, set_attr=setattr) -> list:
    """Hold the predicate that picks `tier` true; returns what undoes it."""
    if "force" not in tier:
        return []
    obj = importlib.import_module(tier["force"][0])
    name = tier["force"][1]
    orig = getattr(obj, name)
    set_attr(obj, name, lambda *args, **kwargs: True)
    return [(obj, name, orig)]


def undo(planted: list) -> None:
    for obj, name, orig in reversed(planted):
        setattr(obj, name, orig)
