"""Per-call stage times from the program's stage clock.

In a traced run each call of the window runs inside the program's
`stage_times()` block (waterorderlib_tpu_torch/core/clock.py), which
synchronises the device at each stage's end and records the stage's wall
time in ms. A cell's file maps each layer metric to the stage names that
make it up; a name ending in `*` takes every stage that starts with the
rest."""

from __future__ import annotations


def _matches(stage: str, names: list[str]) -> bool:
    return any(stage.startswith(n[:-1]) if n.endswith("*") else stage == n for n in names)


def ms_per_call(run, metric: str) -> float | None:
    """Mean over the window's calls of the summed stages of `metric`, or
    None where the cell names none for it or no call saw one."""
    names = run.cell.get("layers", {}).get(metric)
    if not names or not run.stage_calls:
        return None
    seen, total = False, 0.0
    for st in run.stage_calls:
        for stage, ms in st.items():
            if _matches(stage, names):
                seen, total = True, total + ms
    return total / len(run.stage_calls) if seen else None
