"""The program's own idle share: 100 * the time the device is idle while
the host's main thread is inside a `joint.step` span, over the wall of a
slice profiled with the program's spans on (`portbench/spans.py`); the
seed and epoch draws between steps are left out."""


def read(trace):
    table = trace.spans
    return None if table is None else table.step_idle_pct()
