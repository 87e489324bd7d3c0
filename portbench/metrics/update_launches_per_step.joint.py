"""Device kernels a joint step launches for the update: those put down to
the `loss.l2` and `optimizer.apply` spans (`portbench/spans.py`). A count:
it repeats exactly from run to run."""


def read(trace):
    table = trace.spans
    return None if table is None else table.launches_per_step(
        "loss.l2", "optimizer.apply")
