"""Device ms a joint step spends in the update: the kernels and copies
put down to the `loss.l2` span (the l2 term, forward and backward) and to
`optimizer.apply` (the SGD step), from a slice profiled with the
program's spans on (`portbench/spans.py`)."""


def read(trace):
    table = trace.spans
    return None if table is None else table.device_ms("loss.l2",
                                                      "optimizer.apply")
