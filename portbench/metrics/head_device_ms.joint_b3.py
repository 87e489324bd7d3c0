"""Device ms a joint step spends in the 1001-channel head, forward and
backward, in the EfficientLab-b3 cell (75^2 -> 300^2): the kernels and
copies that `portbench/spans.py` puts down to the `loss.head` span, from a
slice profiled with the program's spans on."""


def read(trace):
    table = trace.spans
    return None if table is None else table.device_ms("loss.head")
