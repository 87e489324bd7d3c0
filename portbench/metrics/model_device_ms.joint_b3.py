"""Device ms a joint step spends in the model, forward and backward, in
the EfficientLab-b3 cell: the kernels and copies put down to the
`model.forward` span (EfficientNet-b3 to block 17 on planes 300 -> 150 ->
75 -> 38 -> 19, the RSD decoder, the 1001-channel conv), from a slice
profiled with the program's spans on (`portbench/spans.py`)."""


def read(trace):
    table = trace.spans
    return None if table is None else table.device_ms("model.forward")
