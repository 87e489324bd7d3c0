"""The device's idle share of the profiled slice in the EfficientLab-b3
cell: 1 - the union of its activity intervals (kernels and copies) over
the slice's wall."""
from portbench.readers import idle_pct


def read(trace):
    return idle_pct(trace)
