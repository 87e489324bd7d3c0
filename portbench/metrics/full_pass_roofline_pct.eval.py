"""`full_pass` (csrc/full_pass.cu) against its roofline: the planar
float32 batch in and out and its draws at HBM3's 3.35 TB/s over the
kernel's mean device time in the slice."""
from portbench import counts
from portbench.readers import roofline_pct

KERNEL = "full_pass_kernel"


def read(trace):
    return roofline_pct(trace, KERNEL, lambda b, size: counts.full_pass_bytes(
        b, size, size))
