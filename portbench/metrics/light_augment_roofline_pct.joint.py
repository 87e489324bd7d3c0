"""`fused_light_augment` (csrc/light_augment.cu) against its roofline:
float32 images and labels in and out and the seeds at HBM3's 3.35 TB/s
over the kernel's mean device time in the slice."""
from portbench import counts
from portbench.readers import roofline_pct

KERNEL = "light_augment_kernel"


def read(trace):
    return roofline_pct(trace, KERNEL,
                        lambda b, size: counts.light_augment_bytes(b, size,
                                                                   size))
