"""The whole step's share of the card's float32 peak (67 TFLOP/s; the
joint path runs float32 with TF32 off): the counted FLOPs of the window's
steps over its seconds."""
from portbench.readers import step_mfu_pct


def read(trace):
    return step_mfu_pct(trace)
