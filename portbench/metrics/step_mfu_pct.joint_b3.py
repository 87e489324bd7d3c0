"""The whole step's share of the card's float32 peak (67 TFLOP/s; the
joint path runs float32 with TF32 off) in the EfficientLab-b3 cell: the
FLOPs `counts.training_flops` counts for the window's images at 300^2
over its seconds."""
from portbench.readers import step_mfu_pct


def read(trace):
    return step_mfu_pct(trace)
