"""The whole step's share of the card's bf16 peak: the counted FLOPs of
the window's steps (three forwards a trained image) over its seconds."""
from portbench.readers import step_mfu_pct


def read(trace):
    return step_mfu_pct(trace)
