"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU (the tests
do). Asking for CUDA without a card raises instead of silently running on
the CPU.

Precision on the card: float32 matrix products and convolutions run in
full FP32 (`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`), so a float32 path computes
what it computes on the CPU; the model's speed comes from its bf16
compute dtype, not from TF32.
"""
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means "cuda"; a CUDA device without a card raises. On CUDA,
    TF32 is switched off for float32 products and convolutions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
