"""Serving export: a fine-tuned model's eval-mode forward as a
`torch.export` program.

The port of the JAX package's `utils/export.py` (mliis_tpu/utils/export.py
:1-70), which lowers the jitted inference forward to a StableHLO artifact.
Here `torch.export` traces `model(images, train=False)` (population batch
statistics, no dropout; the skip decoder's layers normalize by the batch,
as in every mode) and returns the probabilities, NHWC float32 [N, H, W,
n_classes(+1)]. The differences:
  - the artifact is a `.pt2` file written by `torch.export.save` and read
    by `torch.export.load`; it holds the graph and the adapted params and
    buffers, so the port's model code is not needed to serve it (PyTorch
    is);
  - the batch is dynamic by default (`torch.export.Dim("batch")`, traced
    at a batch of 2) and fixed when `batch_size` is given;
  - there is no `platforms=` argument: the program runs where its tensors
    live, on the device of the module it was exported from.
"""
import copy
from typing import Optional

import torch

from mliis_tpu_torch.meta.inner_loop import ModelState, load_state


class _ServingForward(torch.nn.Module):
    """images [N, H, W, 3] in [0, 255] -> eval-mode probabilities."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.model(images, train=False)[1]


def export_serving_fn(model: torch.nn.Module, state: ModelState,
                      image_size: int, batch_size: Optional[int] = None
                      ) -> torch.export.ExportedProgram:
    """The eval-mode forward of `model` with `state` loaded (into a copy;
    `model` is left as it was), exported on the model's device."""
    served = copy.deepcopy(model)
    load_state(served, state)
    device = next(served.parameters()).device
    example = torch.zeros((batch_size or 2, image_size, image_size, 3),
                          device=device)
    dynamic = None
    if batch_size is None:
        dynamic = {"images": {0: torch.export.Dim("batch")}}
    with torch.no_grad():
        return torch.export.export(_ServingForward(served).eval(),
                                   (example,), dynamic_shapes=dynamic)


def save_serving_artifact(path: str, model: torch.nn.Module,
                          state: ModelState, image_size: int,
                          batch_size: Optional[int] = None) -> str:
    torch.export.save(export_serving_fn(model, state, image_size,
                                        batch_size=batch_size), path)
    return path


def load_serving_artifact(path: str) -> torch.export.ExportedProgram:
    """The saved program; `load_serving_artifact(p).module()(images)`
    serves it."""
    return torch.export.load(path)
