"""Weights between the JAX package's npz checkpoints and the port's modules.

A JAX checkpoint is one .npz of "/"-joined flax paths: `params/...`,
`batch_stats/...`, `opt_v/...` and `opt_step`. The port's modules keep the
flax path tokens in their names ("a/b/kernel" is "a.b.kernel"), so the map
is a rename plus the layout of conv kernels:
  - conv [kh, kw, in, out] -> [out, in, kh, kw];
  - depthwise [kh, kw, 1, C] -> [C, 1, kh, kw] (the same transpose);
  - batch-norm `scale`/`bias` are params, `mean`/`var` buffers.
Optimizer slots (`opt_v/`, `opt_step`) are not read: the slice trains with
SGD, whose slots are empty.
"""
from typing import Dict

import numpy as np
import torch

_COLLECTIONS = ("params/", "batch_stats/")


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat JAX checkpoint dict -> the port's `state_dict` (params and
    batch-norm running stats)."""
    state = {}
    for key, value in flat.items():
        prefix = next((p for p in _COLLECTIONS if key.startswith(p)), None)
        if prefix is None:
            continue
        value = np.asarray(value)
        if value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        state[key[len(prefix):].replace("/", ".")] = torch.tensor(value)
    return state


def params_to_jax(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of `params_from_jax` for a module's params and buffers.
    The arrays are copies: they do not change when the module trains."""
    flat = {}
    for collection, named in (("params/", module.named_parameters()),
                              ("batch_stats/", module.named_buffers())):
        for name, value in named:
            value = value.detach().cpu().numpy().copy()
            if value.ndim == 4:
                value = value.transpose(2, 3, 1, 0)
            flat[collection + name.replace(".", "/")] = value
    return flat


def load_jax_npz(path: str) -> Dict[str, torch.Tensor]:
    """Read a JAX package npz checkpoint into the port's `state_dict`."""
    with np.load(path, allow_pickle=False) as z:
        return params_from_jax({k: z[k] for k in z.files})
