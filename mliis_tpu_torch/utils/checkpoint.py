"""Checkpoints in the JAX package's npz format, so either package reads the
other's.

A checkpoint is `model.ckpt-<step>.npz` of "/"-joined flax paths:
`params/...`, `batch_stats/...`, `opt_v/...` and `opt_step`, beside a
`.json` header, with a `checkpoint` index file naming the latest and the
oldest rotated out past `max_to_keep`. The port's modules keep the flax
path tokens in their names ("a/b/kernel" is "a.b.kernel"), so the map is a
rename plus the layout of conv kernels:
  - conv [kh, kw, in, out] <-> [out, in, kh, kw];
  - depthwise [kh, kw, 1, C] <-> [C, 1, kh, kw] (the same transpose);
  - batch-norm `scale`/`bias` are params, `mean`/`var` buffers.
The evaluator's per-task fine-tuned exports are ordinary checkpoints at
`<dir>/<task>/<eval_sample>/model.ckpt-<inner_iters>.npz`
(`save_fine_tuned_checkpoint`), and `import_tf1_var_map` takes weights
converted from the published TF1 checkpoint (`models/tf1_import`).
"""
import json
import os
import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mliis_tpu_torch.meta.inner_loop import ModelState, OptState

CHECKPOINT_PREFIX = "model.ckpt"
INDEX_FILE = "checkpoint"
_COLLECTIONS = ("params/", "batch_stats/")


def _to_flax(value: torch.Tensor) -> np.ndarray:
    """A copy in flax layout (conv kernels [kh, kw, in, out])."""
    value = value.detach().cpu().numpy().copy()
    return value.transpose(2, 3, 1, 0) if value.ndim == 4 else value


def _from_flax(value: np.ndarray) -> torch.Tensor:
    value = np.asarray(value)
    if value.ndim == 4:
        value = np.ascontiguousarray(value.transpose(3, 2, 0, 1))
    return torch.tensor(value)


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat JAX checkpoint dict -> the port's `state_dict` (params and
    batch-norm running stats)."""
    state = {}
    for key, value in flat.items():
        prefix = next((p for p in _COLLECTIONS if key.startswith(p)), None)
        if prefix is not None:
            state[key[len(prefix):].replace("/", ".")] = _from_flax(value)
    return state


def params_to_jax(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of `params_from_jax` for a module's params and buffers.
    The arrays are copies: they do not change when the module trains."""
    flat = {}
    for collection, named in (("params/", module.named_parameters()),
                              ("batch_stats/", module.named_buffers())):
        for name, value in named:
            flat[collection + name.replace(".", "/")] = _to_flax(value)
    return flat


def load_jax_npz(path: str) -> Dict[str, torch.Tensor]:
    """Read a JAX package npz checkpoint into the port's `state_dict`."""
    with np.load(path, allow_pickle=False) as z:
        return params_from_jax({k: z[k] for k in z.files})


def save_checkpoint(save_dir: str, state: ModelState, step: int,
                    max_to_keep: int = 2,
                    metadata: Optional[Dict] = None) -> str:
    os.makedirs(save_dir, exist_ok=True)
    flat = {}
    for collection, tree in (("params/", state.params),
                             ("batch_stats/", state.batch_stats),
                             ("opt_v/", state.opt.v)):
        for name, value in tree.items():
            flat[collection + name.replace(".", "/")] = _to_flax(value)
    flat["opt_step"] = np.asarray(int(state.opt.step), np.int32)
    path = os.path.join(save_dir, "{}-{}.npz".format(CHECKPOINT_PREFIX, step))
    np.savez(path, **flat)
    meta = dict(metadata or {})
    meta["step"] = step
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    with open(os.path.join(save_dir, INDEX_FILE), "w") as f:
        f.write('model_checkpoint_path: "{}-{}"\n'.format(
            CHECKPOINT_PREFIX, step))
    for old in _checkpoint_steps(save_dir)[:-max_to_keep]:
        base = os.path.join(save_dir, "{}-{}.npz".format(CHECKPOINT_PREFIX,
                                                         old))
        for p in (base, base + ".json"):
            if os.path.exists(p):
                os.remove(p)
    return path


def _checkpoint_steps(save_dir: str) -> List[int]:
    pattern = re.compile(re.escape(CHECKPOINT_PREFIX) + r"-(\d+)\.npz$")
    return sorted(int(m.group(1)) for m in map(pattern.match,
                                               os.listdir(save_dir)) if m)


def latest_checkpoint(checkpoint_dir: str,
                      ckpt_prefix: str = CHECKPOINT_PREFIX) -> str:
    """The newest checkpoint's path, from the index file's basename (so a
    moved directory still restores), else the highest step on disk."""
    index_path = os.path.join(checkpoint_dir, INDEX_FILE)
    if os.path.exists(index_path):
        with open(index_path) as f:
            found = re.findall(re.escape(ckpt_prefix + "-") + r"[0-9]+",
                               f.readline())
        if found:
            return os.path.join(checkpoint_dir, found[0] + ".npz")
    steps = _checkpoint_steps(checkpoint_dir)
    if not steps:
        raise FileNotFoundError("No checkpoints in {}".format(checkpoint_dir))
    return os.path.join(checkpoint_dir,
                        "{}-{}.npz".format(ckpt_prefix, steps[-1]))


def _fill(template: Dict[str, torch.Tensor], flat: Dict[str, np.ndarray],
          prefix: str, strict: bool) -> Dict[str, torch.Tensor]:
    """`template`'s entries from `flat`, by flax path; a missing entry keeps
    the template's value unless `strict`. A shape mismatch always raises."""
    out = {}
    for name, leaf in template.items():
        key = prefix + name.replace(".", "/")
        if key in flat:
            value = _from_flax(flat[key])
            if tuple(value.shape) != tuple(leaf.shape):
                raise ValueError("Shape mismatch for {}: ckpt {} vs model {}"
                                 .format(key, tuple(value.shape),
                                         tuple(leaf.shape)))
            out[name] = value.to(leaf.device)
        elif strict:
            raise KeyError("Missing checkpoint entry: {}".format(key))
        else:
            out[name] = leaf
    return out


def restore_checkpoint(path_or_dir: str, template: ModelState,
                       filter_to_scopes: Optional[List[str]] = None,
                       filter_out_scope: Optional[str] = None
                       ) -> Tuple[ModelState, Dict]:
    """Load a checkpoint (a file, or a directory's latest) into the shape
    of `template`. The scope filters act on the paths under `params/`,
    `batch_stats/` and `opt_v/` alike (a backbone-only restore takes no
    decoder running stats); filtered-out or missing entries keep the
    template's values."""
    path = path_or_dir
    if os.path.isdir(path_or_dir):
        path = latest_checkpoint(path_or_dir)
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}

    def keep(name: str) -> bool:
        for col in ("params/", "batch_stats/", "opt_v/"):
            if name.startswith(col):
                rel = name[len(col):]
                if filter_out_scope and rel.startswith(filter_out_scope):
                    return False
                return filter_to_scopes is None or any(
                    rel.startswith(s) for s in filter_to_scopes)
        return True

    flat = {k: v for k, v in flat.items() if keep(k)}
    strict = filter_to_scopes is None and filter_out_scope is None
    step = torch.tensor(int(flat.get("opt_step", 0)), dtype=torch.int32,
                        device=template.opt.step.device)
    state = ModelState(
        _fill(template.params, flat, "params/", strict),
        _fill(template.batch_stats, flat, "batch_stats/", strict),
        OptState(step, _fill(template.opt.v, flat, "opt_v/", False)))
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return state, meta


def save_fine_tuned_checkpoint(save_dir: str, state: ModelState,
                               step: Optional[int] = None,
                               eval_sample_num: Optional[int] = None) -> str:
    """A task's fine-tuned state under `save_dir/<eval_sample_num>`, one
    checkpoint kept (the reference's util.py:72-81)."""
    if eval_sample_num is not None:
        save_dir = os.path.join(save_dir, str(eval_sample_num))
    return save_checkpoint(save_dir, state, step or 0, max_to_keep=1)


def import_tf1_var_map(tf_vars: Dict[str, np.ndarray], template: ModelState,
                       name_mapper: Callable[[str], Optional[str]]
                       ) -> ModelState:
    """A {name: array} dict (TF1 variables converted offline, e.g. by
    `models/tf1_import.convert_tf1_vars`, whose arrays are in flax layout)
    into the shape of `template`. `name_mapper` gives each name's
    "params/..." or "batch_stats/..." path, or None to skip it; arrays
    take the port's layout as a checkpoint's do. Unmapped entries keep the
    template's values."""
    flat = {}
    for tf_name, value in tf_vars.items():
        path = name_mapper(tf_name)
        if path is not None:
            flat[path] = value
    return ModelState(_fill(template.params, flat, "params/", False),
                      _fill(template.batch_stats, flat, "batch_stats/",
                            False),
                      template.opt)
