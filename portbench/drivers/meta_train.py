"""Closed-loop FOMAML* meta-training through the program's default step
(`learners.make_train_step`, the meta-batch on a task axis), as
`meta/train.train_gecko` drives it: each step takes its draws from
`learners.draw_meta_step` under a seed drawn from the run's generator, and
the meta step size of the annealing schedule.

Set-up makes the weights and the 760-task store from the seed, builds one
step and one state, and runs the first `check_steps` meta-steps through
that step (the first builds the kernels and warms every shape); the window
goes on from there. The reference follows those first steps from the same
weights and seeds, and the check compares, leaf by leaf, the norm of the
first step's update and of the change after all of them.
"""
import time
from typing import Dict, List

import torch

from portbench.common import (FAMILIES, leaf_checks, load_port_weights,
                              program_model, render_tasks, shrink, sync)
from portbench.reference import draws as dr
from portbench.reference import train as ref
from portbench.reference.model import Arch, make_weights
from portbench import counts


class Cell:
    unit = "meta-step"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 limits: dict, small: dict = None):
        from mliis_tpu_torch.meta import inner_loop as il
        from mliis_tpu_torch.meta import learners

        self.traffic, self.limits = traffic, limits
        self.dev = device
        self.m = dict(config["meta"], **(small or {}).get("meta", {}))
        self.data = dict(config["data"], **(small or {}).get("data", {}))
        self.size = (small or {}).get("image_size",
                                      config["model"]["image_size"])
        config = shrink(config, small)
        self.model = program_model(config, device)
        self.arch = Arch.from_config(config)
        self.gen = torch.Generator(device=device).manual_seed(seed)
        m = self.m
        self.meta_config = learners.MetaTrainConfig(
            num_shots=m["num_shots"], inner_batch_size=m["inner_batch"],
            inner_iters=m["inner_iters"], meta_batch_size=m["meta_batch"],
            foml=True, tail_shots=m["tail_shots"], aug_rate=m["aug_rate"])
        self.opt_config = il.OptimizerConfig("sgd")
        self.step_fn = learners.make_train_step(
            self.model, il.LossConfig(dice=True, l2=True), self.opt_config,
            self.meta_config)
        self.learners, self.il = learners, il
        self.steps_done = 0
        self.seeds: List[int] = []

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        d = self.data
        fams = [FAMILIES.index(f) for f in d["train_families"]]
        families = [fams[t % len(fams)] for t in range(d["train_tasks"])]
        self.images, self.masks = render_tasks(
            families, d["examples_per_task"], self.size, self.gen)
        self.counts = torch.full((d["train_tasks"],),
                                 d["examples_per_task"], dtype=torch.int32,
                                 device=self.dev)
        self.w0 = make_weights(self.arch, self.gen, self.dev)
        load_port_weights(self.model, self.w0)
        self.state = self.il.init_model_state(self.model, self.opt_config)
        self.after: Dict[int, Dict[str, torch.Tensor]] = {}
        for _ in range(self.traffic["check_steps"]):
            self.step()
            self.after[self.steps_done] = {
                k: v.detach().clone() for k, v in
                list(self.state.params.items())
                + list(self.state.batch_stats.items())}
        sync(self.dev)

    def step(self) -> None:
        """One meta-step through the program's step, as train_gecko takes
        it."""
        m = self.m
        seed = dr.draw_seed(self.gen)
        self.seeds.append(seed)
        eps = ref.meta_step_size(self.steps_done, m["meta_iters"],
                                 m["meta_step"], m["meta_step_final"])
        draws = self.learners.draw_meta_step(seed, self.counts,
                                             self.meta_config,
                                             self.images.shape[1])
        self.state = self.step_fn(self.state, self.images, self.masks, draws,
                                  eps, m["lr"])
        self.steps_done += 1

    # -- the window -----------------------------------------------------
    def window(self, seconds: float) -> dict:
        sync(self.dev)
        times, start = [], time.perf_counter()
        while True:
            t = time.perf_counter()
            self.step()
            sync(self.dev)
            times.append(time.perf_counter() - t)
            if time.perf_counter() - start >= seconds:
                break
        elapsed = time.perf_counter() - start
        return {"units": len(times), "seconds": elapsed, "unit_times": times,
                "flops": len(times) * self.flops_per_step()}

    def flops_per_step(self) -> float:
        m = self.m
        images = m["meta_batch"] * ((m["inner_iters"] - 1) * m["inner_batch"]
                                    + m["tail_shots"])
        return counts.training_flops(self.arch, self.size, self.size, images)

    def trace_slice(self) -> dict:
        """One meta-step, profiled by the caller."""
        self.step()
        return {"inner_steps": self.m["inner_iters"],
                "augment_batch": self.m["meta_batch"] * self.m["inner_batch"]}

    def release(self) -> None:
        del self.state, self.step_fn, self.model

    # -- correctness ----------------------------------------------------
    def reference(self, quantize: bool = False) -> Dict[int, dict]:
        """The reference's params after each of the first check_steps
        meta-steps, from the same weights and seeds (`quantize`: in the
        lower precision, the control)."""
        m = self.m
        w = {k: v.clone() for k, v in self.w0.items()}
        out = {}
        for i in range(self.traffic["check_steps"]):
            eps = ref.meta_step_size(i, m["meta_iters"], m["meta_step"],
                                     m["meta_step_final"])
            w = ref.meta_step(self.arch, w, self.images, self.masks,
                              self.counts, self.seeds[i], m, eps, m["lr"],
                              quantize)
            out[i + 1] = {k: v.detach().clone() for k, v in w.items()
                          if k in self.after[1]}
        return out

    def check(self) -> List[tuple]:
        """(name, value, limit) of each number read; those with a limit
        are compared."""
        return leaf_checks(self.w0, self.after, self.reference(),
                           self.limits)

    def control(self) -> List[tuple]:
        """The same numbers with the reference in the lower precision put
        in the program's place."""
        return leaf_checks(self.w0, self.reference(True), self.reference(),
                           self.limits)



def _unchanged(cell, patch):
    """A meta-step that returns its state unchanged."""
    patch(cell, "step_fn", lambda state, *args: state)


def _half_batch(cell, patch):
    """Every inner batch cut to its first half; the loss's mean is taken
    over the rest."""
    from mliis_tpu_torch.meta import episodes
    whole = episodes.assemble_batches

    def half(*args, **kwargs):
        images, masks = whole(*args, **kwargs)
        b = images.shape[1] // 2
        return images[:, :b], masks[:, :b]

    patch(episodes, "assemble_batches", half)


# Faults planted under the timed path (the tests, `control.py --fault`):
# fault(cell, patch), `patch(obj, name, value)` a monkeypatch's setattr.
FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch}
