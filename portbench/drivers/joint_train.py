"""The 1000-way joint baseline through `JointTrainer.train_step`: SGD
steps at batch 64 over shuffled epochs of the training images, each with
one `fused_light_augment` launch on per-sample seeds, at the first epoch's
learning rate, as `JointTrainer.train` draws them (an epoch's order, then
the seeds of `steps_per_launch` steps at a time, from the run's generator;
dropout and drop-connect from the same generator).

Set-up renders the 1000 classes from the seed, makes the weights, and runs
the first `check_steps` steps through the trainer (the first builds the
kernel and warms every shape). The reference follows those steps from the
same weights, batches and seeds, and the check compares each step's loss,
leaf by leaf the norm of the first gradient (the first update over the
learning rate) and of the change after all of them.
"""
import time
from typing import List

import torch

from portbench.common import (FAMILIES, leaf_checks, load_port_weights,
                              program_model, render_tasks, shrink, sync)
from portbench.reference import draws as dr
from portbench.reference import train as ref
from portbench.reference.model import Arch, make_weights
from portbench import counts


class Cell:
    unit = "image"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 limits: dict, small: dict = None):
        from mliis_tpu_torch.joint import trainer as jt
        from mliis_tpu_torch.meta import inner_loop as il

        small = small or {}
        self.traffic, self.limits = traffic, limits
        self.dev = device
        self.j = dict(config["joint"], **small.get("joint", {}))
        self.data = dict(config["data"], **small.get("data", {}))
        self.size = small.get("image_size", config["model"]["image_size"])
        config = shrink(config, small)
        self.model = program_model(config, device)
        self.arch = Arch.from_config(config)
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.jt, self.il = jt, il
        self.losses: List[torch.Tensor] = []
        self.batches: List[tuple] = []
        self.pending: List[tuple] = []
        self.steps_done = 0

    def setup(self) -> None:
        d = self.data
        fams = [FAMILIES.index(f) for f in d["families"]]
        classes = d["classes"]
        images, masks = render_tasks(
            [fams[t % len(fams)] for t in range(classes)],
            d["examples_per_class"], self.size, self.gen)
        ids = torch.arange(1, classes + 1, device=self.dev, dtype=torch.int32)
        labels = (masks > 127).to(torch.int32) * ids[:, None, None, None]
        k = d["train_classes"]
        flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))  # noqa: E731
        names = ["c{}".format(i) for i in range(classes)]
        self.train_set = self.jt.JointDataset(flat(images[:k]),
                                              flat(labels[:k]), names)
        val = self.jt.JointDataset(flat(images[k:]), flat(labels[k:]),
                                   names)
        del images, masks, labels
        self.images, self.labels = self.train_set.images, \
            self.train_set.labels
        self.w0 = make_weights(self.arch, self.gen, self.dev)
        load_port_weights(self.model, self.w0)
        self.trainer = self.jt.JointTrainer(
            self.model, self.train_set, val,
            self.jt.JointTrainConfig(batch_size=self.j["batch_size"],
                                     learning_rate=self.j["lr"],
                                     final_learning_rate=self.j["final_lr"],
                                     epochs=self.j["epochs"], l2=True,
                                     augment=True),
            self.il.OptimizerConfig("sgd"), device=self.dev,
            log_fn=lambda *_: None)
        self.opt = self.il.init_opt_state(dict(self.model.named_parameters()),
                                          self.il.OptimizerConfig("sgd"))
        self.lr = self.trainer.lr_fn(0)
        self.order = torch.empty(0, self.j["batch_size"], dtype=torch.long,
                                 device=self.dev)
        self.after = {}
        for _ in range(self.traffic["check_steps"]):
            self.step(record=True)
            self.after[self.steps_done] = {
                k: v.detach().clone()
                for k, v in self.model.named_parameters()}
        sync(self.dev)

    def step(self, record: bool = False) -> None:
        """One step through the trainer, its batch and seeds drawn as
        `JointTrainer.train` draws them."""
        b = self.j["batch_size"]
        if not self.pending:
            n = self.images.shape[0]
            if self.order.shape[0] == 0:
                self.order = dr.epoch_order(self.gen, n, n // b, b)
            steps = min(self.traffic["steps_per_launch"],
                        self.order.shape[0])
            seeds = dr.light_seeds(self.gen, steps, b)
            self.pending = [(self.order[i], seeds[i]) for i in range(steps)]
            self.order = self.order[steps:]
        idx, seeds = self.pending.pop(0)
        state = self.gen.get_state() if record else None
        self.opt, loss = self.trainer.train_step(self.opt, idx, seeds,
                                                 self.lr, self.gen)
        if record:
            self.batches.append((idx, seeds, state))
            self.losses.append(loss)
        self.steps_done += 1

    def window(self, seconds: float) -> dict:
        launch = self.traffic["steps_per_launch"]
        sync(self.dev)
        start = time.perf_counter()
        steps, times = 0, []
        while True:
            t = time.perf_counter()
            for _ in range(launch):
                self.step()
            sync(self.dev)
            steps += launch
            times.append((time.perf_counter() - t) / launch)
            if time.perf_counter() - start >= seconds:
                break
        elapsed = time.perf_counter() - start
        images = steps * self.j["batch_size"]
        return {"units": images, "seconds": elapsed, "unit_times": times,
                "flops": counts.training_flops(self.arch, self.size,
                                               self.size, images)}

    def trace_slice(self) -> dict:
        for _ in range(self.traffic["trace_steps"]):
            self.step()
        return {"inner_steps": self.traffic["trace_steps"],
                "augment_batch": self.j["batch_size"]}

    def release(self) -> None:
        del self.trainer, self.model, self.opt

    def reference(self, tf32: bool = False):
        """(the reference's params after each of the first check_steps
        steps, its losses), from the same weights, batches and seeds
        (`tf32`: with TF32 on, the control)."""
        cuda = torch.backends.cuda.matmul, torch.backends.cudnn
        saved = cuda[0].allow_tf32, cuda[1].allow_tf32
        cuda[0].allow_tf32 = cuda[1].allow_tf32 = tf32
        try:
            w = {k: v.clone() for k, v in self.w0.items()}
            out, losses = {}, []
            for i, (idx, seeds, state) in enumerate(self.batches):
                g = torch.Generator(device=self.dev)
                g.set_state(state)
                losses.append(float(ref.joint_step(
                    self.arch, w, self.images[idx], self.labels[idx], seeds,
                    g, self.lr)))
                out[i + 1] = {k: v.detach().clone() for k, v in w.items()
                              if k in self.after[1]}
        finally:
            cuda[0].allow_tf32, cuda[1].allow_tf32 = saved
        return out, losses

    def _checks(self, prog_after, prog_losses, ref_after, ref_losses):
        gap = max(abs(p - r) / abs(r) for p, r in zip(prog_losses,
                                                      ref_losses))
        return [("loss_gap", gap, self.limits.get("loss_gap"))] + \
            leaf_checks(self.w0, prog_after, ref_after, self.limits)

    def check(self) -> List[tuple]:
        """Each step's loss against the reference's, as a share of it, and
        the leaf gaps; (name, value, limit), compared where there is a
        limit."""
        return self._checks(self.after, [float(x) for x in self.losses],
                            *self.reference())

    def control(self) -> List[tuple]:
        """The same numbers with the reference under TF32 in the program's
        place."""
        return self._checks(*self.reference(tf32=True), *self.reference())


def _unchanged(cell, patch):
    """A step that returns its state unchanged."""
    from mliis_tpu_torch.joint import trainer as jt
    patch(jt.JointTrainer, "train_step",
          lambda self, opt, idx, seeds, lr, generator=None:
          (opt, torch.tensor(1.0)))


def _half_batch(cell, patch):
    """Every step on the first half of its batch, the mean taken over
    it."""
    from mliis_tpu_torch.joint import trainer as jt
    whole = jt.JointTrainer.train_step

    def half(self, opt, idx, seeds, lr, generator=None):
        b = idx.shape[0] // 2
        return whole(self, opt, idx[:b], seeds[:b], lr, generator)

    patch(jt.JointTrainer, "train_step", half)


# Faults planted under the timed path (the tests, `control.py --fault`):
# fault(cell, patch), `patch(obj, name, value)` a monkeypatch's setattr.
FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch}
