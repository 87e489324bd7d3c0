"""The evaluation sweep through `GeckoEvaluator.evaluate_tasks`: a seeded
permutation of the held-out tasks, `chunk` tasks a call on a task axis
(5 shots, 5 queries, 59 augmented steps at batch 8, then the prediction
of the queries and their IoU), from the committed meta-trained weights.

Set-up renders the 240 held-out tasks from the seed, loads the weights
with the program's loader and runs one chunk (the window's shapes). Every
chunk's draws come from a seed drawn from the run's generator, which the
benchmark records. The check runs the reference over a sample of the
window's tasks, drawn from the seed, from the same weights (read from the
npz by the reference itself) and seeds, and compares each sampled task's
query probabilities with the program's.
"""
import os
import time
from typing import List

import numpy as np
import torch

from portbench.common import (FAMILIES, ROOT, program_model, render_tasks,
                              shrink, sync)
from portbench.reference import draws as dr
from portbench.reference import train as ref
from portbench.reference.model import Arch, weights_from_npz
from portbench import counts


class Cell:
    unit = "task"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 limits: dict, small: dict = None):
        from mliis_tpu_torch.data.task_store import TaskStore
        from mliis_tpu_torch.meta import evaluate as ev
        from mliis_tpu_torch.meta import inner_loop as il

        small = small or {}
        self.traffic, self.limits = traffic, limits
        self.dev = device
        self.e = dict(config["eval"], **small.get("eval", {}))
        self.data = dict(config["data"], **small.get("data", {}))
        self.size = small.get("image_size", config["model"]["image_size"])
        self.chunk = small.get("chunk", traffic["chunk"])
        config = shrink(config, small)
        self.model = program_model(config, device)
        self.arch = Arch.from_config(config)
        self.seed = seed
        self.gen = torch.Generator(device=device).manual_seed(seed)
        e = self.e
        self.eval_config = ev.EvalConfig(
            num_shots=e["num_shots"], test_shots=e["test_shots"],
            inner_batch_size=e["inner_batch"], inner_iters=e["inner_iters"],
            transductive=e["transductive"], augment=True,
            task_chunk_size=self.chunk)
        self.ev, self.il, self.TaskStore = ev, il, TaskStore
        self.weights_path = small.get("weights") or os.path.join(
            os.path.dirname(ROOT), self.data["eval_weights"])
        self.calls: List[tuple] = []    # (tasks, seed) of every chunk
        self.probs = {}                 # (call, slot) -> program's probs
        self.adapted = {}               # (call, slot) -> its adapted state
        self.keep = set()

    def setup(self) -> None:
        from mliis_tpu_torch.utils import checkpoint as ckpt
        d = self.data
        fams = [FAMILIES.index(f) for f in d["test_families"]]
        families = [fams[t % len(fams)] for t in range(d["test_tasks"])]
        images, masks = render_tasks(families, d["examples_per_task"],
                                     self.size, self.gen)
        self.images, self.masks = images, masks
        n = d["test_tasks"]
        store = self.TaskStore(np.zeros((n, 1, 1, 1, 3), np.uint8),
                               np.zeros((n, 1, 1, 1), np.uint8),
                               np.zeros(n, np.int32), ["t"] * n)
        store.images, store.masks = images, masks
        store.counts = torch.full((n,), d["examples_per_task"],
                                  dtype=torch.int32, device=self.dev)
        template = self.il.init_model_state(self.model,
                                            self.il.OptimizerConfig("sgd"))
        self.state, _ = ckpt.restore_checkpoint(self.weights_path, template)
        self.evaluator = self.ev.GeckoEvaluator(
            self.model, self.il.LossConfig(dice=True, l2=True),
            self.il.OptimizerConfig("sgd"), self.eval_config, store,
            device=self.dev)
        self.order = torch.randperm(n, generator=self.gen,
                                    device=self.dev).tolist()
        self.cursor = 0
        self.call()   # warm-up: the window's shapes

    def call(self) -> int:
        """One chunk through the program; returns its task count."""
        n = len(self.order)
        tasks = [self.order[(self.cursor + i) % n] for i in range(self.chunk)]
        self.cursor += self.chunk
        before = self.gen.get_state()
        index = len(self.calls)

        def hook(j, adapted, query_images, probs):
            if (index, j) in self.keep:
                self.probs[(index, j)] = probs.detach().float().clone()
                self.adapted[(index, j)] = {
                    k: v.detach().clone() for k, v in
                    list(adapted.params.items())
                    + list(adapted.batch_stats.items())}

        self.evaluator.evaluate_tasks(
            self.state, tasks, self.gen, lr=self.e["lr"],
            drop_rate=self.e["drop_rate"], aug_rate=self.e["aug_rate"],
            on_episode=hook)
        self.calls.append((tasks, before))
        return len(tasks)

    def window(self, seconds: float) -> dict:
        # The sample the check compares, drawn from the seed: slots of the
        # calls the window will make (at least one), among the first ones.
        g = torch.Generator().manual_seed(self.seed)
        first = len(self.calls)
        picks = torch.randperm(self.chunk * 2, generator=g)[
            :self.traffic["check_tasks"]].tolist()
        self.keep = {(first + p // self.chunk, p % self.chunk)
                     for p in picks}
        sync(self.dev)
        times, start = [], time.perf_counter()
        units = 0
        while True:
            t = time.perf_counter()
            units += self.call()
            times.append(time.perf_counter() - t)
            if time.perf_counter() - start >= seconds:
                break
        elapsed = time.perf_counter() - start
        return {"units": units, "seconds": elapsed, "unit_times": times,
                "flops": units * self.flops_per_task()}

    def flops_per_task(self) -> float:
        e = self.e
        train = counts.training_flops(self.arch, self.size, self.size,
                                      e["inner_iters"] * e["inner_batch"])
        return train + e["test_shots"] * counts.forward_flops(
            self.arch, self.size, self.size)

    def trace_slice(self) -> dict:
        self.call()
        return {"inner_steps": self.e["inner_iters"],
                "augment_batch": self.chunk * self.e["inner_batch"]}

    def release(self) -> None:
        del self.evaluator, self.state, self.model

    def reference(self, quantize: bool = False, adapted=None):
        """For each sampled task, the reference's (adapted weights, query
        probabilities predicted from `adapted`'s state, the program's where
        given, else its own); `quantize`: in the lower precision, the
        control. The weights come from the npz, which it reads itself, and
        the draws from the chunks' seeds."""
        w = weights_from_npz(self.weights_path, self.dev)
        count = torch.tensor(self.data["examples_per_task"], device=self.dev)
        out = {}
        for call, slot in sorted(self.probs):
            tasks, state = self.calls[call]
            g = torch.Generator(device=self.dev)
            g.set_state(state)
            t = tasks[slot]
            own, query = ref.eval_task(
                self.arch, w, self.images[t], self.masks[t], count,
                dr.draw_seed(g), slot, self.e, self.e["lr"],
                self.e["drop_rate"], quantize)
            start = own if adapted is None else adapted[(call, slot)]
            out[(call, slot)] = (own, ref.predict(
                self.arch, start, self.images[t][query], quantize))
        self.w0 = w
        return out

    def _checks(self, prog_adapted, prog_probs, refs) -> List[tuple]:
        """Over the sampled tasks: the median task's median-leaf gap of the
        norm of the adaptation's change (adapted - initial weights); and
        the widest per-task mean |p - p_ref| of the foreground probability
        over the query pixels, the reference predicting from the same
        adapted state."""
        if not refs:
            return [("predict_prob_gap", float("inf"),
                     self.limits.get("predict_prob_gap"))]
        names = [k for k in next(iter(prog_adapted.values()))
                 if k in self.w0 and not k.endswith((".mean", ".var"))]
        changes, prob = [], 0.0
        for key, (own, probs) in refs.items():
            moved = {k: own[k] - self.w0[k] for k in names}
            changes.append(ref.median_leaf_gap(
                {k: prog_adapted[key][k] - self.w0[k] for k in names},
                moved, ref.moving_leaves(moved)))
            p, q = prog_probs[key][..., 1], probs[..., 1]
            prob = max(prob, float((p - q).abs().mean()))
        changes.sort()
        return [("adapt_change_median_gap", changes[len(changes) // 2],
                 self.limits.get("adapt_change_median_gap")),
                ("predict_prob_gap", prob,
                 self.limits.get("predict_prob_gap"))]

    def check(self) -> List[tuple]:
        return self._checks(self.adapted, self.probs,
                            self.reference(adapted=self.adapted))

    def control(self) -> List[tuple]:
        """The reference in the lower precision in the program's place:
        its adaptation, and its prediction from the program's adapted
        state, against the reference's."""
        low = self.reference(True, adapted=self.adapted)
        return self._checks({k: v[0] for k, v in low.items()},
                            {k: v[1] for k, v in low.items()},
                            self.reference(adapted=self.adapted))


def _unadapted(cell, patch):
    """Evaluation episodes whose adaptation takes no step."""
    from mliis_tpu_torch.meta import evaluate as ev
    whole = ev.make_batched_adapt_fn

    def none(*args, **kwargs):
        adapt = whole(*args, **kwargs)

        def unchanged(states, images, masks, idx, generators, lrs, **kw):
            return adapt(states, images, masks, idx[:, :0], generators,
                         lrs[:0], **kw)
        return unchanged

    patch(ev, "make_batched_adapt_fn", none)


def _altered_answer(cell, patch):
    """The top quarter of every query's probabilities swapped between
    background and foreground where they are produced."""
    from mliis_tpu_torch.meta import evaluate as ev
    whole = ev.make_batched_adapt_and_predict_fn

    def altered(*args, **kwargs):
        fn = whole(*args, **kwargs)

        def wrapped(*a, **kw):
            adapted, images, masks, probs = fn(*a, **kw)
            h = probs.shape[2] // 4
            probs = probs.clone()
            probs[:, :, :h] = probs[:, :, :h].flip(-1)
            return adapted, images, masks, probs
        return wrapped

    patch(ev, "make_batched_adapt_and_predict_fn", altered)


# Faults planted under the timed path (the tests, `control.py --fault`):
# fault(cell, patch), `patch(obj, name, value)` a monkeypatch's setattr.
FAULTS = {"unchanged": _unadapted, "altered_answer": _altered_answer}
