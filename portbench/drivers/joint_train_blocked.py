"""The joint driver (`drivers/joint_train.py`) with the reference's steps
taken in blocks (`reference/joint_blocked.py`): the same cell, window,
profiled slice, checks and faults; only the reference differs, so that its
check fits in the card's memory at 300^2 under PyTorch's default
allocator (EfficientLab-b3's size).
"""
import torch

from portbench.drivers import joint_train
from portbench.drivers.joint_train import FAULTS  # noqa: F401
from portbench.reference import joint_blocked


class Cell(joint_train.Cell):

    def reference(self, tf32: bool = False):
        """(the reference's params after each of the first check_steps
        steps, its losses), each step `joint_blocked.joint_step` from the
        same weights, batches and seeds (`tf32`: with TF32 on, the
        control)."""
        cuda = torch.backends.cuda.matmul, torch.backends.cudnn
        saved = cuda[0].allow_tf32, cuda[1].allow_tf32
        cuda[0].allow_tf32 = cuda[1].allow_tf32 = tf32
        try:
            w = {k: v.clone() for k, v in self.w0.items()}
            out, losses = {}, []
            for i, (idx, seeds, state) in enumerate(self.batches):
                g = torch.Generator(device=self.dev)
                g.set_state(state)
                losses.append(float(joint_blocked.joint_step(
                    self.arch, w, self.images[idx], self.labels[idx], seeds,
                    g, self.lr)))
                out[i + 1] = {k: v.detach().clone() for k, v in w.items()
                              if k in self.after[1]}
        finally:
            cuda[0].allow_tf32, cuda[1].allow_tf32 = saved
        return out, losses
