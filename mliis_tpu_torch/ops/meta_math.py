"""Arithmetic over dicts of tensors for the meta-updates (Reptile / FOMAML).

The counterpart of the JAX package's pytree math; a "tree" here is a
`dict[str, torch.Tensor]` keyed by parameter name. Every function returns
new tensors and leaves its inputs untouched.
"""
from typing import Dict, Sequence

import torch

Tree = Dict[str, torch.Tensor]


def tree_map(fn, *trees: Tree) -> Tree:
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


def tree_interpolate(old: Tree, new: Tree, epsilon) -> Tree:
    """old + epsilon * (new - old); the Reptile outer update."""
    return tree_map(lambda o, n: o + epsilon * (n - o), old, new)


def tree_average(trees: Sequence[Tree]) -> Tree:
    """Elementwise mean over a sequence of trees."""
    return tree_map(lambda *xs: torch.stack(xs).mean(0), *trees)


def tree_mean_over_axis(tree: Tree, axis: int = 0) -> Tree:
    """Mean over a leading (task) axis of every tensor."""
    return tree_map(lambda x: x.mean(axis), tree)


def tree_weighted_mean_over_axis(tree: Tree, weights: torch.Tensor,
                                 axis: int = 0) -> Tree:
    """Weighted mean over `axis` of every tensor (padded meta-batch slots
    masked by weight 0); all-zero weights give zeros, not inf."""
    denom = torch.clamp(weights.sum(), min=torch.finfo(torch.float32).tiny)

    def wmean(x):
        shape = [1] * x.ndim
        shape[axis] = weights.shape[0]
        return (x * weights.reshape(shape)).sum(axis) / denom

    return tree_map(wmean, tree)


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(lambda x, y: x - y, a, b)


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(lambda x, y: x + y, a, b)


def tree_scale(tree: Tree, scale) -> Tree:
    return tree_map(lambda x: x * scale, tree)


def tree_weight_decay(tree: Tree, rate) -> Tree:
    """Multiplicative weight decay, the reference's pre-step op; rate=1 is
    the identity."""
    return tree_scale(tree, rate)


def tree_zeros_like(tree: Tree) -> Tree:
    return tree_map(torch.zeros_like, tree)


def tree_dot(a: Tree, b: Tree) -> torch.Tensor:
    """Inner product over every tensor of two trees, float32."""
    total = torch.zeros((), dtype=torch.float32)
    for k in a:
        total = total + torch.vdot(a[k].reshape(-1), b[k].reshape(-1)).to(
            total.device, torch.float32)
    return total

def tree_count_params(tree: Tree) -> int:
    """Number of scalars in the tree."""
    return sum(int(x.numel()) for x in tree.values())
