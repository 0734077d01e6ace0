"""The learners' optimizers, with optax's semantics, on trees of tensors.

The reference builds every learner's optimizer from optax
(``clip_by_global_norm``, ``adam``, ``rmsprop``) and applies it to a
parameter tree (dicts, lists and tuples of arrays). The port keeps the
parameters as such a tree of tensors, because they cross ``ray.put``
every round, and applies these transforms to it functionally: each
``update`` returns new tensors and never writes into its inputs, so a
copy handed to a runner or kept as a target network is never changed.

Two of optax's transforms differ from PyTorch's own:

- ``clip_by_global_norm`` scales by ``max_norm / norm`` only when
  ``norm >= max_norm``; ``torch.nn.utils.clip_grad_norm_`` always
  multiplies by ``max_norm / (norm + 1e-6)`` (clamped to 1).
- ``rmsprop`` scales by ``rsqrt(nu + eps)`` from ``nu = 0`` (eps inside
  the root); ``torch.optim.RMSprop`` divides by ``sqrt(nu) + eps``, about
  3x apart at ``nu ~ 1e-6`` with ``eps = 1e-5``.

``adam`` follows optax's order of operations (bias-corrected moments
with the corrections in f32, ``eps`` outside the root, no
``eps_root``); ``torch.optim.Adam`` with ``eps=1e-8`` computes the same
step and matches it within f32 rounding.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Sequence

import numpy as np
import torch


# ----------------------------------------------------------------------
# parameter trees: dicts (keys in sorted order, as jax flattens them),
# lists and tuples of tensors
# ----------------------------------------------------------------------

def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable[[Any], Any], tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_unflatten(tree, leaves: Sequence[Any]):
    """``tree``'s structure with ``leaves`` (in tree_leaves' order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, list):
            return [build(v) for v in t]
        if isinstance(t, tuple):
            return tuple(build(v) for v in t)
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def with_grad(tree):
    """Detached leaf copies of a tree's tensors that require grad: the
    leaves a loss is differentiated by."""
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


# ----------------------------------------------------------------------
# transforms (optax.GradientTransformation's init/update pair, on lists
# of leaves)
# ----------------------------------------------------------------------

class Transform(NamedTuple):
    init: Callable[[List[torch.Tensor]], Any]
    update: Callable[[List[torch.Tensor], Any], tuple]


def global_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of every leaf's squares."""
    return torch.sqrt(sum(torch.sum(torch.square(g)) for g in leaves))


def clip_by_global_norm(max_norm: float) -> Transform:
    """``optax.clip_by_global_norm``: leaves unchanged while the global
    norm is below ``max_norm``, else each scaled by max_norm / norm (at
    ``max_norm = 0`` every leaf becomes 0, as in optax). Its state is
    the last update's global norm before the clip (optax keeps none), so
    a learner reports it without a second reduction."""

    def init(leaves):
        return torch.zeros((), device=leaves[0].device)

    def update(grads, state):
        norm = global_norm(grads)
        keep = norm < max_norm
        return [torch.where(keep, g, (g / norm) * max_norm)
                for g in grads], norm

    return Transform(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Transform:
    """``optax.adam(lr)``: state {count, mu, nu} per leaf."""

    def init(leaves):
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves]}

    def update(grads, state):
        count = state["count"] + 1
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state["mu"])]
        nu = [(1 - b2) * torch.square(g) + b2 * v
              for g, v in zip(grads, state["nu"])]
        # the bias corrections in f32, as optax computes them
        c1, c2 = (float(np.float32(1) - np.float32(b) ** np.float32(count))
                  for b in (b1, b2))
        updates = [-lr * ((m / c1) / (torch.sqrt(v / c2) + eps))
                   for m, v in zip(mu, nu)]
        return updates, {"count": count, "mu": mu, "nu": nu}

    return Transform(init, update)


def rmsprop(lr: float, decay: float = 0.9, eps: float = 1e-8) -> Transform:
    """``optax.rmsprop(lr, decay, eps)`` (no momentum, not centred):
    nu from 0, the step ``-lr * g * rsqrt(nu + eps)``."""

    def init(leaves):
        return {"nu": [torch.zeros_like(p) for p in leaves]}

    def update(grads, state):
        nu = [(1 - decay) * torch.square(g) + decay * v
              for g, v in zip(grads, state["nu"])]
        updates = [-lr * (torch.rsqrt(v + eps) * g)
                   for g, v in zip(grads, nu)]
        return updates, {"nu": nu}

    return Transform(init, update)


class Optimizer:
    """``optax.chain(*transforms)`` on a parameter tree. ``init(params)``
    gives the state; ``step(params, grads, state)`` (grads a list in
    tree_leaves' order) gives (new params, new state); both run under
    no_grad and return new tensors."""

    def __init__(self, *transforms: Transform):
        self.transforms = transforms

    def init(self, params) -> list:
        leaves = tree_leaves(params)
        with torch.no_grad():
            return [t.init(leaves) for t in self.transforms]

    def step(self, params, grads: Sequence[torch.Tensor], state: list):
        with torch.no_grad():
            updates, new_state = list(grads), []
            for t, s in zip(self.transforms, state):
                updates, s = t.update(updates, s)
                new_state.append(s)
            leaves = [p.detach() + u
                      for p, u in zip(tree_leaves(params), updates)]
        return tree_unflatten(params, leaves), new_state


def clipped(max_grad_norm: float, opt: Transform) -> Optimizer:
    """``optax.chain(clip_by_global_norm(max_grad_norm), opt)``."""
    return Optimizer(clip_by_global_norm(max_grad_norm), opt)
