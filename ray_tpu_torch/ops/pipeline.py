"""Pipeline parallelism: GPipe-style microbatching over the ``pipe`` axis.

Counterpart of ``ray_tpu/ops/pipeline.py``. The reference runs the whole
pipeline as one jitted program: each device holds one stage's params,
activations circulate stage to stage with ``ppermute``, and the schedule
is the classic M + n - 1 step loop (fill, steady state, drain). Here each
rank of the ``pipe`` axis's process group (parallel/mesh.py ``RankMesh``)
holds one stage and runs the same loop eagerly, handing its activation to
the next stage with a ``send_recv`` shift (parallel/collectives.py);
gradients flow back through the same chain, reversed, step by step. A
stage with no microbatch at a step (the fill and drain bubbles) skips its
stage function and sends zeros: the reference computes on a stale input
there and discards the result, so the outputs and gradients are the same.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from ray_tpu_torch.parallel.collectives import (_all_reduce, _Comm, _shift,
                                                to_global, to_local)
from ray_tpu_torch.parallel.mesh import AXIS_PIPE, use_mesh


class _Pipeline(torch.autograd.Function):
    """The schedule as one autograd node. Each rank's autograd graph would
    hold only what its own output depends on, which differs from stage to
    stage, while every rank must run every backward send; so the backward
    runs the schedule in reverse explicitly: step by step the gradient of
    each stage's input goes back to the previous stage with ``send_recv``
    (the opposite shift), the same sends on every rank."""

    @staticmethod
    def forward(ctx, microbatches, axis_name, stage_fn, spec, *leaves):
        c = _Comm(axis_name)
        n, idx, M = c.n, c.rank, microbatches.shape[0]
        steps = M + n - 1
        params = [leaf.detach().requires_grad_(leaf.requires_grad)
                  for leaf in leaves]
        stage_params = pytree.tree_unflatten(params, spec)
        state = torch.zeros_like(microbatches[0])
        saved, outs = {}, []
        for t in range(steps):
            if 0 <= t - idx < M:      # this stage holds microbatch t - idx
                x_in = (microbatches[t] if idx == 0 else state).detach()
                x_in.requires_grad_(idx > 0 or microbatches.requires_grad)
                with torch.enable_grad():
                    y = stage_fn(stage_params, x_in)
                saved[t] = (x_in, y)
                y = y.detach()
                if idx == n - 1:
                    outs.append(y)    # the last stage banks it
            else:
                y = torch.zeros_like(state)
            if t + 1 < steps:
                # hand the activation to the next stage (last -> 0 unused)
                state = _shift(c, y, 1)
        out_buf = (torch.stack(outs) if idx == n - 1
                   else torch.zeros((M,) + tuple(microbatches.shape[1:]),
                                    dtype=microbatches.dtype,
                                    device=microbatches.device))
        ctx.c, ctx.steps, ctx.saved, ctx.params = c, steps, saved, params
        ctx.mb_like = microbatches
        # every rank gets the last stage's buffer: zeros elsewhere, so a
        # sum over the axis is a select and broadcast
        return _all_reduce(c, out_buf)

    @staticmethod
    def backward(ctx, g):
        c, steps, saved, params = ctx.c, ctx.steps, ctx.saved, ctx.params
        n, idx = c.n, c.rank
        g_buf = _all_reduce(c, g)
        wrt = [p for p in params if p.requires_grad]
        g_params = [torch.zeros_like(p) for p in wrt]
        g_mb = torch.zeros_like(ctx.mb_like)
        zeros = torch.zeros_like(ctx.mb_like[0])
        g_x_next = zeros
        for t in reversed(range(steps)):
            g_y = _shift(c, g_x_next, -1) if t + 1 < steps else zeros
            g_x_next = zeros
            if t not in saved:
                continue
            x_in, y = saved[t]
            if idx == n - 1:
                g_y = g_y + g_buf[t - idx]
            inputs = ([x_in] if x_in.requires_grad else []) + wrt
            grads = torch.autograd.grad(y, inputs, g_y, allow_unused=True)
            if x_in.requires_grad:
                g_x, grads = grads[0], grads[1:]
                if idx == 0:
                    g_mb[t] = g_x
                else:
                    g_x_next = g_x
            for acc, gp in zip(g_params, grads):
                if gp is not None:
                    acc += gp
        it = iter(g_params)
        leaf_grads = [next(it) if p.requires_grad else None for p in params]
        return (g_mb if ctx.mb_like.requires_grad else None, None, None,
                None, *leaf_grads)


def pipeline_local(stage_params, microbatches: torch.Tensor, *,
                   stage_fn: Callable, axis_name: str = AXIS_PIPE
                   ) -> torch.Tensor:
    """The reference's shard_map body, which every rank of ``axis_name``'s
    group of the current mesh runs. stage_params: THIS stage's params
    pytree. microbatches [M, mb, ...]: the full input on stage 0 (other
    stages ignore their copy). ``stage_fn(params, x)`` keeps x's shape.
    Returns [M, mb, ...] outputs, valid on every rank (the last stage's,
    summed over the group with zeros elsewhere); differentiable."""
    leaves, spec = pytree.tree_flatten(stage_params)
    return _Pipeline.apply(microbatches, axis_name, stage_fn, spec, *leaves)


def pipeline_forward(stage_fn: Callable, stage_params, microbatches,
                     mesh, axis_name: str = AXIS_PIPE) -> torch.Tensor:
    """Global entry. stage_params: pytree whose leaves have a leading
    STAGE axis of size n (stage i's slice on pipe rank i); microbatches
    [M, mb, ...] replicated in. Output [M, mb, ...] replicated (every stage
    ends with the final result). Under a ``RankMesh`` every rank calls it
    with the same global params and microbatches; autograd gives every
    rank the gradients of the whole stacked params. Under a local-device
    ``Mesh`` one process runs the stages in order on the pipe axis's
    devices."""
    n = mesh.shape[axis_name]
    if mesh.spans_ranks:
        with use_mesh(mesh):
            params = pytree.tree_map(
                lambda x: to_local(x, (axis_name,) + (None,) * (x.dim() - 1),
                                   mesh)[0], stage_params)
            mb = to_local(microbatches, (), mesh)
            out = pipeline_local(params, mb, stage_fn=stage_fn,
                                 axis_name=axis_name)
            return to_global(out, (), mesh)
    index = tuple(slice(None) if a == axis_name else 0
                  for a in mesh.axis_names)
    devices = list(mesh.devices[index])
    x = microbatches
    for i in range(n):
        stage = pytree.tree_map(lambda p: p[i].to(devices[i]), stage_params)
        x = torch.stack([stage_fn(stage, m) for m in x.to(devices[i])])
    return x.to(microbatches.device)
