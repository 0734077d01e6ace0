"""Mixture-of-Experts: top-1 capacity routing and the expert FFN, in PyTorch.

Counterpart of ``ray_tpu/ops/moe.py`` (the Switch-Transformer formulation):
``top1_dispatch`` routes each token to its most probable expert, in
token order up to the expert's capacity, and builds the dense dispatch and
combine tensors [T, E, C]; ``moe_ffn_reference`` gathers the tokens into
their expert slots, runs every expert's GELU FFN as one batched product and
combines the outputs back per token, weighted by the router probability.
Tokens beyond an expert's capacity are dropped (their output is 0; the
block's residual carries them).

Numerics follow the reference's promotion rules: the router logits and the
softmax run in the tokens' dtype, while dispatch and combine are f32, so
the slot gather, the expert FFN and the combine run in f32 even in a bf16
model (the bf16 operands widened exactly); the caller casts the result
back. GELU is the tanh approximation (``jax.nn.gelu``'s default).

The dense [T, E, C] formulation costs O(T²) memory and work (T tokens, C =
T·cf/E slots an expert); there is no kernel here, only matrix products.
Expert parallelism over the mesh's ``expert`` axis: ``moe_ffn_local`` is
the reference's shard_map body (slots exchanged with ``all_to_all`` over
the axis's process group, parallel/collectives.py), ``moe_ffn_sharded`` its
global entry.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.parallel.collectives import (CollectiveGroup, all_to_all,
                                                allreduce, to_global,
                                                to_local)
from ray_tpu_torch.parallel.mesh import AXIS_EXPERT, use_mesh

def capacity(n_tokens: int, n_experts: int, capacity_factor: float) -> int:
    """Slots an expert: ``max(1, int(T * cf / E))``, truncated as the
    reference truncates (Python's ``int``)."""
    return max(1, int(n_tokens * capacity_factor / n_experts))


def top1_dispatch(logits: torch.Tensor, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits [T, E] -> (dispatch [T, E, C] 0/1 f32, combine [T, E, C] f32
    = dispatch × the chosen expert's probability, the load-balancing aux
    loss: E × Σ_e frac_e × mean_prob_e, f32). The softmax runs in the
    logits' dtype; ``argmax`` takes the first of equal probabilities."""
    T, E = logits.shape
    f32 = torch.float32
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1, keepdim=True)            # [T, 1]
    prob = probs.gather(1, expert)[:, 0]
    onehot = torch.zeros((T, E), dtype=f32, device=logits.device)
    onehot.scatter_(1, expert, 1.0)
    # each token's position in its expert's queue
    position = (torch.cumsum(onehot, dim=0) - 1.0) * onehot       # [T, E]
    keep = (position < capacity) & (onehot > 0)
    slot = torch.where(keep, position, 0.0).long()
    # dispatch[t, e, slot[t, e]] = keep[t, e]; no int64 one-hot of [T, E, C]
    dispatch = torch.zeros((T, E, capacity), dtype=f32, device=logits.device)
    dispatch.scatter_(2, slot[..., None], keep[..., None].to(f32))
    combine = dispatch * prob[:, None, None]
    frac = onehot.mean(dim=0)
    mean_prob = probs.mean(dim=0)
    aux = E * torch.sum(frac * mean_prob)
    return dispatch, combine, aux


def moe_ffn_reference(tokens: torch.Tensor, w_router: torch.Tensor,
                      w_in_full: torch.Tensor, w_out_full: torch.Tensor,
                      capacity_factor: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [T, D], w_router [D, E], w_in_full [E, D, F], w_out_full
    [E, F, D] -> (y [T, D] f32, aux f32 scalar): the single-device path,
    with the reference's routing and capacity."""
    T, _D = tokens.shape
    E = w_in_full.shape[0]
    f32 = torch.float32
    logits = tokens @ w_router
    dispatch, combine, aux = top1_dispatch(
        logits, capacity(T, E, capacity_factor))
    slots = torch.einsum("tec,td->ecd", dispatch, tokens.to(f32))
    out = _expert_ffn(slots, w_in_full, w_out_full)
    return torch.einsum("tec,ecd->td", combine, out), aux


def _expert_ffn(slots: torch.Tensor, w_in: torch.Tensor,
                w_out: torch.Tensor) -> torch.Tensor:
    """Every expert's GELU FFN on its slots, [E, C, D] -> [E, C, D], f32."""
    f32 = torch.float32
    h = F.gelu(torch.einsum("ecd,edf->ecf", slots, w_in.to(f32)),
               approximate="tanh")
    return torch.einsum("ecf,efd->ecd", h, w_out.to(f32))


def moe_ffn_local(tokens: torch.Tensor, w_router: torch.Tensor,
                  w_in: torch.Tensor, w_out: torch.Tensor,
                  capacity_factor: float, axis_name: str = AXIS_EXPERT
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's shard_map body, which every rank of ``axis_name``'s
    group of the current mesh (a ``RankMesh``) runs: tokens [T, D] (this
    rank's rows), w_router [D, E_total], w_in [E_local, D, F], w_out
    [E_local, F, D] (this rank's experts). Routes its rows against every
    expert with per-shard capacity, sends each expert's slots to the rank
    that holds it with ``all_to_all`` and the results back the same way.
    Returns ([T, D] f32 outputs combined per token, the aux loss averaged
    over the group)."""
    n = CollectiveGroup(axis_name).world_size()
    T, D = tokens.shape
    e_local = w_in.shape[0]
    E = e_local * n
    cap = capacity(T, E, capacity_factor)
    logits = tokens @ w_router
    dispatch, combine, aux = top1_dispatch(logits, cap)
    slots = torch.einsum("tec,td->ecd", dispatch, tokens.to(torch.float32))
    # exchange: rank j gets every rank's slots of its experts
    slots = all_to_all(slots.reshape(n, e_local, cap, D), axis_name, 0, 0)
    slots = slots.movedim(0, 1).reshape(e_local, n * cap, D)
    out = _expert_ffn(slots, w_in, w_out)
    # reverse exchange: each rank's tokens' results back to it
    out = out.reshape(e_local, n, cap, D).movedim(1, 0)
    out = all_to_all(out, axis_name, 0, 0).reshape(E, cap, D)
    y = torch.einsum("tec,ecd->td", combine, out)
    return y, allreduce(aux, axis_name, "mean")


def moe_ffn_sharded(tokens: torch.Tensor, w_router: torch.Tensor,
                    w_in: torch.Tensor, w_out: torch.Tensor, mesh,
                    capacity_factor: float = 1.25,
                    axis_name: str = AXIS_EXPERT
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global entry: tokens [T, D] (token rows split over ``axis_name``),
    w_in / w_out [E, ...] (experts split over it), the router replicated.
    Per-shard routing: each shard routes ITS tokens against all experts with
    per-shard capacity (the standard data-local formulation), so the result
    equals ``moe_ffn_reference`` on each shard's rows with the full weights,
    and aux their mean. Under a ``RankMesh`` every rank calls it with the
    same global tensors and runs ``moe_ffn_local`` on its shard; under a
    local-device ``Mesh`` one process routes each shard in turn."""
    n = mesh.shape[axis_name]
    if tokens.shape[0] % n:
        raise ValueError(f"moe_ffn_sharded: {tokens.shape[0]} token rows do "
                         f"not split into {n} shards over {axis_name!r}")
    if mesh.spans_ranks:
        rows, experts = (axis_name, None), (axis_name, None, None)
        with use_mesh(mesh):
            y, aux = moe_ffn_local(
                to_local(tokens, rows, mesh),
                to_local(w_router, (None, None), mesh),
                to_local(w_in, experts, mesh), to_local(w_out, experts, mesh),
                capacity_factor, axis_name)
            return to_global(y, rows, mesh), to_global(aux, (), mesh)
    outs = [moe_ffn_reference(shard, w_router, w_in, w_out, capacity_factor)
            for shard in tokens.chunk(n)]
    return (torch.cat([y for y, _ in outs]),
            torch.stack([a for _, a in outs]).mean())
