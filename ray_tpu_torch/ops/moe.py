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
The ``expert``-axis path (``moe_ffn_local`` / ``moe_ffn_sharded``, an
``all_to_all`` over the mesh) waits for sharded training.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

_SHARDED = ("the expert-parallel MoE path (all_to_all over the mesh's "
            "expert axis) waits for ROADMAP.md, Queue A: sharded training "
            "on torch.distributed; without an expert axis the model runs "
            "moe_ffn_reference")


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
    h = F.gelu(torch.einsum("ecd,edf->ecf", slots, w_in_full.to(f32)),
               approximate="tanh")
    out = torch.einsum("ecf,efd->ecd", h, w_out_full.to(f32))
    return torch.einsum("tec,ecd->td", combine, out), aux


def moe_ffn_local(*args, **kwargs):
    """The reference's shard_map body (``all_to_all`` over ``expert``)."""
    raise NotImplementedError(f"moe_ffn_local: {_SHARDED}")


def moe_ffn_sharded(*args, **kwargs):
    """The reference's global expert-parallel entry."""
    raise NotImplementedError(f"moe_ffn_sharded: {_SHARDED}")
