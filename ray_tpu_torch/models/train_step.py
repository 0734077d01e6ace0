"""Training step for the flagship transformer, on one device.

Counterpart of ``ray_tpu/models/train_step.py`` (``make_optimizer``,
``make_train_step``, ``make_forward``) on the port's ``Transformer``:
forward, loss, backward and an AdamW update, eagerly. On the card,
attention runs the hand-written flash kernels forward and backward
(ops/flash.py). The reference is functional and returns new params and
optimizer state; here the model's parameters and the optimizer's state
update IN PLACE. The mesh pieces (``init_sharded``, ``abstract_state``,
``mesh_shardings``) wait for the ``torch.distributed`` slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import torch

from ray_tpu_torch.models.transformer import Transformer, cross_entropy_loss


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   learning_rate: float = 3e-4,
                   weight_decay: float = 0.01) -> torch.optim.AdamW:
    """``optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=wd)``: AdamW with
    eps 1e-8 decaying every parameter (optax applies no mask by default).
    PyTorch's decoupled decay, ``p *= 1 - lr*wd`` before the Adam step,
    equals optax's ``-lr * (adam + wd * p)`` update."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.95),
                             eps=1e-8, weight_decay=weight_decay)


def _global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm over all the tensors."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


def make_train_step(model: Transformer, optimizer: torch.optim.Optimizer
                    ) -> Callable[[Dict[str, torch.Tensor]],
                                  Dict[str, torch.Tensor]]:
    """Returns ``train_step(batch) -> {"loss", "grad_norm"}`` with batch =
    {"tokens": [B, S] int} (next-token LM: the model sees
    ``tokens[:, :-1]`` and predicts ``tokens[:, 1:]``). ``grad_norm`` is the
    global L2 norm of the gradients before the update. A MoE model's loss
    adds ``0.01 * sum(mean(aux))`` over its layers' load-balancing terms,
    as the reference does; a dense model has none. The step updates the
    model's parameters in place; both metrics are 0-dim tensors on the
    model's device (reading them syncs the host)."""
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        tokens = batch["tokens"]
        optimizer.zero_grad(set_to_none=True)
        logits, aux_terms = model(tokens[:, :-1], return_aux=True)
        loss = cross_entropy_loss(logits, tokens[:, 1:])
        del logits
        if aux_terms:
            loss = loss + 0.01 * sum(torch.mean(a) for a in aux_terms)
        loss.backward()
        gnorm = _global_norm([p.grad for p in params if p.grad is not None])
        optimizer.step()
        return {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def make_forward(model: Transformer) -> Callable[[torch.Tensor],
                                                 torch.Tensor]:
    """``forward(tokens) -> logits`` in the compute dtype, without
    gradients."""

    def forward(tokens: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return model(tokens)

    return forward
