"""Training step for the flagship transformer, on one device or sharded
over ranks.

Counterpart of ``ray_tpu/models/train_step.py`` (``make_optimizer``,
``abstract_state``, ``mesh_shardings``, ``init_sharded``,
``make_train_step``, ``make_forward``) on the port's ``Transformer``:
forward, loss, backward and an AdamW update, eagerly. On one card,
attention runs the hand-written flash kernels forward and backward
(ops/flash.py). The reference is functional and returns new params and
optimizer state; here the model's parameters and the optimizer's state
update IN PLACE.

Sharded (a ``RankMesh``, parallel/mesh.py): ``init_sharded`` gives each
parameter the layout its logical axes ask for under the rules
(``logical_sharding``: a DTensor over the mesh's ``DeviceMesh``, each rank
holding its block), drawing each parameter in turn and keeping only its
block. The reference's XLA partitioner then splits every op of the jitted
step; the port's eager step instead redistributes explicitly. Each rank
takes its rows of the batch (split over the ``batch`` rule's axes, (data,
fsdp)), gathers every parameter to its full value at the start of the
step (an allgather over the axes that split it, parallel/collectives.py),
and runs the model on its rows, the mesh active: attention and MoE take
their global entries there (the ring across the seq axis, the experts
across the expert axis), which split heads, sequence and experts among
the ranks that share the rows; every other op runs whole on each rank. In
the backward each full gradient is summed over every rank and split back
to the rank's block (reducescatter over the splitting axes, allreduce over
the rest), which with each rank's loss divided by the rank count is the
gradient of the global batch's mean loss. AdamW then updates each DTensor
block in place, which keeps the layouts (the reference pins them with
``with_sharding_constraint``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterable, Mapping, Tuple

import torch

from ray_tpu_torch.models.transformer import (Transformer, TransformerConfig,
                                              cross_entropy_loss,
                                              draw_params, param_axes)
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel import mesh as mesh_lib


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


# ----------------------------------------------------------------------
# sharded layouts
# ----------------------------------------------------------------------

def abstract_state(config: TransformerConfig, batch_size: int, seq_len: int):
    """Shapes + logical specs without allocating anything: (the model on
    the ``meta`` device, {name: its meta parameter}, {name: logical
    axes}). Names are the flat "/"-joined flax paths. The batch and
    sequence sizes are the reference's arguments; the shapes do not depend
    on them."""
    model = Transformer(config, device="meta")
    abs_vars = {name.replace(".", "/"): p
                for name, p in model.named_parameters()}
    return model, abs_vars, param_axes(config)


def mesh_shardings(mesh, logical_specs: Mapping[str, tuple], rules=None
                   ) -> Dict[str, mesh_lib.LogicalSharding]:
    """Logical axes by parameter name -> ``LogicalSharding`` on the mesh
    (spec and DTensor placements)."""
    return {name: mesh_lib.logical_sharding(mesh, axes, rules)
            for name, axes in logical_specs.items()}


def _owner(model: torch.nn.Module, name: str):
    """(the submodule holding parameter ``name``, its attribute name)."""
    path, _, attr = name.replace("/", ".").rpartition(".")
    return (model.get_submodule(path) if path else model), attr


def _install(model: Transformer, tensors: Iterable[Tuple[str, torch.Tensor]],
             mesh, shardings: Mapping[str, mesh_lib.LogicalSharding]
             ) -> Dict[str, torch.nn.Parameter]:
    """Each full tensor in turn -> this rank's block as a DTensor parameter
    of ``model``; the full tensor is dropped before the next."""
    from torch.distributed.tensor import DTensor

    params = {}
    for name, full in tensors:
        sh = shardings[name]
        full = full.to(mesh.device, torch.float32)
        block = collectives.local_block(full, sh.spec, mesh).contiguous()
        dt = DTensor.from_local(block, mesh.dtensor_mesh, sh.placements,
                                run_check=False, shape=full.shape,
                                stride=full.stride())
        del full
        owner, attr = _owner(model, name)
        param = torch.nn.Parameter(dt)
        setattr(owner, attr, param)
        params[name] = param
    if set(params) != set(shardings):
        raise ValueError(f"parameters {sorted(set(shardings) ^ set(params))} "
                         "missing or unknown")
    model.mesh = mesh
    return params


def init_sharded(config: TransformerConfig, mesh, batch_size: int,
                 seq_len: int, seed: int = 0, rules=None):
    """Initialize params DIRECTLY in their sharded layout (no full host
    copy): every rank draws each parameter in turn from a generator seeded
    with ``seed`` on its device (``init_params``'s draws, so the values
    equal ``init_params(config, Generator.manual_seed(seed))``) and keeps
    its block. Returns (model, {name: DTensor parameter}, {name:
    LogicalSharding})."""
    model, _abs, logical_specs = abstract_state(config, batch_size, seq_len)
    shardings = mesh_shardings(mesh, logical_specs, rules)
    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    params = _install(model, draw_params(config, gen), mesh, shardings)
    return model, params, shardings


def load_sharded(config: TransformerConfig, params: Mapping[str, torch.Tensor],
                 mesh, rules=None):
    """``init_sharded`` from given full parameters (``params_from_jax``'s
    or ``init_params``'s): each rank keeps its block of each."""
    model, _abs, logical_specs = abstract_state(config, 0, 0)
    shardings = mesh_shardings(mesh, logical_specs, rules)
    return model, _install(model, params.items(), mesh, shardings), shardings


class _GatherParam(torch.autograd.Function):
    """A parameter's block -> its full value (allgather over the axes that
    split it); backward: the full gradient summed over every rank, split
    back to this rank's block."""

    @staticmethod
    def forward(ctx, block, mesh, spec):
        ctx.mesh, ctx.spec = mesh, spec
        return collectives.gather_spec(block, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        return collectives.reduce_spec(g, ctx.spec, ctx.mesh), None, None


@contextlib.contextmanager
def _swapped(model: torch.nn.Module, tensors: Mapping[str, torch.Tensor]):
    """The model reads ``tensors`` in place of its parameters (forward and
    backward, so a block recomputed under remat reads them too)."""
    saved = []
    try:
        for name, t in tensors.items():
            owner, attr = _owner(model, name)
            saved.append((owner, attr, owner._parameters.pop(attr)))
            setattr(owner, attr, t)
        yield
    finally:
        for owner, attr, param in reversed(saved):
            delattr(owner, attr)
            owner.register_parameter(attr, param)


def _batch_axes(mesh, rules) -> Tuple[str, ...]:
    table = dict(rules if rules is not None
                 else mesh_lib.default_logical_rules())
    return collectives.spec_axes(table.get("batch"))


def _sharded_norm(named, shardings, mesh) -> torch.Tensor:
    """The global L2 norm of DTensor gradients: each block's squares,
    summed over the axes that split the parameter."""
    sums: Dict[Tuple[str, ...], torch.Tensor] = {}
    for name, p in named:
        if p.grad is None:
            continue
        axes = tuple(sorted({a for e in shardings[name].spec
                             for a in collectives.spec_axes(e)}))
        sq = p.grad.to_local().float().pow(2).sum()
        sums[axes] = sums.get(axes, 0) + sq
    total = torch.zeros((), dtype=torch.float32, device=mesh.device)
    with torch.no_grad():
        for axes, sq in sums.items():
            for a in axes:
                sq = collectives.allreduce(sq, a)
            total = total + sq
    return total.sqrt()


def _sharded_step(model: Transformer, optimizer, rules, param_shardings):
    mesh = model.mesh
    named = [(name.replace(".", "/"), p)
             for name, p in model.named_parameters() if p.requires_grad]
    shardings = mesh_shardings(mesh, param_axes(model.cfg), rules)
    batch_axes = _batch_axes(mesh, rules)
    groups = math.prod(mesh.shape[a] for a in batch_axes)
    world = math.prod(mesh.shape.values())

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        tokens = batch["tokens"].to(mesh.device)
        rows = collectives.shard_rows(tokens, batch_axes, mesh)
        optimizer.zero_grad(set_to_none=True)
        with mesh_lib.use_mesh(mesh), mesh_lib.data_local(batch_axes):
            full = {name: _GatherParam.apply(p.to_local(), mesh,
                                             shardings[name].spec)
                    for name, p in named}
            with _swapped(model, full):
                logits, aux_terms = model(rows[:, :-1], return_aux=True)
                loss = cross_entropy_loss(logits, rows[:, 1:])
                del logits
                if aux_terms:
                    loss = loss + 0.01 * sum(torch.mean(a) for a in aux_terms)
                (loss / world).backward()
            del full
            gnorm = _sharded_norm(named, shardings, mesh)
            optimizer.step()
            total = loss.detach()
            for a in batch_axes:
                total = collectives.allreduce(total, a)
        if param_shardings is not None:
            for name, p in named:
                want = param_shardings[name].placements
                if tuple(p.placements) != tuple(want):
                    raise RuntimeError(f"train_step: {name} left its layout "
                                       f"{want} for {p.placements}")
        return {"loss": total / groups, "grad_norm": gnorm}

    return train_step


def make_train_step(model: Transformer, optimizer: torch.optim.Optimizer,
                    rules=None, param_shardings=None
                    ) -> Callable[[Dict[str, torch.Tensor]],
                                  Dict[str, torch.Tensor]]:
    """Returns ``train_step(batch) -> {"loss", "grad_norm"}`` with batch =
    {"tokens": [B, S] int} (next-token LM: the model sees
    ``tokens[:, :-1]`` and predicts ``tokens[:, 1:]``). ``grad_norm`` is the
    global L2 norm of the gradients before the update. A MoE model's loss
    adds ``0.01 * sum(mean(aux))`` over its layers' load-balancing terms,
    as the reference does; a dense model has none. The step updates the
    model's parameters in place; both metrics are 0-dim tensors on the
    model's device (reading them syncs the host).

    A model from ``init_sharded`` / ``load_sharded`` takes the sharded step:
    every rank calls it with the same global batch, and ``loss`` is the
    global batch's mean. ``param_shardings`` (from ``init_sharded``) are the
    layouts each parameter must keep after the update; a change raises."""
    mesh = getattr(model, "mesh", None)
    if mesh is not None and mesh.spans_ranks:
        return _sharded_step(model, optimizer, rules, param_shardings)
    if param_shardings is not None:
        raise ValueError("make_train_step: param_shardings needs a model "
                         "from init_sharded")
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
    gradients. Under a ``RankMesh`` every rank calls it with the same
    tokens and gets the same logits; attention's and MoE's entries split
    their work across the ranks."""

    def forward(tokens: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return model(tokens)

    return forward

