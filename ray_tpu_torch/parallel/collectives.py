"""Process-group collectives over a named axis of a mesh that spans ranks.

Counterpart of ``ray_tpu/parallel/collectives.py`` (copied, not imported):
``CollectiveGroup`` and ``allreduce`` … ``send_recv`` with the reference's
names and parameters. The reference's ops are ``lax.p*`` collectives that
mean something only inside ``shard_map``, where the axis is bound; here
they run over the process group of a named axis of the current mesh
(``use_mesh(distributed.global_mesh(...))``, parallel/mesh.py
``RankMesh``), which every rank of that group must call in the same order.

Each op is differentiable where the JAX op has a transpose, with the
transpose as its backward: ``allreduce`` sum (and mean) -> the same
allreduce, ``allgather`` -> ``reducescatter`` and back, ``send_recv`` ->
the opposite shift, ``all_to_all`` -> the exchange back, ``broadcast`` ->
the sum of the gradients on the root. Max and min have none: their result
carries no gradient.

Backends, each one fixed rule (never a reaction to an error):
- ``send_recv`` is one ``all_to_all_single`` in which only the
  neighbour's chunk is non-empty, on every backend;
- on a ``gloo`` group a tensor on a card goes through the host: copied to
  the CPU, exchanged there, copied back (gloo's transport is the host's);
- on a ``gloo`` group ``reducescatter`` is an allreduce whose chunk each
  rank keeps.
``stats()`` counts the calls and the bytes each collective hands the
backend from this rank, and the bytes staged through the host (both ways).

``to_local`` and ``to_global`` are the boundaries of a global entry (the
reference's ``shard_map`` ``in_specs`` / ``out_specs``): every rank calls
the entry with the same global tensors, takes its shard, runs the body
and gets the global result back, and autograd gives every rank the global
tensors' gradients.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
from typing import Dict, Sequence, Tuple

import torch

from ray_tpu_torch.parallel.mesh import current_mesh, data_local_axes

_lock = threading.Lock()
_calls: Dict[str, int] = collections.Counter()
_bytes: Dict[str, int] = collections.Counter()
_host = [0]


def stats() -> dict:
    """{"calls": {op: n}, "bytes": {op: bytes handed to the backend},
    "host_bytes": bytes copied card -> host and back} since the last
    ``reset_stats``."""
    with _lock:
        return {"calls": dict(_calls), "bytes": dict(_bytes),
                "host_bytes": _host[0]}


def reset_stats() -> None:
    with _lock:
        _calls.clear()
        _bytes.clear()
        _host[0] = 0


def _count(op: str, x: torch.Tensor) -> None:
    with _lock:
        _calls[op] += 1
        _bytes[op] += x.numel() * x.element_size()


def _count_host(x: torch.Tensor) -> None:
    with _lock:
        _host[0] += x.numel() * x.element_size()


@dataclasses.dataclass(frozen=True)
class CollectiveGroup:
    """A named mesh axis treated as a communicator group: the ranks of the
    current mesh that differ from this one only along ``axis_name``."""
    axis_name: str

    def world_size(self) -> int:
        return _Comm(self.axis_name).n

    def rank(self) -> int:
        return _Comm(self.axis_name).rank


def _rank_mesh(mesh=None):
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or not mesh.spans_ranks:
        raise RuntimeError(
            "collectives run over a mesh that spans ranks: "
            "use_mesh(distributed.global_mesh(config)) after init_multihost")
    return mesh


class _Comm:
    """One axis's group as an op needs it: the process group, its size,
    this rank's coordinate, and whether card tensors go through the host."""

    def __init__(self, axis, mesh=None):
        import torch.distributed as dist

        mesh = _rank_mesh(mesh)
        self.axis = axis.axis_name if isinstance(axis, CollectiveGroup) \
            else axis
        self.pg = mesh.group(self.axis)
        self.n = mesh.shape[self.axis]
        self.rank = mesh.coordinate(self.axis)
        self.gloo = dist.get_backend(self.pg) == "gloo"

    def stage(self, x: torch.Tensor):
        """(the tensor to hand the backend, the device to bring the result
        back to or None). Always a fresh contiguous tensor: the backends
        write in place."""
        if self.gloo and x.device.type != "cpu":
            _count_host(x)
            return x.detach().contiguous().cpu(), x.device
        return x.detach().clone(memory_format=torch.contiguous_format), None

    @staticmethod
    def back(y: torch.Tensor, device) -> torch.Tensor:
        if device is None:
            return y
        _count_host(y)
        return y.to(device)


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def _all_reduce(c: _Comm, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    import torch.distributed as dist

    if c.n == 1:
        return x.clone()
    _count("allreduce", x)
    y, dev = c.stage(x)
    dist.all_reduce(y, op=getattr(dist.ReduceOp, _OPS[op]), group=c.pg)
    return c.back(y, dev)


def _all_gather(c: _Comm, x: torch.Tensor, axis: int) -> torch.Tensor:
    import torch.distributed as dist

    if c.n == 1:
        return x.clone()
    _count("allgather", x)
    y, dev = c.stage(x)
    parts = [torch.empty_like(y) for _ in range(c.n)]
    dist.all_gather(parts, y, group=c.pg)
    return c.back(torch.cat(parts, dim=axis), dev)


def _reduce_scatter(c: _Comm, x: torch.Tensor, axis: int) -> torch.Tensor:
    import torch.distributed as dist

    if x.shape[axis] % c.n:
        raise ValueError(f"reducescatter: dimension {axis} of "
                         f"{tuple(x.shape)} does not split into {c.n}")
    if c.n == 1:
        return x.clone()
    _count("reducescatter", x)
    y, dev = c.stage(x.movedim(axis, 0))
    if c.gloo:
        dist.all_reduce(y, group=c.pg)
        out = y.chunk(c.n)[c.rank].clone()
    else:
        out = y.new_empty((y.shape[0] // c.n,) + tuple(y.shape[1:]))
        dist.reduce_scatter_tensor(out, y, group=c.pg)
    return c.back(out, dev).movedim(0, axis)


def _all_to_all(c: _Comm, x: torch.Tensor, split_axis: int, concat_axis: int,
                tiled: bool) -> torch.Tensor:
    import torch.distributed as dist

    if x.shape[split_axis] % c.n or (not tiled
                                     and x.shape[split_axis] != c.n):
        raise ValueError(f"all_to_all: dimension {split_axis} of "
                         f"{tuple(x.shape)} does not split into {c.n}")
    chunks = x.chunk(c.n, dim=split_axis)
    if not tiled:
        chunks = [t.squeeze(split_axis) for t in chunks]
    if c.n == 1:
        recv = torch.stack(chunks).clone()
    else:
        _count("all_to_all", x)
        y, dev = c.stage(torch.stack(chunks))
        out = torch.empty_like(y)
        dist.all_to_all_single(out, y, group=c.pg)
        recv = c.back(out, dev)
    parts = list(recv.unbind(0))
    return (torch.cat(parts, dim=concat_axis) if tiled
            else torch.stack(parts, dim=concat_axis))


def _shift(c: _Comm, x: torch.Tensor, shift: int) -> torch.Tensor:
    """Member i's tensor goes to member (i + shift) % n: one
    all_to_all_single with only that peer's chunk non-empty."""
    import torch.distributed as dist

    if c.n == 1 or shift % c.n == 0:
        return x.clone()
    _count("send_recv", x)
    y, dev = c.stage(x)
    numel = y.numel()
    dst, src = (c.rank + shift) % c.n, (c.rank - shift) % c.n
    out = torch.empty_like(y)
    dist.all_to_all_single(
        out.view(-1), y.view(-1),
        output_split_sizes=[numel if j == src else 0 for j in range(c.n)],
        input_split_sizes=[numel if j == dst else 0 for j in range(c.n)],
        group=c.pg)
    return c.back(out, dev)


def _broadcast(c: _Comm, x: torch.Tensor, root: int) -> torch.Tensor:
    import torch.distributed as dist

    if c.n == 1:
        return x.clone()
    _count("broadcast", x)
    y, dev = c.stage(x)
    dist.broadcast(y, src=dist.get_global_rank(c.pg, root), group=c.pg)
    return c.back(y, dev)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return _all_reduce(c, x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.c, g), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c, axis):
        ctx.c, ctx.axis = c, axis
        return _all_gather(c, x, axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(ctx.c, g, ctx.axis), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c, axis):
        ctx.c, ctx.axis = c, axis
        return _reduce_scatter(c, x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(ctx.c, g, ctx.axis), None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c, shift):
        ctx.c, ctx.shift = c, shift
        return _shift(c, x, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(ctx.c, g, -ctx.shift), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c, split_axis, concat_axis, tiled):
        ctx.args = (c, concat_axis, split_axis, tiled)
        return _all_to_all(c, x, split_axis, concat_axis, tiled)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(*((ctx.args[0], g) + ctx.args[1:])), None, None, \
            None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c, root):
        ctx.c, ctx.root = c, root
        return _broadcast(c, x, root)

    @staticmethod
    def backward(ctx, g):
        total = _all_reduce(ctx.c, g)
        if ctx.c.rank != ctx.root:
            total = torch.zeros_like(total)
        return total, None, None


# The ops below run over the process group of ``group``'s axis of the
# current mesh, with the reference's names and parameters.

def allreduce(x: torch.Tensor, group: "CollectiveGroup | str",
              op: str = "sum") -> torch.Tensor:
    c = _Comm(group)
    if op == "sum":
        return _AllReduceSum.apply(x, c)
    if op == "mean":
        return _AllReduceSum.apply(x, c) / c.n
    if op in ("max", "min"):
        with torch.no_grad():
            return _all_reduce(c, x, op)
    raise ValueError(f"unsupported allreduce op: {op}")


def allgather(x: torch.Tensor, group: "CollectiveGroup | str",
              axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """Every member's ``x`` concatenated along ``axis`` in member order
    (``tiled``), or stacked along a new ``axis``."""
    c = _Comm(group)
    if tiled:
        return _AllGather.apply(x, c, axis)
    return _AllGather.apply(x.unsqueeze(axis), c, axis)


def reducescatter(x: torch.Tensor, group: "CollectiveGroup | str",
                  axis: int = 0) -> torch.Tensor:
    """The sum over members, split along ``axis``: member i keeps chunk i."""
    return _ReduceScatter.apply(x, _Comm(group), axis)


def broadcast(x: torch.Tensor, group: "CollectiveGroup | str",
              root: int = 0) -> torch.Tensor:
    """Every member gets root's tensor."""
    return _Broadcast.apply(x, _Comm(group), root)


def barrier(group: "CollectiveGroup | str") -> int:
    """Waits for every member; returns the world size (the reference's
    token is psum(1))."""
    import torch.distributed as dist

    c = _Comm(group)
    dist.barrier(group=c.pg)
    return c.n


def send_recv(x: torch.Tensor, group: "CollectiveGroup | str",
              shift: int = 1) -> torch.Tensor:
    """Ring shift over the axis (ppermute): member i's tensor goes to member
    (i + shift) % world. The building block of ring attention and pipeline
    microbatch rotation."""
    return _Shift.apply(x, _Comm(group), shift)


def all_to_all(x: torch.Tensor, group: "CollectiveGroup | str",
               split_axis: int = 0, concat_axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """``lax.all_to_all``: ``x`` split along ``split_axis`` into one chunk
    per member, chunk j sent to member j, the received chunks concatenated
    (``tiled``) or stacked along ``concat_axis`` in member order. Untiled,
    ``split_axis`` has one entry per member."""
    return _AllToAll.apply(x, _Comm(group), split_axis, concat_axis, tiled)


# ----------------------------------------------------------------------
# global entries: a spec's shard of a global tensor, and back
# ----------------------------------------------------------------------

Spec = Tuple[object, ...]


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, an axis, or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def entry_spec(spec: Spec) -> Spec:
    """``spec`` without the axes that ``mesh.data_local`` marks."""
    local = data_local_axes()
    out = []
    for entry in spec:
        kept = tuple(a for a in spec_axes(entry) if a not in local)
        out.append(kept[0] if len(kept) == 1 else (kept or None))
    return tuple(out)


def _chunk(mesh, x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (axes major first)."""
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if not axes:
            continue
        parts = math.prod(mesh.shape[a] for a in axes)
        if x.shape[dim] % parts:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"split into {parts} shards over {axes}")
        index = 0
        for a in axes:
            index = index * mesh.shape[a] + mesh.coordinate(a)
        size = x.shape[dim] // parts
        x = x.narrow(dim, index * size, size)
    return x


def _gather(mesh, x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """The global tensor from every rank's block under ``spec``."""
    for dim, entry in enumerate(spec):
        for a in reversed(spec_axes(entry)):     # minor axis first
            x = _all_gather(_Comm(a, mesh), x, dim)
    return x


def _unmentioned(mesh, spec: Spec) -> Tuple[str, ...]:
    """The entry's axes of ``mesh`` that ``spec`` does not split: the
    tensor is replicated over them."""
    used = {a for entry in spec for a in spec_axes(entry)}
    local = data_local_axes()
    return tuple(a for a in mesh.axis_names
                 if a not in used and a not in local and mesh.shape[a] > 1)


class _ToLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.mesh, ctx.spec = mesh, spec
        return _chunk(mesh, x, spec).clone()

    @staticmethod
    def backward(ctx, g):
        mesh, spec = ctx.mesh, ctx.spec
        full = _gather(mesh, g, spec)
        for a in _unmentioned(mesh, spec):
            full = _all_reduce(_Comm(a, mesh), full)
        return full, None, None


class _ToGlobal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.mesh, ctx.spec = mesh, spec
        out = _gather(mesh, x, spec)
        return out.clone() if out is x else out

    @staticmethod
    def backward(ctx, g):
        mesh, spec = ctx.mesh, ctx.spec
        copies = math.prod(mesh.shape[a] for a in _unmentioned(mesh, spec))
        return _chunk(mesh, g, spec) / copies, None, None


def to_local(x: torch.Tensor, spec: Spec, mesh=None) -> torch.Tensor:
    """A global entry's input: this rank's block of the global ``x`` that
    every rank of the entry holds (``shard_map``'s ``in_specs``). The
    gradient is the global one on every rank: the blocks' gradients
    gathered, summed over the axes the spec replicates."""
    mesh = _rank_mesh(mesh)
    return _ToLocal.apply(x, mesh, entry_spec(spec))


def to_global(x: torch.Tensor, spec: Spec, mesh=None) -> torch.Tensor:
    """A global entry's output: the global tensor from every rank's block
    (``shard_map``'s ``out_specs``; over an axis the spec does not name,
    the ranks hold equal blocks). Its gradient, the same on every rank,
    goes back to each block once."""
    mesh = _rank_mesh(mesh)
    return _ToGlobal.apply(x, mesh, entry_spec(spec))


def local_block(x: torch.Tensor, spec: Spec, mesh=None) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (a view; no gradient
    path)."""
    return _chunk(_rank_mesh(mesh), x, spec)


def shard_rows(x: torch.Tensor, axes: Sequence[str], mesh=None
               ) -> torch.Tensor:
    """This rank's rows of ``x`` split over ``axes`` (major first), without
    a gradient path: how a train step splits its batch."""
    mesh = _rank_mesh(mesh)
    return _chunk(mesh, x, (tuple(axes),) + (None,) * (x.dim() - 1))


def gather_spec(x: torch.Tensor, spec: Spec, mesh=None) -> torch.Tensor:
    """The global tensor from this rank's block under ``spec`` (no
    gradient path)."""
    return _gather(_rank_mesh(mesh), x, spec)


def reduce_spec(g: torch.Tensor, spec: Spec, mesh=None) -> torch.Tensor:
    """The sum over every rank of the mesh of ``g`` (a full-size tensor),
    split to this rank's block under ``spec``: reducescatter over the axes
    the spec splits, allreduce over the others."""
    mesh = _rank_mesh(mesh)
    used = set()
    for dim, entry in enumerate(spec):
        for a in spec_axes(entry):               # major axis first
            g = _reduce_scatter(_Comm(a, mesh), g, dim)
            used.add(a)
    for a in mesh.axis_names:
        if a not in used and mesh.shape[a] > 1:
            g = _all_reduce(_Comm(a, mesh), g)
    return g

