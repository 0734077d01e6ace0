"""Device mesh and logical sharding rules, for torch devices and ranks.

Counterpart of ``ray_tpu/parallel/mesh.py``: the same axis names,
``MeshConfig`` and logical rules (copied, not imported), and a per-context
``use_mesh`` / ``current_mesh`` stack. The reference builds a
``jax.sharding.Mesh`` over which XLA partitions a program. The port has two
forms of mesh, with the same ``shape`` and ``axis_names``:

- ``Mesh`` (``make_mesh``): one process holds every device of the mesh, as
  the reference's single controller does; a small record of
  ``torch.device``s that the in-process ring (ops/ring_attention.py) reads
  to place each sequence shard. A device may repeat, so one card can hold a
  ``seq=4`` mesh.
- ``RankMesh`` (``make_rank_mesh``, ``distributed.global_mesh``): one
  process per mesh position over ``torch.distributed``, a process group per
  named axis (a ``DeviceMesh`` with the six axis names) and this rank's
  coordinate on each; the collectives (parallel/collectives.py) run over
  its groups, and every rank runs the reference's ``shard_map`` bodies on
  its own shard.

``logical_sharding`` maps logical axis names to the mesh-axis spec the
reference builds (a ``PartitionSpec``'s entries) and to the DTensor
placements that realise it. ``data_local`` marks mesh axes whose ranks
already hold different data (a train step's batch split), so that a global
entry neither slices nor reduces over them.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

AXIS_DATA = "data"      # data parallelism (batch split, grads all-reduced)
AXIS_FSDP = "fsdp"      # fully-sharded data parallel (params sharded too)
AXIS_TENSOR = "tensor"  # tensor/model parallelism (heads, ffn split)
AXIS_SEQ = "seq"        # sequence/context parallelism (ring attention)
AXIS_PIPE = "pipe"      # pipeline stages
AXIS_EXPERT = "expert"  # MoE expert parallelism


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes per mesh axis; axes of size 1 are still present (so sharding
    specs are stable across configurations). Product must equal the
    device count used."""
    data: int = 1
    fsdp: int = 1
    pipe: int = 1
    expert: int = 1
    seq: int = 1
    tensor: int = 1

    def axis_sizes(self) -> Tuple[Tuple[str, int], ...]:
        return ((AXIS_DATA, self.data), (AXIS_FSDP, self.fsdp),
                (AXIS_PIPE, self.pipe), (AXIS_EXPERT, self.expert),
                (AXIS_SEQ, self.seq), (AXIS_TENSOR, self.tensor))

    @property
    def num_devices(self) -> int:
        n = 1
        for _, s in self.axis_sizes():
            n *= s
        return n

    @staticmethod
    def for_devices(n: int) -> "MeshConfig":
        """A reasonable default decomposition for n devices: favor fsdp
        (cheapest to scale for training) then data, then tensor."""
        if n == 1:
            return MeshConfig()
        tensor = 1
        for t in (2,):
            if n % t == 0 and n > 2:
                tensor = t
        rest = n // tensor
        fsdp = 1
        while rest % 2 == 0 and fsdp < 8:
            fsdp *= 2
            rest //= 2
        return MeshConfig(data=rest, fsdp=fsdp, tensor=tensor)


class Mesh:
    """Devices laid out over named axes. ``devices`` is an object array of
    ``torch.device``s whose dimensions follow ``axis_names``; ``shape`` is
    the ordered ``{axis: size}``, as ``jax.sharding.Mesh.shape``."""

    spans_ranks = False

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(config: Optional[MeshConfig] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``Mesh`` with the canonical axis names over ``devices`` (default:
    every CUDA device; raises without one). Later axes vary fastest over
    the device order, as in the reference."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh with no devices means every CUDA device, and none "
                "is available; pass devices=['cpu'] * n for a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if config is None:
        config = MeshConfig.for_devices(len(devices))
    if config.num_devices != len(devices):
        raise ValueError(
            f"mesh config {config} needs {config.num_devices} devices, "
            f"got {len(devices)}")
    shape = [s for _, s in config.axis_sizes()]
    names = [a for a, _ in config.axis_sizes()]
    flat = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        flat[i] = d
    return Mesh(flat.reshape(shape), tuple(names))


class RankMesh:
    """Ranks laid out over named axes: this process is one mesh position.
    ``shape`` and ``axis_names`` as ``Mesh``'s; ``group(axis)`` is the
    process group of the ranks that differ from this one only along
    ``axis`` (ordered by their coordinate on it), ``coordinate(axis)`` this
    rank's position on it, ``device`` this rank's device.
    ``device_mesh`` is a ``DeviceMesh`` over all six axes;
    ``dtensor_mesh`` the one DTensors live on, over ``dtensor_axes`` (the
    axes larger than 1, the same ranks in the same order): DTensor plans
    each op over every dimension of its mesh, which on six dimensions
    costs seconds an op."""

    spans_ranks = True

    def __init__(self, device_mesh, device: torch.device, dtensor_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.device = device
        self.dtensor_mesh = dtensor_mesh
        self.dtensor_axes = tuple(dtensor_mesh.mesh_dim_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.device_mesh.shape))

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)


def make_rank_mesh(config: Optional[MeshConfig] = None) -> RankMesh:
    """A ``RankMesh`` with the canonical axis names over every rank of the
    process group (``distributed.init_multihost`` first). Later axes vary
    fastest over the ranks, as over the devices in the reference."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ray_tpu_torch.parallel import distributed

    if not distributed.is_initialized():
        raise RuntimeError("make_rank_mesh: call init_multihost on every "
                           "rank first")
    n = dist.get_world_size()
    if config is None:
        config = MeshConfig.for_devices(n)
    if config.num_devices != n:
        raise ValueError(f"mesh config {config} needs {config.num_devices} "
                         f"ranks, the process group has {n}")
    device = distributed.device()
    names = tuple(a for a, _ in config.axis_sizes())
    shape = tuple(s for _, s in config.axis_sizes())
    full = init_device_mesh(device.type, shape, mesh_dim_names=names)
    big = [(a, s) for a, s in config.axis_sizes() if s > 1] or [(names[0], 1)]
    dtensor_mesh = init_device_mesh(
        device.type, tuple(s for _, s in big),
        mesh_dim_names=tuple(a for a, _ in big))
    return RankMesh(full, device, dtensor_mesh)


# per-context stack (tuple, immutable): threads and async tasks each see
# only their own active mesh
_CURRENT_MESH: contextvars.ContextVar[Tuple] = contextvars.ContextVar(
    "ray_tpu_torch_mesh_stack", default=())


@contextlib.contextmanager
def use_mesh(mesh: Mesh) -> Iterator[Mesh]:
    """Makes ``mesh`` the current mesh of this context, for code that asks
    for it (the ring attention path asking "is there a seq axis > 1?").
    There is no framework mesh to enter as well."""
    token = _CURRENT_MESH.set(_CURRENT_MESH.get() + (mesh,))
    try:
        yield mesh
    finally:
        _CURRENT_MESH.reset(token)


def current_mesh() -> Optional[Mesh]:
    """The innermost use_mesh() mesh of THIS context, or None."""
    stack = _CURRENT_MESH.get()
    return stack[-1] if stack else None


def default_logical_rules() -> List[Tuple[str, object]]:
    """Logical-axis -> mesh-axis mapping for the model family.

    Parameters:
      vocab   -> tensor     (embedding/output vocab split)
      embed   -> fsdp       (d_model axis of weights: ZeRO-3 style shard)
      heads   -> tensor     (attention heads split across chips)
      mlp     -> tensor     (ffn hidden split)
    Activations:
      batch     -> (data, fsdp)  (global batch split across both axes)
      act_seq   -> seq           (sequence/context parallelism)
      act_embed -> None          (activation hidden replicated)
    """
    return [
        ("vocab", AXIS_TENSOR),
        ("embed", AXIS_FSDP),
        ("heads", AXIS_TENSOR),
        ("kv_heads", AXIS_TENSOR),
        ("mlp", AXIS_TENSOR),
        ("experts", AXIS_EXPERT),
        ("layers", None),
        ("batch", (AXIS_DATA, AXIS_FSDP)),
        ("act_seq", AXIS_SEQ),
        ("act_embed", None),
        ("head_dim", None),
    ]


@dataclasses.dataclass(frozen=True)
class LogicalSharding:
    """``spec``: one entry per tensor dimension, None (replicated), a mesh
    axis, or a tuple of mesh axes (major first), as the reference's
    ``PartitionSpec``; ``placements``: one DTensor placement per axis of
    the mesh's DTensor mesh (``RankMesh.dtensor_axes``; every axis of a
    local ``Mesh``): ``Shard(dim)`` where the axis splits ``dim``, else
    ``Replicate()``. A dimension over two axes is ``Shard(dim)`` on both,
    the earlier axis the outer split, as in the reference's spec."""
    spec: Tuple[object, ...]
    placements: Tuple[object, ...]

    def axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes that split tensor dimension ``dim``."""
        entry = self.spec[dim]
        if entry is None:
            return ()
        return (entry,) if isinstance(entry, str) else tuple(entry)


def logical_sharding(mesh, logical_axes: Sequence[Optional[str]],
                     rules: Optional[List[Tuple[str, object]]] = None
                     ) -> LogicalSharding:
    """The sharding of an array whose dims carry the given logical axis
    names (None = replicated dim), under ``rules`` (default
    ``default_logical_rules``): the spec the reference's ``NamedSharding``
    holds, and the placements over ``mesh``'s axes."""
    from torch.distributed.tensor import Replicate, Shard

    table = dict(rules if rules is not None else default_logical_rules())
    spec = tuple(None if ax is None else table.get(ax)
                 for ax in logical_axes)
    axes = getattr(mesh, "dtensor_axes", mesh.axis_names)
    placements = [Replicate()] * len(axes)
    for dim, entry in enumerate(spec):
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            if axis not in axes:
                continue          # an axis of size 1 splits nothing
            i = axes.index(axis)
            if not isinstance(placements[i], Replicate):
                raise ValueError(f"logical_sharding: mesh axis {axis!r} "
                                 f"splits two dimensions of {spec}")
            placements[i] = Shard(dim)
    return LogicalSharding(spec, tuple(placements))


_DATA_LOCAL: contextvars.ContextVar[Tuple[str, ...]] = contextvars.ContextVar(
    "ray_tpu_torch_data_local_axes", default=())


@contextlib.contextmanager
def data_local(axes: Sequence[str]) -> Iterator[Tuple[str, ...]]:
    """Marks mesh ``axes`` whose ranks already hold different data (a
    train step that split its batch over (data, fsdp)): inside, a global
    entry takes each rank's tensors as the whole over those axes, so it
    neither slices them nor reduces over them."""
    token = _DATA_LOCAL.set(tuple(_DATA_LOCAL.get()) + tuple(axes))
    try:
        yield _DATA_LOCAL.get()
    finally:
        _DATA_LOCAL.reset(token)


def data_local_axes() -> Tuple[str, ...]:
    return _DATA_LOCAL.get()
