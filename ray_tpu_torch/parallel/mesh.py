"""Device mesh and logical sharding rules, for torch devices.

Counterpart of ``ray_tpu/parallel/mesh.py``: the same axis names,
``MeshConfig`` and logical rules (copied, not imported), and a per-context
``use_mesh`` / ``current_mesh`` stack. The reference builds a
``jax.sharding.Mesh`` over which XLA partitions a program; here ``Mesh`` is
a small record of ``torch.device``s shaped like it, which the ring
attention path (ops/ring_attention.py) reads to place each sequence shard.
One process holds every device of the mesh, as the reference's single
controller does. A device may repeat, so one card can hold a ``seq=4``
mesh. ``logical_sharding`` and the collectives wait for sharded training
on ``torch.distributed`` (ROADMAP.md, Queue A).
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
