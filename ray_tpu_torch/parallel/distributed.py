"""The multi-process device runtime: one ``torch.distributed`` process group.

Counterpart of ``ray_tpu/parallel/distributed.py`` (copied, not imported).
The reference joins the JAX distributed runtime once per host process,
after which a mesh laid over every process's chips makes XLA emit the
collectives. Here each process is one rank of a ``torch.distributed``
process group and owns one device; ``global_mesh`` lays the canonical
mesh axes over the ranks (parallel/mesh.py ``RankMesh``), with one
process group per named axis, and the collectives (parallel/collectives.py)
run over those groups.

The backend is decided once, at init, from what the ranks hold: ``nccl``
when every rank has a card of its own (CUDA present and no more ranks than
cards), ``gloo`` otherwise, which covers the CPU and several ranks sharing
one card (NCCL refuses two ranks on one device). There is no switch of
backend after an error. Rank r takes ``cuda:(r % device_count)``.

Wiring points, as in the reference: ``python -m ray_tpu_torch start
--jax-coordinator/--jax-num-processes/--jax-process-id`` calls
``init_multihost`` (the flag and environment names stay the reference's).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch

logger = logging.getLogger(__name__)

# the device a rank runs on when the caller names none; "cpu" for tests
DEVICE_ENV = "RAY_TPU_TORCH_DIST_DEVICE"
DEFAULT_TIMEOUT_S = 300.0

_state: dict = {}


def _init_method(address: str) -> str:
    """``host:port`` (the reference's form) -> ``tcp://host:port``; a
    ``tcp://`` or ``file://`` address is passed on as it is."""
    if "://" in address:
        return address
    return f"tcp://{address}"


def _rank_device(process_id: int, device) -> torch.device:
    device = device or os.environ.get(DEVICE_ENV)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_multihost: a rank runs on a CUDA device and none is "
                f"available; pass device='cpu' (or set {DEVICE_ENV}=cpu) to "
                "run the ranks on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda",
                              process_id % torch.cuda.device_count())
    return device


def backend_for(device: torch.device, num_processes: int) -> str:
    """``nccl`` when every rank has a card of its own, ``gloo`` otherwise
    (the CPU, or ranks sharing a card)."""
    if (device.type == "cuda"
            and num_processes <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, *,
                   device=None,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group. Arguments fall back to
    RAY_TPU_JAX_COORDINATOR / RAY_TPU_JAX_NUM_PROCESSES /
    RAY_TPU_JAX_PROCESS_ID. Returns True once joined (or if it already
    was), False when no coordinator is configured. ``device`` is this
    rank's device: default the card (``cuda:(rank % count)``, raising
    without one), or RAY_TPU_TORCH_DIST_DEVICE. The join and every
    collective give up after ``timeout_s``."""
    import torch.distributed as dist

    if _state:
        return True
    coordinator_address = (coordinator_address
                           or os.environ.get("RAY_TPU_JAX_COORDINATOR"))
    if not coordinator_address:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get(
            "RAY_TPU_JAX_NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid_env = os.environ.get("RAY_TPU_JAX_PROCESS_ID")
        process_id = int(pid_env) if pid_env is not None else None
    if num_processes is None or process_id is None:
        raise ValueError("init_multihost: the number of processes and this "
                         "process's id are both needed (arguments or "
                         "RAY_TPU_JAX_NUM_PROCESSES / RAY_TPU_JAX_PROCESS_ID)")
    dev = _rank_device(process_id, device)
    backend = backend_for(dev, num_processes)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=_init_method(coordinator_address),
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    _state.update(backend=backend, device=dev, rank=process_id,
                  world_size=num_processes)
    logger.info("torch.distributed initialized: process %s/%s via %s "
                "(%s on %s)", process_id, num_processes,
                coordinator_address, backend, dev)
    return True


def is_initialized() -> bool:
    return bool(_state)


def device() -> torch.device:
    """This rank's device (after ``init_multihost``)."""
    if not _state:
        raise RuntimeError("init_multihost has not run in this process")
    return _state["device"]


def backend() -> str:
    if not _state:
        raise RuntimeError("init_multihost has not run in this process")
    return _state["backend"]


def shutdown_multihost() -> None:
    """Leave the process group (the reference's runtime lives as long as
    its process; tests and the CLI leave explicitly)."""
    import torch.distributed as dist

    if _state:
        dist.destroy_process_group()
        _state.clear()


def global_mesh(config=None):
    """A mesh over ALL ranks (call after init_multihost on every rank),
    with the canonical axis names parallel/mesh.py uses; without a config,
    ``MeshConfig.for_devices(world size)``, as the reference's."""
    from ray_tpu_torch.parallel import mesh as mesh_lib

    return mesh_lib.make_rank_mesh(config)
