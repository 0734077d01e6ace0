"""Train controller, worker group, session API, checkpoints.

Counterpart of ``ray_tpu/train/api.py`` on the port's runtime. The
Orbax pair (``save_jax_checkpoint`` / ``load_jax_checkpoint``) becomes
``save_torch_checkpoint`` / ``load_torch_checkpoint`` (``torch.save`` /
``torch.load``, with a ``map_location`` that puts tensors back on the
device the caller names).

Reference: ray: python/ray/train/ — v2 controller
(train/v2/_internal/execution/controller.py), WorkerGroup
(backend_executor.py), session (ray.train.report / get_checkpoint /
get_context), Checkpoint (train/_checkpoint.py).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

import ray_tpu_torch
from ray_tpu_torch import exceptions as rex

# ----------------------------------------------------------------------
# configs (reference: ray.train.ScalingConfig / RunConfig / FailureConfig)
# ----------------------------------------------------------------------


@dataclasses.dataclass
class ScalingConfig:
    num_workers: int = 1
    # declared and never read, as the reference's use_tpu: a worker's
    # loop picks its own device (resolve_device's None is the card)
    use_gpu: bool = False
    resources_per_worker: Optional[Dict[str, float]] = None
    # ELASTIC training (reference: train/v2 elastic worker groups):
    # when set, a failure-restart resizes the group to what the
    # cluster can currently hold — num_workers is the ceiling,
    # min_workers the floor (shrunk capacity after a node death no
    # longer wedges the restart at a size that can't schedule)
    min_workers: Optional[int] = None


@dataclasses.dataclass
class FailureConfig:
    max_failures: int = 0   # group restarts allowed; -1 = unlimited


@dataclasses.dataclass
class RunConfig:
    name: str = ""
    storage_path: str = ""
    failure_config: FailureConfig = dataclasses.field(
        default_factory=FailureConfig)


class Checkpoint:
    """Directory abstraction (reference: ray.train.Checkpoint)."""

    def __init__(self, path: str):
        self.path = path

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(os.path.abspath(path))

    def as_directory(self) -> str:
        return self.path

    def __repr__(self) -> str:
        return f"Checkpoint({self.path})"


@dataclasses.dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    path: str
    metrics_history: List[Dict[str, Any]]


# ----------------------------------------------------------------------
# worker-side session (reference: ray.train.report/get_checkpoint)
# ----------------------------------------------------------------------

class _Session:
    def __init__(self, rank: int, world_size: int,
                 checkpoint: Optional[Checkpoint],
                 dataset_shards: Optional[Dict[str, list]] = None):
        self.rank = rank
        self.world_size = world_size
        self.restore_checkpoint = checkpoint
        self.lock = threading.Lock()
        self.reports: List[Dict[str, Any]] = []
        self.latest_checkpoint: Optional[str] = None
        self.dataset_shards = dataset_shards or {}


class DataIterator:
    """This worker's shard of a Trainer dataset (reference:
    ray.train.get_dataset_shard -> DataIterator)."""

    def __init__(self, block_refs: list):
        self._refs = list(block_refs)
        self._count: Optional[int] = None

    def iter_batches(self, *, batch_size=None, batch_format="default"):
        from ray_tpu_torch.data import block as blk

        n = 0
        for ref in self._refs:
            block = ray_tpu_torch.get(ref)
            rows = blk.block_rows(block)
            n += rows
            if rows == 0:
                continue
            if batch_size is None:
                yield blk.to_batch_format(block, batch_format)
                continue
            for i in range(0, rows, batch_size):
                piece = blk.block_slice(block, i,
                                        min(i + batch_size, rows))
                yield blk.to_batch_format(piece, batch_format)
        self._count = n

    def iter_rows(self):
        from ray_tpu_torch.data import block as blk

        for ref in self._refs:
            # Arrow blocks iterate COLUMNS natively; rows means rows
            yield from blk.iter_block_rows(ray_tpu_torch.get(ref))

    def count(self) -> int:
        from ray_tpu_torch.data import block as blk

        # cached after any full pass: counting must not re-fetch and
        # re-deserialize the entire shard on every call
        if self._count is None:
            self._count = sum(blk.block_rows(b)
                              for b in self.iter_batches())
        return self._count


def get_dataset_shard(name: str = "train"):
    """Inside train_loop_per_worker: this worker's shard of the dataset
    passed to Trainer(datasets={...}). On a streaming ingest path the
    shard is a live StreamingShard — blocks arrive as upstream map
    tasks finish, overlapping ingest with the train loop; on the
    materialized fallback it wraps this rank's round-robined refs.
    Both expose iter_batches/iter_rows/count."""
    session = _current_session()
    if session is None:
        raise RuntimeError("get_dataset_shard() called outside a train "
                           "worker")
    if name not in session.dataset_shards:
        raise KeyError(f"no dataset named {name!r} was passed to the "
                       f"Trainer (have: {list(session.dataset_shards)})")
    shard = session.dataset_shards[name]
    if hasattr(shard, "iter_batches"):
        return shard
    return DataIterator(shard)


# session registry keyed by executing THREAD: thread-mode actors share
# one process (a module global would cross-talk between workers), and
# the controller polls from a different thread than the user loop
_sessions: Dict[int, _Session] = {}


def _current_session() -> Optional[_Session]:
    return _sessions.get(threading.get_ident())


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """Called from inside train_loop_per_worker."""
    session = _current_session()
    if session is None:
        raise RuntimeError("ray_tpu_torch.train.report() called outside a "
                           "train worker")
    with session.lock:
        entry = dict(metrics)
        if checkpoint is not None:
            entry["_checkpoint_path"] = checkpoint.path
            session.latest_checkpoint = checkpoint.path
        session.reports.append(entry)


def get_checkpoint() -> Optional[Checkpoint]:
    """The checkpoint to resume from (set after a failure restart)."""
    session = _current_session()
    if session is None:
        return None
    return session.restore_checkpoint


class _Context:
    def __init__(self, rank: int, world: int):
        self._rank, self._world = rank, world

    def get_world_size(self) -> int:
        return self._world

    def get_world_rank(self) -> int:
        return self._rank


def get_context() -> _Context:
    session = _current_session()
    if session is None:
        return _Context(0, 1)
    return _Context(session.rank, session.world_size)


# ----------------------------------------------------------------------
# worker actor
# ----------------------------------------------------------------------

@ray_tpu_torch.remote
class _TrainWorker:
    """One member of the WorkerGroup. max_concurrency=2 so the
    controller can poll reports while the user loop runs."""

    def __init__(self, rank: int, world_size: int):
        self.rank = rank
        self.world_size = world_size

    def run(self, fn, config, checkpoint_path: Optional[str],
            dataset_shards: Optional[Dict[str, list]] = None):
        session = _Session(
            self.rank, self.world_size,
            Checkpoint(checkpoint_path) if checkpoint_path else None,
            dataset_shards)
        self._session = session
        _sessions[threading.get_ident()] = session
        try:
            fn(config)
        finally:
            _sessions.pop(threading.get_ident(), None)
            # release streaming shards: a worker whose fn returned
            # mid-epoch must leave the splitter's epoch barrier, or
            # siblings still iterating would wait on it forever
            for shard in session.dataset_shards.values():
                close = getattr(shard, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:
                        pass
        with session.lock:
            return list(session.reports)

    def poll(self):
        """Latest checkpoint path (or None) — runs on the actor's second
        thread while run() executes. Only the checkpoint crosses the
        wire: the full report history would be O(steps^2) re-shipping
        over a long run."""
        session = getattr(self, "_session", None)
        if session is None:
            return None
        with session.lock:
            return session.latest_checkpoint


# ----------------------------------------------------------------------
# controller (reference: train v2 controller + BackendExecutor)
# ----------------------------------------------------------------------

class Trainer:
    """fit() runs train_loop_per_worker on a group of
    scaling_config.num_workers actors; restarts the whole group from the
    latest reported checkpoint on worker failure, up to
    failure_config.max_failures times."""

    def __init__(self, train_loop_per_worker: Callable[[dict], None],
                 *, train_loop_config: Optional[dict] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None):
        self._fn = train_loop_per_worker
        self._config = dict(train_loop_config or {})
        self._scaling = scaling_config or ScalingConfig()
        self._run = run_config or RunConfig()
        self._datasets = dict(datasets or {})
        if not self._run.storage_path:
            self._run.storage_path = tempfile.mkdtemp(
                prefix=f"ray_tpu_torch_train_{self._run.name or 'run'}_")

    def fit(self) -> Result:
        max_failures = self._run.failure_config.max_failures
        failures = 0
        restore: Optional[str] = None
        # dataset ingest is STREAMING by default: nothing executes here
        # — each attempt opens a streaming_split whose blocks reach the
        # workers as upstream tasks finish, overlapping ingest with the
        # train loop. Runtimes that must pickle actor args (process
        # workers, client mode, multi-node) fall back to materializing
        # once, lazily, cached across restarts (_fallback_refs) so a
        # non-deterministic pipeline hands every attempt the same data.
        self._fallback_refs: Optional[Dict[str, list]] = None
        while True:
            try:
                return self._run_attempt(restore, self._elastic_target())
            except _GroupFailure as gf:
                failures += 1
                if max_failures != -1 and failures > max_failures:
                    raise rex.RayTpuError(
                        f"training failed after {failures - 1} group "
                        f"restarts: {gf.cause}") from gf.cause
                restore = gf.latest_checkpoint
                # surviving actors are torn down; a fresh group restarts
                # from the last checkpoint (reference FailurePolicy),
                # elastically resized to current capacity

    def _elastic_target(self) -> int:
        """Worker count for the NEXT attempt. Fixed groups return
        num_workers; elastic groups (min_workers set) clamp to what
        the cluster's current CPU capacity can schedule."""
        sc = self._scaling
        if sc.min_workers is None:
            return sc.num_workers
        if not 1 <= sc.min_workers <= sc.num_workers:
            raise ValueError(
                f"min_workers must satisfy 1 <= min_workers <= "
                f"num_workers, got {sc.min_workers} vs "
                f"{sc.num_workers}")
        per = float((sc.resources_per_worker or {}).get("CPU", 1.0))
        if per <= 0:
            return sc.num_workers
        try:
            # FREE capacity sizes the attempt (other actors may hold
            # CPUs); TOTAL capacity decides whether the floor is ever
            # reachable. Transient holders below the floor get the
            # benefit of the doubt — the readiness gate catches an
            # attempt that still can't place.
            avail = float(ray_tpu_torch.available_resources().get("CPU", 0.0))
            total = float(ray_tpu_torch.cluster_resources().get("CPU", 0.0))
        except Exception:
            return sc.num_workers
        if int(total // per) < sc.min_workers:
            raise rex.RayTpuError(
                f"elastic training needs {sc.min_workers} workers "
                f"({per} CPU each) but the cluster's total capacity "
                f"holds {int(total // per)}")
        return max(sc.min_workers,
                   min(sc.num_workers, int(avail // per)))

    @staticmethod
    def _streaming_ingest_ok() -> bool:
        """Streaming shards are driver-side objects (threading
        primitives + executor handle): they cross into train workers
        only where actor args pass by REFERENCE — thread workers on a
        single-node, non-client runtime. Everything else (process
        workers, client mode, multi-node) pickles args and takes the
        materialized fallback."""
        from ray_tpu_torch._private import worker as wm
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        w = wm.global_worker
        if w is None or getattr(w, "is_client", False):
            return False
        if GLOBAL_CONFIG.worker_mode != "thread":
            return False
        try:
            return len(w.gcs.node_table()) <= 1
        except Exception:
            return False

    def _run_attempt(self, restore: Optional[str],
                     n: Optional[int] = None) -> Result:
        n = n if n is not None else self._scaling.num_workers
        # ingest: streaming split per dataset when the runtime supports
        # it (equal=True keeps the rank->block assignment round-robin,
        # matching the materialized fallback's refs[rank::n]); else
        # materialize once, cached across attempts
        shards_by_rank: List[Dict[str, Any]] = [dict() for _ in
                                                range(n)]
        coordinators: List[Any] = []
        if self._datasets and self._streaming_ingest_ok():
            for name, ds in self._datasets.items():
                shards = ds.streaming_split(n, equal=True)
                coordinators.append(shards[0].coordinator)
                for rank in range(n):
                    shards_by_rank[rank][name] = shards[rank]
        else:
            if self._fallback_refs is None:
                self._fallback_refs = {
                    name: ds.materialize().block_refs
                    for name, ds in self._datasets.items()}
            for name, refs in self._fallback_refs.items():
                for rank in range(n):
                    shards_by_rank[rank][name] = refs[rank::n]
        workers = [
            _TrainWorker.options(
                max_concurrency=2,
                **({"resources": self._scaling.resources_per_worker}
                   if self._scaling.resources_per_worker else {})
            ).remote(rank, n)
            for rank in range(n)
        ]
        try:
            if self._scaling.min_workers is not None:
                # elastic readiness gate: a worker that cannot schedule
                # (capacity view lagging a node death) must surface as
                # a group failure — the NEXT attempt re-reads capacity
                # — not hang the whole fit
                try:
                    ray_tpu_torch.get([w.poll.remote() for w in workers],
                                timeout=60.0)
                except Exception as e:
                    raise _GroupFailure(restore, e) from e
            run_refs = [w.run.remote(self._fn, self._config, restore,
                                     shards_by_rank[rank])
                        for rank, w in enumerate(workers)]
            rank_of = {ref.object_id(): rank
                       for rank, ref in enumerate(run_refs)}
            latest_ckpt = restore
            reports_by_rank: Dict[int, List[Dict[str, Any]]] = {}
            pending = list(run_refs)
            last_poll = 0.0
            while pending:
                done, pending = ray_tpu_torch.wait(pending, num_returns=1,
                                             timeout=0.25)
                # track checkpoints as they appear so a later failure
                # restores the freshest state — polled at a coarse
                # interval (per-tick polling would cost ~4*N round trips
                # per second for the whole run and a hung worker could
                # stall the loop)
                if time.monotonic() - last_poll >= 2.0:
                    last_poll = time.monotonic()
                    for w in workers:
                        try:
                            ck = ray_tpu_torch.get(w.poll.remote(), timeout=10)
                        except Exception:
                            continue
                        if ck:
                            latest_ckpt = ck
                for ref in done:
                    try:
                        reports = ray_tpu_torch.get(ref)
                    except Exception as e:
                        # final sweep: a checkpoint reported since the
                        # last coarse poll must not be lost to the
                        # restart
                        for w in workers:
                            try:
                                ck = ray_tpu_torch.get(w.poll.remote(),
                                                 timeout=5)
                            except Exception:
                                continue
                            if ck:
                                latest_ckpt = ck
                        raise _GroupFailure(latest_ckpt, e) from e
                    reports_by_rank[rank_of[ref.object_id()]] = reports
            # success-path final sweep: a checkpoint reported inside the
            # last coarse-poll window must reach the Result too
            for w in workers:
                try:
                    ck = ray_tpu_torch.get(w.poll.remote(), timeout=5)
                except Exception:
                    continue
                if ck:
                    latest_ckpt = ck
            # rank-0 reports drive the Result (reference behavior) —
            # keyed by rank, NOT completion order
            history = reports_by_rank.get(0, [])
            final = dict(history[-1]) if history else {}
            ckpt_path = final.pop("_checkpoint_path", None) or latest_ckpt
            return Result(
                metrics=final,
                checkpoint=Checkpoint(ckpt_path) if ckpt_path else None,
                path=self._run.storage_path,
                metrics_history=[{k: v for k, v in r.items()
                                 if k != "_checkpoint_path"}
                                 for r in history],
            )
        finally:
            for w in workers:
                try:
                    ray_tpu_torch.kill(w)
                except Exception:
                    pass
            # a restart gets a FRESH split (the plan replays); the old
            # one must stop producing and snapshot its stats
            for coord in coordinators:
                try:
                    coord.shutdown()
                except Exception:
                    pass


class _GroupFailure(Exception):
    def __init__(self, latest_checkpoint: Optional[str],
                 cause: BaseException):
        self.latest_checkpoint = latest_checkpoint
        self.cause = cause


# ----------------------------------------------------------------------
# checkpoints (reference role: ray.train.Checkpoint + torch.save; the
# reference's Orbax sharded pytrees)
# ----------------------------------------------------------------------

_CHECKPOINT_FILE = "state.pt"


def save_torch_checkpoint(path: str, tree: Any) -> Checkpoint:
    """``torch.save`` of a tree of tensors and plain values (a model's
    and an optimizer's ``state_dict`` included) into directory ``path``;
    synchronous."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _CHECKPOINT_FILE + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, _CHECKPOINT_FILE))
    return Checkpoint(path)


def load_torch_checkpoint(checkpoint: Checkpoint,
                          map_location: Any = None) -> Any:
    """The tree saved by save_torch_checkpoint, its tensors on
    ``map_location`` (a device, as ``torch.load`` takes it; None: the
    devices they were saved from)."""
    return torch.load(os.path.join(checkpoint.path, _CHECKPOINT_FILE),
                      map_location=map_location, weights_only=True)
