"""GCS — the cluster control plane.

Reference surface: the GCS server (ray: src/ray/gcs/gcs_server/ —
GcsNodeManager, GcsActorManager, GcsJobManager, GcsKVManager,
GcsPublisher, GcsHealthCheckManager) and its client accessors
(src/ray/gcs/gcs_client/). The reference runs this as a separate
process reached over gRPC; here it is an in-process service object on
the head — the table/pubsub/health semantics are the same, and the
process boundary can be added behind this interface without changing
callers (single global scheduler + control plane on one host is the
TPU-first stance, SURVEY.md §7.1 P4).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private.analysis import runtime_sanitizer
from ray_tpu_torch._private.analysis.runtime_checks import assert_holds
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID

logger = logging.getLogger(__name__)

# pubsub channels (reference: src/ray/pubsub/ channel types)
CH_NODE = "NODE"
CH_ACTOR = "ACTOR"
CH_JOB = "JOB"
CH_ERROR = "ERROR"


class NodeEntry:
    __slots__ = ("node_id", "index", "resources", "state", "kind",
                 "last_heartbeat", "pool", "death_reason",
                 "rejoining_since")

    def __init__(self, node_id: NodeID, index: int,
                 resources: Dict[str, float], kind: str, pool=None):
        self.node_id = node_id
        self.index = index              # scheduler row
        self.resources = dict(resources)
        self.state = "ALIVE"            # ALIVE | REJOINING | DEAD
        self.kind = kind                # "local" | "process"
        self.last_heartbeat = time.monotonic()
        self.pool = pool                # ProcessWorkerPool for kind=process
        self.death_reason: Optional[str] = None
        # monotonic timestamp of the link drop that put the node into
        # REJOINING (the grace window before death is declared); None
        # while ALIVE/DEAD
        self.rejoining_since: Optional[float] = None


class ActorEntry:
    __slots__ = ("actor_id", "name", "namespace", "state", "node_index",
                 "class_name", "job_id")

    def __init__(self, actor_id: ActorID, name: str, namespace: str,
                 class_name: str, job_id: Optional[JobID],
                 node_index: int = -1):
        self.actor_id = actor_id
        self.name = name
        self.namespace = namespace
        self.state = "PENDING_CREATION"
        self.node_index = node_index
        self.class_name = class_name
        self.job_id = job_id


class GcsJournal:
    """Write-ahead journal of GCS table mutations (reference: the GCS's
    Redis persistence, ray: src/ray/gcs/store_client/ — the control
    plane replays its tables after a restart while raylets keep
    running). Append-only pickled tuples, flushed per record."""

    def __init__(self, path: str):
        import os

        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # truncate any torn tail record (crash mid-append) BEFORE
        # appending: writing after torn bytes would make every later op
        # unreachable to the next replay
        intact = self._intact_size(path)
        self._f = open(path, "ab")
        if intact is not None and self._f.tell() > intact:
            self._f.truncate(intact)
            self._f.seek(intact)
        self._wlock = runtime_sanitizer.wrap_lock(
            threading.Lock(), "_private.gcs.GcsJournal._wlock")

    @staticmethod
    def _intact_size(path: str) -> Optional[int]:
        import os
        import pickle

        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            offset = 0
            while True:
                try:
                    pickle.load(f)
                    offset = f.tell()
                except EOFError:
                    return offset
                except Exception:
                    return offset

    def append(self, op: Tuple, fsync: bool = False) -> None:
        import os
        import pickle

        with self._wlock:
            pickle.dump(op, self._f)
            self._f.flush()
            if fsync:
                # machine-crash durability (the default flush survives
                # only process death — the page cache can lose acked
                # mutations when the HOST dies)
                os.fsync(self._f.fileno())

    def rewrite(self, ops: List[Tuple]) -> None:
        """Snapshot-compaction: atomically replace the WAL with `ops`
        (one snapshot record + nothing else), bounding the journal by
        table size instead of lifetime mutation count (reference: the
        Redis tier's RDB-style compaction of its AOF)."""
        import os
        import pickle

        with self._wlock:
            tmp = f"{self.path}.{os.getpid()}.compact"
            with open(tmp, "wb") as f:
                for op in ops:
                    pickle.dump(op, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            # the rename itself must be durable, or a machine crash
            # after compaction loses the WHOLE journal the per-append
            # fsyncs promised to keep
            dfd = os.open(os.path.dirname(os.path.abspath(self.path))
                          or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
            self._f.close()
            self._f = open(self.path, "ab")

    def size_bytes(self) -> int:
        import os

        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    @staticmethod
    def replay(path: str) -> List[Tuple]:
        import os
        import pickle

        if not os.path.exists(path):
            return []
        ops: List[Tuple] = []
        with open(path, "rb") as f:
            while True:
                try:
                    ops.append(pickle.load(f))
                except EOFError:
                    break
                except Exception:
                    # torn tail write (crash mid-append): replay what is
                    # intact, drop the rest
                    break
        return ops

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:
            pass


class GcsService:
    """Node/actor/job tables + KV + pubsub + health checks."""

    def __init__(self, worker, journal: Optional[GcsJournal] = None):
        self._worker = worker
        self._lock = runtime_sanitizer.wrap_lock(
            threading.RLock(), "_private.gcs.GcsService._lock")
        self._nodes: Dict[NodeID, NodeEntry] = {}
        self._node_by_index: Dict[int, NodeEntry] = {}
        self._actors: Dict[ActorID, ActorEntry] = {}
        self._actor_names: Dict[Tuple[str, str], ActorID] = {}
        self._jobs: Dict[JobID, Dict[str, Any]] = {}
        self._kv: Dict[Tuple[str, bytes], bytes] = {}
        # detached-actor recovery payloads (cloudpickled (cls, opts)):
        # the reference keeps the serialized creation spec in the actor
        # table for exactly this (restart/recovery) purpose
        self._actor_recovery: Dict[ActorID, bytes] = {}
        self._journal = journal
        self._ops_since_compact = 0
        # in-flight remote leases (task dispatches to remote daemons),
        # mirrored in the journal so a restarted head can reconcile them
        # against what rejoining daemons report still running
        self._leases: Dict[bytes, Dict[str, Any]] = {}
        # remote nodes the journal says were alive pre-restart: the
        # reconciler waits for these to rejoin before resubmitting
        # unclaimed leases
        self.expected_nodes: Dict[bytes, Dict[str, Any]] = {}
        # 1 when this head recovered prior state from a journal (i.e.
        # this process IS the post-failover head), else 0; exported as
        # ray_tpu_head_failovers_total
        self.head_failovers = 0
        self.replayed_lease_count = 0
        self.replayed_node_count = 0
        if journal is not None:
            self._replay(GcsJournal.replay(journal.path))
        # object directory: node rows holding a copy of each object
        # resident in REMOTE node arenas, primary first; secondary
        # copies are registered when a peer pull completes and dropped
        # when their node dies (reference: the multi-location object
        # directory the object manager consults before a Pull —
        # src/ray/object_manager/ownership_object_directory.cc)
        self._object_locations: Dict[ObjectID, List[int]] = {}
        self._subs: Dict[str, Dict[int, Callable[[dict], None]]] = {}
        self._sub_seq = 0
        self._health_thread: Optional[threading.Thread] = None
        self._shutdown = False

    # ------------------------------------------------------------------
    # journal replay (restore-in-place after a head restart)
    # ------------------------------------------------------------------
    def _replay(self, ops: List[Tuple]) -> None:
        """Rebuild actor + KV tables (and the in-flight lease / expected
        node views) from the WAL. Replayed actors come back ORPHANED:
        name-resolvable immediately, runnable once their node daemon
        rejoins and the runtime re-attaches. Node table rows are NOT
        rebuilt — live daemons re-register themselves; the journal's
        node records only feed ``expected_nodes`` so the reconciler
        knows who should come back.

        Runs inside __init__ before any other thread exists; the lock
        is taken anyway so every mutation of the guarded tables stays
        uniformly under it."""
        with self._lock:
            self._replay_locked(ops)

    def _replay_locked(self, ops: List[Tuple]) -> None:
        for op in ops:
            kind = op[0]
            if kind == "snapshot":
                # compaction record: authoritative table state at the
                # time of the rewrite; later ops apply on top. Older
                # journals carry 3-field snapshots (no leases/nodes).
                actors, kv = op[1], op[2]
                leases = op[3] if len(op) > 3 else {}
                nodes = op[4] if len(op) > 4 else {}
                self._actors.clear()
                self._actor_names.clear()
                self._actor_recovery.clear()
                self._kv.clear()
                self._leases = dict(leases)
                self.expected_nodes = dict(nodes)
                for abin, name, ns, class_name, recovery, state in actors:
                    actor_id = ActorID(abin)
                    entry = ActorEntry(actor_id, name, ns, class_name,
                                       None)
                    entry.state = "ORPHANED" if state == "ALIVE" else state
                    self._actors[actor_id] = entry
                    if name:
                        self._actor_names[(ns, name)] = actor_id
                    if recovery is not None:
                        self._actor_recovery[actor_id] = recovery
                for ns, k, v in kv:
                    self._kv[(ns, k)] = v
            elif kind == "lease":
                _, tid_bin, record = op
                self._leases[tid_bin] = record
            elif kind == "lease_done":
                self._leases.pop(op[1], None)
            elif kind == "node":
                _, nbin, info = op
                self.expected_nodes[nbin] = info
            elif kind == "node_dead":
                self.expected_nodes.pop(op[1], None)
            elif kind == "actor":
                _, abin, name, ns, class_name, recovery = op
                actor_id = ActorID(abin)
                entry = ActorEntry(actor_id, name, ns, class_name, None)
                entry.state = "ORPHANED"
                self._actors[actor_id] = entry
                if name:
                    self._actor_names[(ns, name)] = actor_id
                if recovery is not None:
                    self._actor_recovery[actor_id] = recovery
            elif kind == "actor_state":
                _, abin, state = op
                e = self._actors.get(ActorID(abin))
                if e is not None:
                    e.state = state if state != "ALIVE" else "ORPHANED"
                    if state == "DEAD":
                        if e.name:
                            self._actor_names.pop((e.namespace, e.name),
                                                  None)
                        self._actors.pop(ActorID(abin), None)
                        self._actor_recovery.pop(ActorID(abin), None)
            elif kind == "kv_put":
                _, ns, k, v = op
                self._kv[(ns, k)] = v
            elif kind == "kv_del":
                _, ns, k = op
                self._kv.pop((ns, k), None)
        if ops:
            self.head_failovers = 1
            self.replayed_lease_count = len(self._leases)
            # how many remote daemons the PRE-restart cluster had: the
            # reconciler waits for this many rejoins before resubmitting
            # unclaimed leases (rejoined daemons get fresh NodeIDs, so a
            # count — not identity — is the only matchable quantity)
            self.replayed_node_count = len(self.expected_nodes)
            logger.info("GCS journal replayed: %d ops, %d actors, %d kv, "
                        "%d pending leases, %d expected nodes",
                        len(ops), len(self._actors), len(self._kv),
                        len(self._leases), len(self.expected_nodes))

    def _log(self, op: Tuple, critical: bool = False) -> None:
        if self._journal is None:
            return
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        # critical ops (node/actor registration, actor state
        # transitions) are always fsynced: the failover contract for
        # re-adoptable state must not depend on the page cache
        self._journal.append(
            op, fsync=critical or GLOBAL_CONFIG.gcs_journal_fsync)
        every = GLOBAL_CONFIG.gcs_journal_compact_every
        self._ops_since_compact += 1
        if every and self._ops_since_compact >= every:
            self.compact_journal()
            return
        max_bytes = GLOBAL_CONFIG.gcs_journal_compact_bytes
        if max_bytes and self._journal.size_bytes() >= max_bytes:
            self.compact_journal()

    def compact_journal(self) -> None:
        """Rewrite the WAL as one snapshot of the journaled tables."""
        if self._journal is None:
            return
        with self._lock:
            actors = [(a.actor_id.binary(), a.name, a.namespace,
                       a.class_name, self._actor_recovery.get(a.actor_id),
                       a.state)
                      for a in self._actors.values()]
            kv = [(ns, k, v) for (ns, k), v in self._kv.items()]
            leases = dict(self._leases)
            nodes = dict(self.expected_nodes)
        self._journal.rewrite([("snapshot", actors, kv, leases, nodes)])
        self._ops_since_compact = 0

    # ------------------------------------------------------------------
    # in-flight lease journal (head-failover reconciliation)
    # ------------------------------------------------------------------
    @property
    def journal_enabled(self) -> bool:
        """True when this head persists a WAL (callers skip building
        lease records entirely otherwise — the default-config cost of
        the failover plane is one attribute read per dispatch)."""
        return self._journal is not None

    def journal_lease(self, task_id_bin: bytes,
                      record: Dict[str, Any]) -> None:
        """Record a task dispatched to a remote daemon. No-op without a
        journal (zero cost in the default configuration). ``record``
        carries enough to resubmit: name, fn/args blobs, return oid
        bins, resources, attempt token."""
        if self._journal is None:
            return
        with self._lock:
            self._leases[task_id_bin] = record
            self._log(("lease", task_id_bin, record))

    def journal_get(self, task_id_bin: bytes) -> Optional[Dict[str, Any]]:
        """Read an in-flight lease record (the local-retry attempt
        bump re-journals the record through journal_lease so failover
        replay sees the live attempt token)."""
        with self._lock:
            return self._leases.get(task_id_bin)

    def journal_lease_done(self, task_id_bin: bytes) -> None:
        """Terminal completion of a remote lease (done OR failed):
        removes it from the reconciliation set."""
        if self._journal is None:
            return
        with self._lock:
            self._leases.pop(task_id_bin, None)
            self._log(("lease_done", task_id_bin))

    def claim_lease(self, task_id_bin: bytes) -> Optional[Dict[str, Any]]:
        """A rejoining daemon reported this task still in flight: hand
        the lease record to the reconciler and drop it from the
        unclaimed set (claim-once)."""
        with self._lock:
            return self._leases.pop(task_id_bin, None)

    def pending_leases(self) -> Dict[bytes, Dict[str, Any]]:
        """Leases no surviving node has claimed (yet)."""
        with self._lock:
            return dict(self._leases)

    def actor_recovery_blob(self, actor_id: ActorID) -> Optional[bytes]:
        with self._lock:
            return self._actor_recovery.get(actor_id)

    def orphaned_actor(self, actor_id: ActorID) -> Optional[ActorEntry]:
        with self._lock:
            e = self._actors.get(actor_id)
            return e if e is not None and e.state == "ORPHANED" else None

    # ------------------------------------------------------------------
    # node table (reference: GcsNodeManager)
    # ------------------------------------------------------------------
    def register_node(self, node_id: NodeID, index: int,
                      resources: Dict[str, float], kind: str = "local",
                      pool=None) -> NodeEntry:
        entry = NodeEntry(node_id, index, resources, kind, pool)
        with self._lock:
            self._nodes[node_id] = entry
            self._node_by_index[index] = entry
            if kind == "remote":
                # critical (fsynced) op: the restarted head's reconciler
                # uses the expected-node set to know which daemons
                # should rejoin before it resubmits unclaimed leases
                info = {"resources": dict(resources)}
                self.expected_nodes[node_id.binary()] = info
                self._log(("node", node_id.binary(), info), critical=True)
        self.publish(CH_NODE, {"event": "ALIVE", "node_id": node_id,
                               "index": index})
        return entry

    def heartbeat(self, node_id: NodeID) -> None:
        with self._lock:
            e = self._nodes.get(node_id)
            if e is not None:
                e.last_heartbeat = time.monotonic()

    def mark_node_dead(self, node_id: NodeID, reason: str = "") -> None:
        with self._lock:
            e = self._nodes.get(node_id)
            if e is None or e.state == "DEAD":
                return
            e.state = "DEAD"
            e.death_reason = reason
            e.rejoining_since = None
            if e.kind == "remote":
                self.expected_nodes.pop(node_id.binary(), None)
                self._log(("node_dead", node_id.binary()), critical=True)
        self.publish(CH_NODE, {"event": "DEAD", "node_id": node_id,
                               "index": e.index, "reason": reason})

    def mark_node_rejoining(self, node_id: NodeID) -> bool:
        """Link to the node's daemon dropped: enter the grace window.
        The node leaves ``alive_process_nodes()`` (health probes pause)
        but keeps its scheduler row and in-flight leases; a re-dial
        within the grace flips it back ALIVE via
        :meth:`mark_node_rejoined`. Returns False when the node is
        already DEAD (no grace to grant)."""
        with self._lock:
            e = self._nodes.get(node_id)
            if e is None or e.state == "DEAD":
                return False
            if e.state != "REJOINING":
                e.state = "REJOINING"
                e.rejoining_since = time.monotonic()
        self.publish(CH_NODE, {"event": "REJOINING", "node_id": node_id,
                               "index": e.index})
        return True

    def mark_node_rejoined(self, node_id: NodeID) -> None:
        """The daemon re-dialed within the grace window."""
        with self._lock:
            e = self._nodes.get(node_id)
            if e is None or e.state != "REJOINING":
                return
            e.state = "ALIVE"
            e.rejoining_since = None
            e.last_heartbeat = time.monotonic()
        self.publish(CH_NODE, {"event": "ALIVE", "node_id": node_id,
                               "index": e.index})

    def node_table(self) -> List[NodeEntry]:
        with self._lock:
            return list(self._nodes.values())

    def node_by_index(self, index: int) -> Optional[NodeEntry]:
        with self._lock:
            return self._node_by_index.get(index)

    def alive_process_nodes(self) -> List[NodeEntry]:
        with self._lock:
            return [e for e in self._nodes.values()
                    if e.state == "ALIVE"
                    and e.kind in ("process", "remote")]

    # ------------------------------------------------------------------
    # object directory (objects resident on remote nodes; primary-first
    # location lists, secondaries registered by completed peer pulls)
    # ------------------------------------------------------------------
    def _locs_locked(self, object_id: ObjectID):
        """Location list of ``object_id`` (or None). Caller holds
        self._lock — checked dynamically under RAY_TPU_TORCH_DEBUG_LOCKS=1."""
        assert_holds(self._lock, "GCS object directory")
        return self._object_locations.get(object_id)

    def object_location_add(self, object_id: ObjectID, index: int) -> None:
        """Set/replace the PRIMARY location (inserts, or moves an
        existing secondary to the front)."""
        with self._lock:
            locs = self._locs_locked(object_id)
            if locs is None:
                self._object_locations[object_id] = [index]
            else:
                if index in locs:
                    locs.remove(index)
                locs.insert(0, index)

    def object_location_add_secondary(self, object_id: ObjectID,
                                      index: int) -> None:
        """Register an extra copy (a completed peer pull). Only objects
        already tracked gain secondaries — an untracked oid means the
        primary was freed/invalidated and the copy is moot."""
        with self._lock:
            locs = self._locs_locked(object_id)
            if locs is not None and index not in locs:
                locs.append(index)

    def object_location_get(self, object_id: ObjectID) -> Optional[int]:
        """The primary location, or None."""
        with self._lock:
            locs = self._locs_locked(object_id)
            return locs[0] if locs else None

    def object_locations(self, object_id: ObjectID) -> List[int]:
        """All known copies, primary first (empty when untracked)."""
        with self._lock:
            return list(self._locs_locked(object_id) or ())

    def object_location_pop(self, object_id: ObjectID) -> Optional[int]:
        """Forget the object entirely; returns the old primary."""
        with self._lock:
            locs = self._object_locations.pop(object_id, None)
            return locs[0] if locs else None

    def object_locations_pop(self, object_id: ObjectID) -> List[int]:
        """Forget the object entirely; returns EVERY copy's node row
        (free-all-copies path)."""
        with self._lock:
            return self._object_locations.pop(object_id, None) or []

    def objects_on_node(self, index: int) -> List[ObjectID]:
        """Objects whose PRIMARY copy lives on the node."""
        with self._lock:
            return [oid for oid, locs in self._object_locations.items()
                    if locs and locs[0] == index]

    def objects_resident(self, index: int) -> List[ObjectID]:
        """Objects with ANY copy on the node (primary or secondary) —
        feeds the residency digest in the resource-view push, so the
        LocalScheduler can admit ref-carrying tasks whose arg bytes
        are provably on-node."""
        with self._lock:
            return [oid for oid, locs in self._object_locations.items()
                    if index in locs]

    def drop_node_locations(self, index: int):
        """Node-death invalidation: remove ``index`` from every location
        list. Returns (lost, promoted): oids whose LAST copy died (drop
        from the directory, lineage must reconstruct) and
        {oid: new_primary} for oids whose primary died but a secondary
        survived and took over."""
        lost: List[ObjectID] = []
        promoted: Dict[ObjectID, int] = {}
        with self._lock:
            for oid, locs in list(self._object_locations.items()):
                if index not in locs:
                    continue
                was_primary = locs[0] == index
                locs.remove(index)
                if not locs:
                    del self._object_locations[oid]
                    lost.append(oid)
                elif was_primary:
                    promoted[oid] = locs[0]
        return lost, promoted

    # ------------------------------------------------------------------
    # actor table (reference: GcsActorManager — source of truth for
    # actor metadata and name resolution)
    # ------------------------------------------------------------------
    def register_actor(self, actor_id: ActorID, name: str, namespace: str,
                       class_name: str, job_id=None,
                       recovery: Optional[bytes] = None) -> ActorEntry:
        """``recovery`` (cloudpickled (cls, opts), detached actors only)
        makes the actor re-attachable after a head restart."""
        entry = ActorEntry(actor_id, name, namespace, class_name, job_id)
        with self._lock:
            if name and (namespace, name) in self._actor_names:
                raise ValueError(
                    f"actor name {name!r} already taken in namespace "
                    f"{namespace!r}")
            self._actors[actor_id] = entry
            if name:
                self._actor_names[(namespace, name)] = actor_id
            if recovery is not None:
                self._actor_recovery[actor_id] = recovery
                # journaled under the table lock: replay order must
                # match applied order (GcsJournal has its own _wlock,
                # so holding self._lock here cannot deadlock)
                self._log(("actor", actor_id.binary(), name, namespace,
                           class_name, recovery), critical=True)
        self.publish(CH_ACTOR, {"event": "REGISTERED",
                                "actor_id": actor_id})
        return entry

    def update_actor_state(self, actor_id: ActorID, state: str,
                           node_index: int = -1) -> None:
        with self._lock:
            e = self._actors.get(actor_id)
            if e is None:
                return
            e.state = state
            if node_index >= 0:
                e.node_index = node_index
            if state == "DEAD" and e.name:
                self._actor_names.pop((e.namespace, e.name), None)
            journaled = actor_id in self._actor_recovery
            if state == "DEAD":
                self._actor_recovery.pop(actor_id, None)
            if journaled:
                self._log(("actor_state", actor_id.binary(), state),
                          critical=True)
        self.publish(CH_ACTOR, {"event": state, "actor_id": actor_id})

    def get_actor_by_name(self, name: str,
                          namespace: str = "") -> Optional[ActorID]:
        with self._lock:
            return self._actor_names.get((namespace, name))

    def actor_table(self) -> List[ActorEntry]:
        with self._lock:
            return list(self._actors.values())

    def actors_on_node(self, index: int) -> List[ActorEntry]:
        with self._lock:
            return [e for e in self._actors.values()
                    if e.node_index == index and e.state not in ("DEAD",)]

    # ------------------------------------------------------------------
    # job table (reference: GcsJobManager)
    # ------------------------------------------------------------------
    def register_job(self, job_id: JobID,
                     metadata: Optional[dict] = None) -> None:
        with self._lock:
            self._jobs[job_id] = {"state": "RUNNING",
                                  "start_time": time.time(),
                                  **(metadata or {})}
        self.publish(CH_JOB, {"event": "STARTED", "job_id": job_id})

    def finish_job(self, job_id: JobID) -> None:
        with self._lock:
            if job_id in self._jobs:
                self._jobs[job_id]["state"] = "FINISHED"
        self.publish(CH_JOB, {"event": "FINISHED", "job_id": job_id})

    def job_table(self) -> Dict[JobID, Dict[str, Any]]:
        with self._lock:
            return {k: dict(v) for k, v in self._jobs.items()}

    # ------------------------------------------------------------------
    # KV store (reference: GcsKVManager / internal_kv)
    # ------------------------------------------------------------------
    def kv_put(self, key: bytes, value: bytes,
               namespace: str = "") -> None:
        with self._lock:
            self._kv[(namespace, bytes(key))] = bytes(value)
            self._log(("kv_put", namespace, bytes(key), bytes(value)))

    def kv_get(self, key: bytes, namespace: str = "") -> Optional[bytes]:
        with self._lock:
            return self._kv.get((namespace, bytes(key)))

    def kv_del(self, key: bytes, namespace: str = "") -> bool:
        with self._lock:
            hit = self._kv.pop((namespace, bytes(key)), None) is not None
            if hit:
                self._log(("kv_del", namespace, bytes(key)))
        return hit

    def kv_keys(self, prefix: bytes = b"",
                namespace: str = "") -> List[bytes]:
        with self._lock:
            return [k for (ns, k) in self._kv
                    if ns == namespace and k.startswith(prefix)]

    # ------------------------------------------------------------------
    # pubsub (reference: GcsPublisher / src/ray/pubsub/)
    # ------------------------------------------------------------------
    def subscribe(self, channel: str,
                  callback: Callable[[dict], None]) -> int:
        with self._lock:
            self._sub_seq += 1
            self._subs.setdefault(channel, {})[self._sub_seq] = callback
            return self._sub_seq

    def unsubscribe(self, channel: str, sub_id: int) -> None:
        with self._lock:
            self._subs.get(channel, {}).pop(sub_id, None)

    def publish(self, channel: str, message: dict) -> None:
        with self._lock:
            callbacks = list(self._subs.get(channel, {}).values())
        for cb in callbacks:
            try:
                cb(message)
            except Exception:
                logger.exception("pubsub callback failed on %s", channel)

    # ------------------------------------------------------------------
    # health checks (reference: GcsHealthCheckManager — periodic pings;
    # here: process liveness of each node's worker pool)
    # ------------------------------------------------------------------
    def start_health_checks(self,
                            interval: Optional[float] = None) -> None:
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        if self._health_thread is not None:
            return
        if interval is None:
            interval = GLOBAL_CONFIG.health_check_period_s
        self.health_check_interval = interval
        # only this loop records heartbeats, so a node registered before
        # it started (the head's own, when the first remote node joins
        # long after init) carries its registration time: restart every
        # live node's staleness clock here, or the first probe declares
        # it dead. The reference misses this: its head marks node 0 DEAD
        # when a node joins more than node_heartbeat_timeout_s after init
        now = time.monotonic()
        with self._lock:
            for e in self._nodes.values():
                e.last_heartbeat = now
        self._health_thread = threading.Thread(
            target=self._health_loop, args=(interval,), daemon=True,
            name="ray_tpu_gcs_health")
        self._health_thread.start()

    def _health_loop(self, interval: float) -> None:
        from ray_tpu_torch._private.chaos import get_controller
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        chaos = get_controller()
        # consecutive-miss grace (reference: GcsHealthCheckManager's
        # failure_threshold): one missed probe must not kill a node
        # whose daemon is merely busy (e.g. serving a large fetch).
        # health_check_timeout_s is the wall-clock failure budget; the
        # probe count it buys depends on the period (0.6s / 0.2s = the
        # historical 3 probes).
        misses: Dict[Any, int] = {}
        threshold = max(1, round(
            GLOBAL_CONFIG.health_check_timeout_s / max(interval, 1e-6)))
        last_tick = time.monotonic()
        while not self._shutdown:
            time.sleep(interval)
            # only this loop records heartbeats, so while it is late (its
            # process stalled, or a probe or a death took long) no node
            # can record one: the lateness is the checker's, not the
            # nodes'. Move every live node's staleness clock past it,
            # and age each node from the tick's start, so a stalled head
            # declares no live node DEAD. The reference ages its nodes by
            # its own stalls too
            now = time.monotonic()
            late = now - last_tick - interval
            last_tick = now
            if late > interval:
                self._forgive_lateness(late, now)
            fault = chaos.poll("head")
            if fault is not None:
                self._inject_head_fault(fault)
            nfault = chaos.poll("node")
            if nfault is not None:
                self._inject_node_fault(nfault)
            for e in self.alive_process_nodes():
                pool = e.pool
                if pool is None:
                    continue
                # staleness guard: probes answered over a live connection
                # don't prove the node is making progress — a node whose
                # heartbeat has not been RECORDED within the timeout is
                # dead even if its TCP link never dropped
                timeout_s = GLOBAL_CONFIG.node_heartbeat_timeout_s
                age = now - e.last_heartbeat
                if timeout_s and age > timeout_s:
                    logger.warning("health check: node %s heartbeat is "
                                   "%.1fs stale (timeout %.1fs); marking "
                                   "DEAD", e.node_id.hex()[:16], age,
                                   timeout_s)
                    self._worker.on_node_failure(
                        e.node_id,
                        reason=f"no heartbeat for {age:.1f}s "
                        f"(node_heartbeat_timeout_s={timeout_s})")
                    misses.pop(e.node_id, None)
                    continue
                procs = pool.live_process_count()
                if procs == 0:
                    n = misses.get(e.node_id, 0) + 1
                    misses[e.node_id] = n
                    if n < threshold:
                        continue
                    logger.warning("health check: node %s has no live "
                                   "workers (%d consecutive probes); "
                                   "marking DEAD", e.node_id.hex()[:16], n)
                    self._worker.on_node_failure(
                        e.node_id, reason="health check: all worker "
                        "processes dead")
                    misses.pop(e.node_id, None)
                else:
                    misses.pop(e.node_id, None)
                    if chaos.poll("heartbeat", node=e.index) is None:
                        self.heartbeat(e.node_id)
                    # a dropped heartbeat is "recovered" when the
                    # staleness guard above later declares the node dead

    def _forgive_lateness(self, late: float, now: float) -> None:
        """The health loop woke ``late`` seconds after its tick was due:
        add them to every live node's last heartbeat (never past
        ``now``)."""
        with self._lock:
            for e in self._nodes.values():
                if e.state == "ALIVE":
                    e.last_heartbeat = min(e.last_heartbeat + late, now)

    def _inject_head_fault(self, fault: Dict[str, Any]) -> None:
        """``head`` chaos site, polled once per health tick. ``flap``
        severs every remote daemon link in-process (exercising outbox
        buffering, rejoin re-attach, and replay dedup without killing
        anyone); ``kill`` SIGKILLs this head process — the arrival index
        makes the blackout point seed-reproducible. ``restart`` is a
        marker kind for external harnesses (they poll the plan and
        kill + relaunch the head subprocess) and is a no-op in-core."""
        kind = fault.get("kind")
        if kind == "flap":
            logger.warning("chaos[head]: flapping all daemon links")
            for e in self.alive_process_nodes():
                if e.kind == "remote" and e.pool is not None:
                    try:
                        e.pool.sever_link()
                    except Exception:
                        logger.exception("chaos[head]: flap of node %s "
                                         "failed", e.node_id.hex()[:16])
        elif kind == "kill":
            import os
            import signal

            logger.warning("chaos[head]: SIGKILL self (pid %d)",
                           os.getpid())
            os.kill(os.getpid(), signal.SIGKILL)

    def _inject_node_fault(self, fault: Dict[str, Any]) -> None:
        """``node`` chaos site, polled once per health tick. ``kill``
        SIGKILLs the victim's daemon process WITH its whole worker
        tree (machine death: nothing on the node survives to report
        anything; the severed link / health probes must notice and the
        head-side node-death reconciler must recover every adopted
        lease, route, and sole-copy object); ``flap`` severs just that
        node's daemon link (blackout + outbox replay without death);
        ``restart`` is a marker kind for external harnesses (they kill
        and relaunch the node process at the seeded arrival) and a
        no-op in-core. The ``node`` param picks the victim scheduler
        row; default is the lowest-index alive remote node."""
        kind = fault.get("kind")
        victims = [e for e in self.alive_process_nodes()
                   if e.kind == "remote" and e.pool is not None]
        if not victims:
            return
        want = fault.get("node")
        victim = None
        if want is not None:
            for e in victims:
                if e.index == int(want):
                    victim = e
                    break
        if victim is None:
            victim = min(victims, key=lambda e: e.index)
        if kind == "kill":
            logger.warning("chaos[node]: machine-death SIGKILL of node "
                           "%s (row %d)", victim.node_id.hex()[:16],
                           victim.index)
            try:
                victim.pool.simulate_machine_death()
            except Exception:
                logger.exception("chaos[node]: kill of node %s failed",
                                 victim.node_id.hex()[:16])
        elif kind == "flap":
            logger.warning("chaos[node]: flapping daemon link of node "
                           "%s (row %d)", victim.node_id.hex()[:16],
                           victim.index)
            try:
                victim.pool.sever_link()
            except Exception:
                logger.exception("chaos[node]: flap of node %s failed",
                                 victim.node_id.hex()[:16])

    def shutdown(self) -> None:
        self._shutdown = True
