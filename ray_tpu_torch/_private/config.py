"""Typed config registry with environment-variable overrides.

TPU-native equivalent of the reference's RAY_CONFIG macro table
(ray: src/ray/common/ray_config_def.h + ray_config.h): every knob is a
typed entry, overridable via ``RAY_TPU_TORCH_<name>`` env vars or an init-time
``_system_config`` dict, and a frozen snapshot can be exported for
device-visible kernel parameters (tick sizes, bin-pack weights).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Callable, Dict

# the port's own prefix: the JAX package's registry reads RAY_TPU_*, and
# the two registries in one process must never configure each other
_ENV_PREFIX = "RAY_TPU_TORCH_"


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


_PARSERS: Dict[type, Callable[[str], Any]] = {
    bool: _parse_bool,
    int: lambda s: int(s, 0),
    float: float,
    str: str,
}


@dataclasses.dataclass
class _Entry:
    name: str
    type: type
    default: Any
    doc: str
    value: Any = None

    def __post_init__(self):
        self.value = self.default


class ConfigRegistry:
    """All runtime knobs. Resolution order: explicit set > env var > default."""

    def __init__(self):
        self._entries: Dict[str, _Entry] = {}
        self._lock = threading.Lock()
        self._frozen = False

    def define(self, name: str, type_: type, default: Any, doc: str = "") -> None:
        with self._lock:
            if name in self._entries:
                raise ValueError(f"config {name!r} already defined")
            entry = _Entry(name, type_, default, doc)
            env = os.environ.get(_ENV_PREFIX + name.upper())
            if env is not None:
                entry.value = _PARSERS[type_](env)
            self._entries[name] = entry

    def get(self, name: str) -> Any:
        return self._entries[name].value

    def entry(self, name: str) -> "_Entry":
        """Live entry handle for hot paths: holders read `.value`
        directly, skipping the per-access __getattr__ dict walk while
        still observing later set()s."""
        return self._entries[name]

    def set(self, name: str, value: Any) -> None:
        with self._lock:
            if self._frozen:
                raise RuntimeError(
                    "config is frozen after ray_tpu_torch.init(); pass _system_config "
                    "to init() instead"
                )
            entry = self._entries[name]
            if not isinstance(value, entry.type) and entry.type is not str:
                value = entry.type(value)
            entry.value = value

    def apply_system_config(self, system_config: Dict[str, Any] | str) -> None:
        if isinstance(system_config, str):
            system_config = json.loads(system_config)
        for k, v in system_config.items():
            self.set(k, v)

    def freeze(self) -> None:
        self._frozen = True

    def unfreeze(self) -> None:
        self._frozen = False

    def reset(self) -> None:
        """Restore every knob to default (env overrides re-applied).
        Called at runtime shutdown: ``_system_config`` is scoped to one
        init/shutdown cycle, like the reference's per-cluster config."""
        with self._lock:
            if self._frozen:
                raise RuntimeError("cannot reset a frozen config")
            for entry in self._entries.values():
                env = os.environ.get(_ENV_PREFIX + entry.name.upper())
                entry.value = (_PARSERS[entry.type](env)
                               if env is not None else entry.default)

    def snapshot(self) -> Dict[str, Any]:
        return {k: e.value for k, e in self._entries.items()}

    def __getattr__(self, name: str) -> Any:
        entries = object.__getattribute__(self, "_entries")
        if name in entries:
            return entries[name].value
        raise AttributeError(name)


GLOBAL_CONFIG = ConfigRegistry()
_d = GLOBAL_CONFIG.define

# -- core ------------------------------------------------------------------
_d("num_workers", int, 0, "worker threads/processes; 0 = os.cpu_count()")
_d("gc_tuning", bool, True,
   "tune CPython cyclic GC at init: gc.freeze() the pre-init heap "
   "(jax/XLA imports dominate it) and raise collection thresholds so "
   "submit bursts of 10k+ specs/refs don't rescan the live graph every "
   "~700 allocations (measured 26% task-throughput cost at 50k tasks). "
   "CAVEAT: freeze() exempts objects alive at init() from cycle "
   "collection until shutdown() (which unfreezes) — cyclic garbage "
   "formed from PRE-init objects is not reclaimed while the runtime is "
   "up. Call init() early, or disable this knob if your program builds "
   "large discardable cyclic structures before init")
_d("worker_mode", str, "thread", "worker execution backend: thread | process")
_d("gcs_journal_path", str, "",
   "write-ahead journal for GCS table mutations (reference: Redis "
   "persistence); a restarted head replays it and re-adopts rejoining "
   "node daemons. Empty = no persistence (head is a SPOF)")
_d("gcs_journal_compact_every", int, 1000,
   "appended ops between journal snapshot-compactions (the WAL is "
   "rewritten as one snapshot record, so a long-lived head's journal "
   "stays bounded by table size, not mutation count); 0 disables")
_d("gcs_journal_fsync", bool, False,
   "fsync the journal after EVERY append: survives MACHINE crash, not "
   "just process crash, at per-mutation disk-latency cost (the "
   "reference's Redis tier makes the same durability trade via its "
   "appendfsync policy). Independently of this knob, critical ops — "
   "node/actor registration and actor state transitions — always "
   "fsync, so the failover contract never depends on the page cache")
_d("gcs_journal_compact_bytes", int, 16 * 1024 * 1024,
   "journal size threshold that auto-triggers snapshot compaction in "
   "addition to the op-count path (gcs_journal_compact_every): a "
   "lease-heavy workload with large specs stays bounded by bytes, not "
   "just record count; 0 disables the size trigger")
_d("daemon_rejoin_timeout_s", float, 20.0,
   "how long an orphaned node daemon (head connection lost without an "
   "exit) retries reconnecting to the head address before giving up "
   "and dying; 0 = die immediately (pre-FT behavior)")
_d("daemon_rejoin_grace_s", float, 10.0,
   "head-side grace window after a daemon link drops before the node "
   "is declared dead: the node sits in REJOINING state and its "
   "in-flight leases are kept alive; a daemon that re-dials within "
   "the window re-attaches with outbox replay and nothing is lost. "
   "0 = declare death immediately (pre-failover behavior)")
_d("client_reconnect_timeout_s", float, 30.0,
   "ray:// client session-resumption budget: on a dropped connection "
   "the client re-dials the head address with the SAME session token, "
   "re-issuing idempotent in-flight ops (get/wait/state/kv), so a "
   "driver blocked in get() across a head restart resolves late; "
   "0 = fail pending ops immediately (pre-failover behavior)")
_d("worker_gpu_access", bool, False,
   "give process workers the card (the counterpart of the reference's "
   "worker_tpu_access). Default: workers start with "
   "CUDA_VISIBLE_DEVICES=\"\" (each process that touches the card "
   "makes a CUDA context of its own), and a process-backed node "
   "advertises no GPU, so a num_gpus task or actor never runs there")
_d("worker_pipeline_depth", int, 0,
   "max tasks in flight per process-worker pipe, and in thread mode the "
   "dispatch-window factor queued at the bounded thread pool (lease "
   "pipelining, reference: max_tasks_in_flight_per_worker); 0 = auto "
   "from the worker-count / host-core ratio (1 on unoversubscribed "
   "hosts)")
_d("control_ring", bool, True,
   "ship task-lease envelopes and completion batches to local process "
   "workers over per-worker shared-memory SPSC rings (pipe kept as "
   "doorbell + fallback); off = pre-ring per-message pipe transport")
_d("control_ring_slots", int, 64,
   "slots per control ring (one task ring + one completion ring per "
   "local process worker); a power of two keeps the modulo cheap")
_d("control_ring_slot_bytes", int, 16 * 1024,
   "bytes per control-ring slot; an envelope larger than one slot "
   "falls back to the pipe (rings carry single-slot messages only)")
_d("object_store_memory", int, 256 * 1024 * 1024,
   "shared-memory object store arena bytes per node")
_d("object_spill_dir", str, "",
   "directory for spilled objects; empty = a fresh directory under TMPDIR")
_d("object_spill_threshold", float, 0.8,
   "when a full arena forces a spill, evict down to this fraction of "
   "capacity (hysteresis: the next create shouldn't immediately spill "
   "again); >= 1.0 frees only what the triggering allocation needs")
_d("inline_object_max_bytes", int, 100 * 1024,
   "objects at or under this size are stored in the owner's in-process "
   "memory store (reference inlines <100KB into task specs)")
_d("object_transfer_timeout_s", float, 120.0,
   "give up on a cross-node object fetch after this (guards a hung node "
   "daemon; sized for multi-GB transfers, not as a liveness probe)")
_d("max_direct_call_object_size", int, 100 * 1024,
   "reference-API alias of inline_object_max_bytes: overriding it "
   "flows into the real knob at init() unless inline_object_max_bytes "
   "was itself overridden")

# -- scheduler (device-resident kernel parameters) -------------------------
_d("sched_tick_interval_s", float, 0.0,
   "min seconds between scheduler ticks: an event burst arriving within "
   "the interval coalesces into one tick (0 = tick immediately)")
_d("sched_arena_capacity", int, 4096,
   "TensorScheduler starting task-arena slot count (arrays double on "
   "overflow; raise for sustained million-task graphs to avoid regrow "
   "copies)")
_d("sched_num_resources", int, 4,
   "width R of the resource vectors (cpu, gpu, mem, custom)")
_d("sched_hybrid_threshold", float, 0.5,
   "prefer-local until node load exceeds this fraction (hybrid policy analog)")
_d("scheduler", str, "tensor",
   "scheduler implementation: tensor (device-array batched, default) | "
   "event (per-event oracle)")
_d("sched_backend", str, "auto",
   "TensorScheduler assignment backend: auto | cuda | numpy (numpy for "
   "tiny batches; cuda = kernels.assign on sched_device for every batch)")
_d("sched_device_min_batch", int, 64,
   "below this many ready tasks the numpy assignment is used (auto "
   "mode). The default is where kernels.assign first beat numpy by 2x "
   "on an H100 at 64 scheduling classes on 64 nodes (chip_smoke.py "
   "phase runtime, PERF.md); at one class it never did, and auto also "
   "waits for a numpy tick above 2 ms before it times the device")
_d("sched_device", str, "cuda",
   "device of the TensorScheduler's device path (kernels.assign): cuda "
   "launches the hand-written kernels on the card's own stream; cpu runs "
   "their plain PyTorch version (the tests)")
_d("scheduler_locality", bool, True,
   "score candidate nodes by resident-arg-bytes and prefer the node "
   "holding the most input data when it is feasible (reference: "
   "bottom-up locality-aware placement, Ray OSDI '18); SPREAD and "
   "placement-group strategies override locality as before. Off = "
   "pre-locality placement, byte-for-byte")
_d("locality_spillback_queue_depth", int, 4,
   "spillback bound for locality preference: a task waits for its "
   "preferred (most-resident-bytes) node only while that node has "
   "fewer than this many leases outstanding; beyond it the task "
   "spills to the normal least-loaded choice so a hot node never "
   "serializes the cluster")
_d("local_dispatch", bool, True,
   "bottom-up two-level scheduling (reference: Ray OSDI '18): a remote "
   "node's daemon admits worker-submitted tasks from a bounded local "
   "queue against a head-refreshed resource view, leases them to its "
   "own workers without a head round-trip (retries included: the "
   "daemon re-leases a failed attempt locally up to task_max_retries "
   "with per-attempt accounting), and reports lease + completion "
   "through the sequenced outbox (exactly-once across head restarts). "
   "Ref-carrying args admit when the bytes are resident on the node; "
   "tasks that still do not fit — non-resident refs, custom "
   "resources, placement groups, full queue — spill upward to the "
   "head scheduler, which stays the single placement authority "
   "(per-reason counters: ray_tpu_sched_spillback_total{reason=...}). "
   "Off = every submission goes through the head, byte-for-byte "
   "pre-two-level behavior")
_d("local_queue_depth", int, 16,
   "bound on locally-admitted leases in flight per node daemon; at the "
   "bound new submissions spill upward to the head scheduler")
_d("actor_p2p", bool, True,
   "peer-to-peer actor calls: once the head publishes an actor's "
   "(node, worker) route, worker-originated calls ship the call "
   "envelope caller-daemon -> peer-daemon over the peer link and only "
   "a sequenced completion receipt flows to the head for lineage/ref-"
   "counting; peer-link failure or actor restart falls back to the "
   "head path with the same attempt token (retries stay exactly-"
   "once). Off = every actor call routes through the head, byte-for-"
   "byte pre-p2p behavior")
_d("resview_gossip_s", float, 1.0,
   "period of daemon-to-daemon resource-view gossip over the peer "
   "lanes: each daemon re-shares the freshest (highest-version) view "
   "it holds so local admission stays current when the head is slow "
   "or rejoining; the head's direct push remains the authoritative "
   "tiebreaker (equal versions never overwrite a head-pushed view). "
   "0 disables gossip; gossip also requires local_dispatch or "
   "actor_p2p to be on")
_d("qos", bool, False,
   "multi-tenant QoS plane: submissions carry a tenant + priority tier "
   "(@remote(priority=...) / .options(priority=..., tenant=...)); the "
   "head's ready queues become weighted fair-share per tenant (deficit "
   "round-robin on the tenant_quotas weights) with strict priority "
   "tiers on top, a starved higher-tier task preempts the lowest-tier "
   "running victim after preempt_grace_s (the kill rides the worker-"
   "death retry path: bumped attempt, journaled lease, exactly-once — "
   "never a double execution), and resview frames carry a per-node "
   "top-spilled-tier watermark so a daemon never locally admits below "
   "a tier the head is still holding for that node. Off = no tenancy "
   "anywhere, byte-for-byte pre-QoS frames and lease envelopes")
_d("tenant_quotas", str, "",
   "JSON object mapping tenant name -> fair-share weight, e.g. "
   "'{\"prod\": 3, \"batch\": 1}'; unlisted tenants (including the "
   "implicit \"default\" tenant) get weight 1. Weights divide capacity "
   "inside a priority tier only — tiers stay strict. Empty = every "
   "tenant weight 1 (pure round-robin fair share)")
_d("preempt_grace_s", float, 1.0,
   "how long a higher-tier task may sit queued with zero running "
   "tasks of its tier before the QoS plane kills the lowest-tier "
   "running victim to make room; the victim retries with a bumped "
   "attempt (granted an extra system retry if it had none left). "
   "0 preempts on the first monitor tick; requires qos")

# -- fault tolerance -------------------------------------------------------
_d("task_max_retries", int, 3, "default retries for tasks on worker failure")
_d("actor_max_restarts", int, 0, "default actor restarts")
_d("max_lineage_bytes", int, 64 * 1024 * 1024, "owner lineage cap")
_d("memory_usage_threshold", float, 0.95,
   "host memory fraction above which the monitor kills the newest "
   "running task with a retriable OutOfMemoryError; 0 disables")
_d("memory_monitor_interval_s", float, 0.25, "memory monitor poll period")
_d("data_op_inflight", int, 8,
   "ray_tpu_torch.data: max in-flight tasks per streaming operator")
_d("data_buffer_blocks", int, 32,
   "ray_tpu_torch.data: max live blocks across the pipeline "
   "(backpressure)")
_d("data_buffer_bytes", int, 256 * 1024 * 1024,
   "ray_tpu_torch.data: max BYTES of buffered arena-resident blocks "
   "across the pipeline (bytes-based backpressure; sizes known for "
   "shm-stored blocks)")
_d("data_split_queue_blocks", int, 8,
   "ray_tpu_torch.data streaming_split: max buffered blocks PER "
   "CONSUMER queue (per-consumer backpressure — one slow consumer "
   "stalls only its own lane, not the whole split)")
_d("data_split_queue_bytes", int, 64 * 1024 * 1024,
   "ray_tpu_torch.data streaming_split: max buffered BYTES per consumer "
   "queue (sizes known for arena-resident blocks; inline blocks fall "
   "back to the block-count budget)")
_d("health_check_period_s", float, 0.2,
   "control-plane health probe period (GCS liveness loop)")
_d("health_check_timeout_s", float, 0.6,
   "wall-clock budget of consecutive failed liveness probes before a "
   "node is declared dead (probe count = timeout / period; the "
   "defaults keep the historical 3-probe grace)")
_d("node_heartbeat_timeout_s", float, 5.0,
   "mark a node dead after this many seconds without a heartbeat, even "
   "if its daemon connection stays up (a hung-but-connected node must "
   "not stall the cluster); heartbeats are recorded only when the "
   "node's liveness probe actually succeeds")
_d("task_retry_delay_s", float, 0.05,
   "base delay before the first task retry; doubles per attempt "
   "(exponential backoff) so a flapping node is not hammered with "
   "immediate resubmissions. 0 = retry immediately (pre-backoff "
   "behavior)")
_d("task_retry_max_delay_s", float, 2.0,
   "exponential retry backoff is capped at this delay")
_d("task_retry_jitter", bool, True,
   "multiply each retry delay by a seeded jitter factor in [0.5, 1.0) "
   "to decorrelate retry storms")

# -- logging / observability ----------------------------------------------
_d("log_dir", str, "", "session log dir; empty = $TMPDIR/ray_tpu_torch/session_*/logs")
_d("log_capture", bool, True,
   "capture worker stdout/stderr into per-process session log files; "
   "off = no session log dir, no driver streaming, no list_logs/get_log "
   "(the bench's capture-off baseline)")
_d("log_rotation_bytes", int, 64 * 1024 * 1024,
   "rotate a worker capture file when it exceeds this size; 0 = never")
_d("log_rotation_backups", int, 3,
   "rotated generations kept per capture file (file.1 .. file.N)")
_d("log_to_driver_rate", int, 2000,
   "max captured log lines re-emitted on the driver per second; "
   "excess lines are dropped with a surfaced drop count")
_d("metrics_export_port", int, 0, "prometheus text endpoint port; 0 = disabled")
_d("event_buffer_size", int, 65536, "profile/trace event ring size per worker")
_d("task_events_max", int, 16384,
   "bounded ring of FINISHED/FAILED task event records kept head-side "
   "(feeds state.list_tasks(detail=True) and ray_tpu_torch.timeline()); "
   "eviction drops finished records before failed ones so failures "
   "outlive successes; 0 disables task event recording entirely (the "
   "bench A/B baseline)")
_d("trace_sample_rate", float, 1.0,
   "fraction of root submissions stamped with a sampled TraceContext "
   "(children always inherit the root's decision); 0 disables the trace "
   "plane entirely — no context stamping, no span records (the bench "
   "A/B baseline)")
_d("traces_max", int, 512,
   "bounded number of distinct traces kept head-side by the trace "
   "aggregator (oldest trace evicted wholesale); 0 disables the trace "
   "plane like trace_sample_rate=0")
_d("trace_log_markers", bool, False,
   "emit a '== trace <id> span <id> task <id> ==' marker line into the "
   "worker's capture file at exec start of each sampled task, so "
   "get_log output correlates with spans; off by default to keep "
   "capture files byte-stable for log-plane consumers")
_d("profile_hz", float, 0.0,
   "continuous-profiler sampling rate: every process worker (and the "
   "head) walks sys._current_frames() profile_hz times a second and "
   "ships folded-stack counts tagged with the running task; 0 (the "
   "default, and the bench A/B baseline) disables the whole "
   "profile/utilization plane — no sampler threads, no wire traffic")
_d("utilization_interval_s", float, 1.0,
   "per-node resource sampling cadence (/proc/stat, /proc/meminfo, shm "
   "arena + control-ring + scheduler gauges) while the profile plane "
   "is on (profile_hz > 0); also the fixed downsampling interval of "
   "the head-side utilization ring")
_d("utilization_ring", int, 512,
   "bounded points kept per (node, series) in the head-side "
   "utilization time-series ring; oldest points fall off")
_d("profile_stacks_max", int, 20000,
   "bounded distinct (node, task, stack) folded-stack counts kept "
   "head-side by the profile plane; least recently bumped entries are "
   "evicted (counted in ray_tpu_profile_samples_dropped_total's "
   "sibling summary)")

# -- serving at scale ------------------------------------------------------
_d("serve_slo_ttft_p95_s", float, 0.0,
   "SLO-aware admission target: when > 0 and the recent p95 "
   "time-to-first-token exceeds it while streams are in flight, new "
   "streams are shed at ingress (503 / AdmissionShedError) instead of "
   "timing out mid-stream; 0 disables shedding")
_d("serve_ttft_window", int, 256,
   "TTFT samples kept in the sliding window that admission and the "
   "ttft-mode pool autoscaler read their quantiles from")
_d("serve_kv_cache_sessions", int, 16,
   "per-decode-replica LRU bound on cached session KV handoffs "
   "(cache-affinity routing: a follow-up turn that re-sends the same "
   "prompt replays from this cache with zero prefill work)")

# -- testing / fault injection --------------------------------------------
_d("testing_inject_task_failure_prob", float, 0.0,
   "probability a task raises a simulated worker failure (chaos testing)")
_d("testing_tick_delay_s", float, 0.0, "artificial scheduler tick delay")
