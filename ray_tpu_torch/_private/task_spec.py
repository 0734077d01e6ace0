"""Task specification — the unit handed to the scheduler.

Reference surface: ray src/ray/common/task/task_spec.h (TaskSpecification)
+ proto common.proto TaskSpec. Includes the SchedulingClass notion: tasks
with identical (function, resource demand) share a scheduling class so
worker leases can be reused across them (the reference's #1 throughput
mechanism; our batched scheduler groups by the same key).
"""

from __future__ import annotations

import dataclasses
import enum
import struct
from typing import Any, Callable, Dict, List, Optional, Tuple

import cloudpickle

from ray_tpu_torch._private.ids import ActorID, ObjectID, PlacementGroupID, TaskID


class TaskType(enum.Enum):
    NORMAL_TASK = 0
    ACTOR_CREATION_TASK = 1
    ACTOR_TASK = 2


# Resource vector layout used by the tensorized scheduler. Keep in sync with
# config sched_num_resources. Named custom resources keep their quantity
# accounting in the shared CUSTOM dimension (aggregate per node) while
# per-NAME feasibility rides the class->node eligibility masks — the
# batched-kernel shape stays fixed no matter how many names exist
# (reference semantics: custom resources constrain placement,
# ray: src/ray/common/scheduling/resource_set.h).
# Column 1 is the accelerator: the GPU here (the reference's TPU column).
RESOURCE_CPU = 0
RESOURCE_GPU = 1
RESOURCE_MEM = 2
RESOURCE_CUSTOM = 3
RESOURCE_NAMES = ("CPU", "GPU", "memory", "custom")
BUILTIN_RESOURCES = ("CPU", "GPU", "TPU", "memory")


def resources_to_vector(resources: Dict[str, float]) -> Tuple[float, ...]:
    vec = [0.0, 0.0, 0.0, 0.0]
    for k, v in resources.items():
        if k == "CPU":
            vec[RESOURCE_CPU] = v
        elif k in ("GPU", "TPU"):  # TPU accepted as an alias for portability
            vec[RESOURCE_GPU] = v
        elif k == "memory":
            vec[RESOURCE_MEM] = v
        else:
            vec[RESOURCE_CUSTOM] += v
    return tuple(vec)


def custom_resources(resources: Dict[str, float]) -> Dict[str, float]:
    """The named (non-builtin) demands: feasibility is per-name against
    each node's declared customs."""
    return {k: v for k, v in resources.items()
            if k not in BUILTIN_RESOURCES and v > 0}


@dataclasses.dataclass
class TaskSpec:
    task_id: TaskID
    name: str
    func: Optional[Callable]  # resolved callable (single-process) or None
    func_descriptor: str      # stable name for scheduling class / registry
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    num_returns: int = 1
    resources: Dict[str, float] = dataclasses.field(default_factory=lambda: {"CPU": 1})
    max_retries: int = 0
    retry_exceptions: Any = False  # False | True | list of exception types
    task_type: TaskType = TaskType.NORMAL_TASK
    actor_id: Optional[ActorID] = None
    actor_seq: int = 0
    scheduling_strategy: Any = None
    placement_group_id: Optional[PlacementGroupID] = None
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False
    runtime_env: Optional[dict] = None
    serialized_func: Optional[bytes] = None  # for process workers
    func_id: Optional[bytes] = None  # sha1 of serialized_func (cached)
    attempt_number: int = 0
    # per-attempt wall-clock deadline (submission to completion); on
    # expiry the attempt is cancelled and retried as TaskTimeoutError,
    # counting against max_retries. None = no deadline.
    timeout_s: Optional[float] = None
    generator: bool = False  # streaming generator task
    class_key: Optional[Tuple] = None  # precomputed scheduling_class()
    # (task_id, ids) memo: return_ids() runs on both the submit and the
    # completion hot paths; keyed by the id because retries mutate task_id
    _rid_memo: Any = None
    # per-arg (ObjectID, nbytes) summary stamped at submit for the
    # scheduler's locality scoring and dispatch-time arg staging; None
    # when the task has no ObjectRef args (the common fast path). NOT
    # part of scheduling_class(): tasks differing only in arg objects
    # must still share a class/lease.
    arg_sizes: Any = None
    # the task's own TraceContext 4-tuple (trace_id, span_id,
    # parent_span_id, sampled), stamped at submit by the trace plane and
    # carried to workers so nested submissions inherit parentage. The
    # logical span survives retries because retry mutates this spec in
    # place. NOT part of scheduling_class() for the same reason as
    # arg_sizes.
    trace_ctx: Any = None
    # QoS plane (config.qos): strict priority tier (higher preempts
    # lower) and owning tenant for weighted fair-share. Queue-ordering
    # inputs only — NOT part of scheduling_class(), so tasks differing
    # only in tier/tenant still share leases, and both default to the
    # pre-QoS values so qos=False envelopes stay byte-for-byte.
    priority: int = 0
    tenant: str = "default"

    def return_ids(self) -> List[ObjectID]:
        memo = self._rid_memo
        if memo is not None and memo[0] is self.task_id:
            return memo[1]
        ids = [ObjectID.for_task_return(self.task_id, i)
               for i in range(self.num_returns)]
        self._rid_memo = (self.task_id, ids)
        return ids

    def placement(self) -> Tuple:
        """Hashable placement descriptor consumed by the schedulers'
        node-eligibility masks (reference: scheduling_strategy field of
        TaskSpec, ray: python/ray/util/scheduling_strategies.py).

        ("default",)                       any non-bundle node, hybrid policy
        ("spread",)                        any non-bundle node, no local bias
        ("aff", node_id_bytes, soft)       pinned to one node
        ("pg", pg_id_bytes, bundle_index)  the group's reserved bundles
        """
        if self.placement_group_id is not None:
            return ("pg", self.placement_group_id.binary(),
                    self.placement_group_bundle_index)
        strat = self.scheduling_strategy
        if isinstance(strat, str):
            if strat == "SPREAD":
                return ("spread",)
            return ("default",)
        if strat is not None and hasattr(strat, "node_id") \
                and getattr(strat, "node_id") is not None:
            nid = strat.node_id
            nid = nid.binary() if hasattr(nid, "binary") else nid
            return ("aff", nid, bool(getattr(strat, "soft", False)))
        return ("default",)

    def scheduling_class(self) -> Tuple:
        """Tasks in the same class can reuse leases / batch together.
        Placement is part of the class: tasks differing only in strategy
        or bundle must not share one batched assignment row."""
        if self.class_key is not None:
            return self.class_key
        return (self.func_descriptor, tuple(sorted(self.resources.items())),
                self.placement())

    def resource_vector(self) -> Tuple[float, ...]:
        return resources_to_vector(self.resources)


# ---------------------------------------------------------------------------
# lease-envelope codec: the vectorized spec wire format
# ---------------------------------------------------------------------------
# A scheduler tick's worth of leases for one worker packs into a single
# envelope instead of N cloudpickled payload dicts. The spec splits into
# a per-class INVARIANT header (name, fn_id, num_returns — pickled once,
# cached per worker by a small int id, riding the same dedupe discipline
# as the fn-blob pre-cache) and a struct-packed per-task VARYING section
# (task id, attempt, args/ObjectRef blob, trace context). Anything
# unusual (explicit retry return_ids, placement-group capture, injected
# faults, runtime-env extras) rides a per-task pickled extras dict, so
# every payload the pipe could carry is envelope-expressible.
#
# Layout (little-endian):
#   u8 version, u16 ngroups
#   group: u16 hdr_id, u32 hdr_len (0 = receiver caches hdr_id), hdr,
#          u32 fn_len (0 = fn cache has it), fn_blob, u16 ntasks, tasks
#   task:  16s task_id, u32 attempt, u8 flags,
#          [flags&1] u8 n, n x 20s explicit return_ids
#          [flags&2] u8 mark, then trace/span/parent as u8-len ascii
#                    (parent len 255 = None)
#          [flags&4] u32 len, args_blob
#          [flags&8] u32 len, pickled extras dict

ENVELOPE_VERSION = 1
_F_RIDS, _F_TRACE, _F_ARGS, _F_EXTRAS = 1, 2, 4, 8
_U8 = struct.Struct("<B")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_HDR_FIX = struct.Struct("<HI")
_TASK_FIX = struct.Struct("<16sIB")
_RIDX = [struct.pack(">I", i) for i in range(64)]  # ids.py return index

# the serialized empty (args, kwargs) — shared so the owner encodes it
# by identity and the envelope omits it entirely (the dominant shape in
# high-rate fan-outs is a no-arg task)
EMPTY_ARGS_BLOB = cloudpickle.dumps(((), {}))

_CORE_KEYS = frozenset((
    "task_id", "name", "fn_id", "fn_blob", "args_blob", "num_returns",
    "return_ids", "attempt", "trace", "trace_mark"))


def _ret_index(i: int) -> bytes:
    return _RIDX[i] if i < 64 else struct.pack(">I", i)


def _encode_trace(tr, mark: bool) -> Optional[bytes]:
    """Struct-pack a well-formed TraceContext; None = not packable
    (rides the extras pickle instead)."""
    try:
        t, s, ps, _sampled = tr
        tb = t.encode("ascii")
        sb = s.encode("ascii")
        pb = b"" if ps is None else ps.encode("ascii")
        if len(tb) > 254 or len(sb) > 254 or len(pb) > 254:
            return None
        return b"".join((
            _U8.pack(1 if mark else 0),
            _U8.pack(len(tb)), tb,
            _U8.pack(len(sb)), sb,
            _U8.pack(255 if ps is None else len(pb)), pb))
    except Exception:
        return None


def encode_task_envelope(groups, sent_fns, sent_hdrs, hdr_blobs) -> bytes:
    """Pack one worker's tick of leases.

    ``groups``: list of ``(key, payloads)`` with ``key = (fn_id, name,
    num_returns)`` shared by every payload in the group. ``sent_fns`` /
    ``sent_hdrs`` are the per-worker dedupe caches (mutated — the
    caller holds the handle's send lock); ``hdr_blobs`` is a pool-level
    header-pickle cache keyed the same way."""
    parts = [_U8.pack(ENVELOPE_VERSION), _U16.pack(len(groups))]
    ap = parts.append
    for key, payloads in groups:
        hid = sent_hdrs.get(key)
        if hid is None:
            hid = sent_hdrs[key] = len(sent_hdrs)
            hdr = hdr_blobs.get(key)
            if hdr is None:
                fn_id, name, num_returns = key
                hdr = hdr_blobs[key] = cloudpickle.dumps(
                    (name, fn_id, num_returns))
            ap(_HDR_FIX.pack(hid, len(hdr)))
            ap(hdr)
        else:
            ap(_HDR_FIX.pack(hid, 0))
        p0 = payloads[0]
        fid = p0["fn_id"]
        blob = p0["fn_blob"]
        if blob is not None and (fid is None or fid not in sent_fns):
            if fid is not None:
                sent_fns.add(fid)
            ap(_U32.pack(len(blob)))
            ap(blob)
        else:
            ap(_U32.pack(0))
        ap(_U16.pack(len(payloads)))
        for p in payloads:
            tid = p["task_id"]
            flags = 0
            opt = []
            rids = p["return_ids"]
            nr = len(rids)
            if not all(rids[i] == tid + _ret_index(i) for i in range(nr)):
                # retry reusing prior attempt ids — ship them explicitly
                flags |= _F_RIDS
                opt.append(_U8.pack(nr))
                opt.extend(rids)
            tr = p.get("trace")
            tr_spill = False
            if tr is not None:
                enc = _encode_trace(tr, bool(p.get("trace_mark")))
                if enc is not None:
                    flags |= _F_TRACE
                    opt.append(enc)
                else:
                    tr_spill = True
            ab = p["args_blob"]
            if ab is not EMPTY_ARGS_BLOB:
                flags |= _F_ARGS
                opt.append(_U32.pack(len(ab)))
                opt.append(ab)
            nbase = 8 + ("trace" in p) + ("trace_mark" in p)
            if len(p) > nbase or tr_spill:
                extras = {k: v for k, v in p.items()
                          if k not in _CORE_KEYS}
                if tr_spill:
                    extras["trace"] = tr
                    if p.get("trace_mark"):
                        extras["trace_mark"] = True
                flags |= _F_EXTRAS
                xb = cloudpickle.dumps(extras)
                opt.append(_U32.pack(len(xb)))
                opt.append(xb)
            ap(_TASK_FIX.pack(tid, p["attempt"], flags))
            parts.extend(opt)
    return b"".join(parts)


def decode_task_envelope(data, hdr_cache: Dict[int, tuple]) -> list:
    """Unpack an envelope into the per-task payload dicts the worker's
    execute() path already understands. ``hdr_cache`` maps header id ->
    (name, fn_id, num_returns) for this connection's lifetime."""
    mv = memoryview(data)
    if mv[0] != ENVELOPE_VERSION:
        raise ValueError(f"unknown task-envelope version {mv[0]}")
    ngroups = _U16.unpack_from(mv, 1)[0]
    off = 3
    out = []
    for _ in range(ngroups):
        hid, hlen = _HDR_FIX.unpack_from(mv, off)
        off += 6
        if hlen:
            hdr_cache[hid] = cloudpickle.loads(mv[off:off + hlen])
            off += hlen
        name, fn_id, num_returns = hdr_cache[hid]
        flen = _U32.unpack_from(mv, off)[0]
        off += 4
        fn_blob = bytes(mv[off:off + flen]) if flen else None
        off += flen
        ntasks = _U16.unpack_from(mv, off)[0]
        off += 2
        for _ in range(ntasks):
            tid, attempt, flags = _TASK_FIX.unpack_from(mv, off)
            off += 21
            if flags & _F_RIDS:
                n = mv[off]
                off += 1
                rids = [bytes(mv[off + 20 * i:off + 20 * i + 20])
                        for i in range(n)]
                off += 20 * n
            else:
                rids = [tid + _ret_index(i) for i in range(num_returns)]
            p = {"task_id": tid, "name": name, "fn_id": fn_id,
                 "fn_blob": fn_blob, "args_blob": None,
                 "num_returns": num_returns, "return_ids": rids,
                 "attempt": attempt}
            # only the group's first task carries the fn blob; the
            # worker fn cache (keyed on arrival) serves the rest
            fn_blob = None
            if flags & _F_TRACE:
                mark = mv[off]
                off += 1
                ln = mv[off]
                off += 1
                t = str(mv[off:off + ln], "ascii")
                off += ln
                ln = mv[off]
                off += 1
                s = str(mv[off:off + ln], "ascii")
                off += ln
                ln = mv[off]
                off += 1
                if ln == 255:
                    ps = None
                else:
                    ps = str(mv[off:off + ln], "ascii")
                    off += ln
                p["trace"] = (t, s, ps, True)
                if mark:
                    p["trace_mark"] = True
            if flags & _F_ARGS:
                alen = _U32.unpack_from(mv, off)[0]
                off += 4
                p["args_blob"] = bytes(mv[off:off + alen])
                off += alen
            if flags & _F_EXTRAS:
                xlen = _U32.unpack_from(mv, off)[0]
                off += 4
                p.update(cloudpickle.loads(mv[off:off + xlen]))
                off += xlen
            out.append(p)
    return out
