"""raysan's dynamic half — a runtime sanitizer mirroring the static passes.

Armed by ``RAY_TPU_TORCH_SANITIZE=1`` (read once at import, like
``runtime_checks``), or programmatically via :func:`arm` in tests.
Everything here is zero-cost when disarmed: ``wrap_lock`` returns the
raw lock unchanged, the ledger/track entry points are a single module-
global branch, and no state accumulates.

Three recorders, each the dynamic witness of a static pass:

- **lock witness** (mirrors ``lock_order``): every lock wrapped with
  :func:`wrap_lock` records, per thread, which locks were already held
  at each acquire. At shutdown the observed edge set is diffed against
  the static acquisition graph — an observed edge whose REVERSE exists
  (statically or dynamically) is an order inversion, i.e. a deadlock
  the chaos soak merely got lucky on. Edges the static pass never saw
  are reported separately as *uncharted* (a resolution blind spot, not
  a bug).
- **leak ledger** (mirrors ``ref_lifecycle``): every shm-arena /
  spill-tier allocation is recorded with its owning-task attribution
  (best effort, from the worker's current task context — the same id
  the task-event plane keys on) and removed on free. At
  ``ray_tpu_torch.shutdown()`` a ledger entry whose ObjectID has no row left
  in the ReferenceCounter is a leak: the object went out of scope but
  its bytes were never freed. A parallel live-instance census of
  registered ``ObjectRef``\\ s catches the inverse bug — a refcount row
  held up by a decref that never happened (local > 0 with zero live
  handles).
- **wire schema** (mirrors ``wire_protocol``): the static channel
  table is compiled into tag -> arity-set schemas at arm time; each
  recv dispatcher feeds live messages through :func:`check_wire`, so a
  send site the static table does not model shows up as a violation
  instead of silently drifting.

Violations are RECORDED, never raised: a sanitizer that kills a daemon
thread mid-soak hides every later violation. ``last_report()`` exposes
the assembled shutdown report to tests.
"""

from __future__ import annotations

import logging
import os
import threading
import weakref
from typing import Dict, List, Optional, Set, Tuple

logger = logging.getLogger(__name__)

_ENABLED = os.environ.get("RAY_TPU_TORCH_SANITIZE", "") == "1"

#: synthetic tags injected into recv queues locally (never wire traffic)
_SYNTHETIC_TAGS = {"__died__"}


def enabled() -> bool:
    return _ENABLED


def arm() -> None:
    """Enable the sanitizer and reset all recorded state (tests)."""
    global _ENABLED
    _ENABLED = True
    reset()


def disarm() -> None:
    global _ENABLED
    _ENABLED = False
    reset()


def reset() -> None:
    global _observed_edges, _ledger, _external, _live_refs
    global _wire_violations, _wire_schema, _owner_provider, _last_report
    _observed_edges = {}
    _ledger = {}
    _external = set()
    _live_refs = {}
    _wire_violations = []
    _wire_schema = None
    _owner_provider = None
    _last_report = None


# ---------------------------------------------------------------------------
# lock witness
# ---------------------------------------------------------------------------

#: (outer_id, inner_id) -> name of the first thread that interleaved them
_observed_edges: Dict[Tuple[str, str], str] = {}
_tls = threading.local()


def _held_stack() -> List[str]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class _WitnessLock:
    """Transparent lock proxy recording acquisition order per thread.

    All bookkeeping is plain dict/list mutation under the GIL — the
    witness must never take a lock of its own while a real acquire is
    in flight, or it would add edges to the very graph it audits.
    """

    __slots__ = ("_lock", "_id")

    def __init__(self, lock, lock_id: str):
        self._lock = lock
        self._id = lock_id

    def acquire(self, *args, **kwargs):
        got = self._lock.acquire(*args, **kwargs)
        if got:
            me = self._id
            thread = None
            for outer in _held_stack():
                if outer != me and (outer, me) not in _observed_edges:
                    if thread is None:
                        thread = threading.current_thread().name
                    _observed_edges[(outer, me)] = thread
            _held_stack().append(me)
        return got

    def release(self):
        st = _held_stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] == self._id:
                del st[i]
                break
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __getattr__(self, name):
        # locked(), _is_owned(), _recursion_count()... — forwarded so
        # assert_holds and Condition plumbing behave as on the raw lock
        return getattr(self._lock, name)


def wrap_lock(lock, lock_id: str):
    """Witness-wrap ``lock`` under RAY_TPU_TORCH_SANITIZE=1; identity when off.

    ``lock_id`` must match the static pass's naming — the lock
    definition's ``module.Class.attr`` relative to the package root —
    or the shutdown diff compares disjoint universes.
    """
    if not _ENABLED:
        return lock
    return _WitnessLock(lock, lock_id)


def observed_edges() -> Set[Tuple[str, str]]:
    return set(_observed_edges)


def lock_witness_violations(
        static_edges: Optional[Set[Tuple[str, str]]] = None
) -> Tuple[List[str], List[str]]:
    """(inversions, uncharted) of the observed order vs the static graph.

    An inversion is an observed edge (A held while B acquired) whose
    reverse edge exists — in the static graph or in this run's own
    observations. Uncharted edges (observed, absent from the static
    graph in either direction) are returned for visibility but are not
    violations: static resolution under-approximates by design.
    """
    if static_edges is None:
        from ray_tpu_torch._private.analysis import PACKAGE_ROOT, lock_order
        static_edges = lock_order.collect_edges(PACKAGE_ROOT)
    observed = set(_observed_edges)
    inversions = []
    for a, b in sorted(observed):
        if (b, a) in static_edges:
            inversions.append(
                f"runtime order {a} -> {b} (thread "
                f"{_observed_edges[(a, b)]}) inverts static edge "
                f"{b} -> {a}")
        elif (b, a) in observed and a < b:
            inversions.append(
                f"runtime orders {a} -> {b} and {b} -> {a} both "
                f"observed (threads {_observed_edges[(a, b)]} / "
                f"{_observed_edges[(b, a)]})")
    uncharted = [f"{a} -> {b}" for a, b in sorted(observed)
                 if (a, b) not in static_edges
                 and (b, a) not in static_edges]
    return inversions, uncharted


# ---------------------------------------------------------------------------
# shm / ObjectRef leak ledger
# ---------------------------------------------------------------------------

#: oid hex -> {"kind", "nbytes", "owner"}
_ledger: Dict[str, Dict] = {}
#: oid hexes referenced outside this process (ray:// client pins)
_external: Set[str] = set()
#: oid hex -> number of live registered ObjectRef instances
_live_refs: Dict[str, int] = {}
_owner_provider = None


def set_owner_provider(fn) -> None:
    """Install a zero-arg callable resolving the current task context
    (the task-event plane's id) for allocation attribution."""
    global _owner_provider
    _owner_provider = fn


def ledger_alloc(kind: str, object_id, nbytes: int) -> None:
    if not _ENABLED:
        return
    owner = "?"
    if _owner_provider is not None:
        try:
            owner = _owner_provider()
        except Exception:
            pass
    # an arena object migrating to the spill tier is still the same
    # logical allocation — keep the original record
    _ledger.setdefault(object_id.hex(), {
        "kind": kind, "nbytes": int(nbytes), "owner": owner})


def ledger_free(object_id) -> None:
    if not _ENABLED:
        return
    _ledger.pop(object_id.hex(), None)


def ledger_size() -> int:
    return len(_ledger)


def note_external_ref(object_id) -> None:
    """A reference held outside this process (client pin) keeps the
    object legitimately alive with no local ObjectRef instance."""
    if _ENABLED:
        _external.add(object_id.hex())


def drop_external_ref(object_id) -> None:
    if _ENABLED:
        _external.discard(object_id.hex())


def track_ref(ref) -> None:
    """Census a REGISTERED ObjectRef instance (weak — never extends the
    ref's lifetime)."""
    if not _ENABLED:
        return
    h = ref.object_id().hex()
    _live_refs[h] = _live_refs.get(h, 0) + 1
    try:
        weakref.finalize(ref, _ref_died, h)
    except TypeError:
        # not weakref-able: the count can never decrement, so the
        # census over-estimates liveness — never a false leak report
        pass


def _ref_died(h: str) -> None:
    n = _live_refs.get(h, 0) - 1
    if n > 0:
        _live_refs[h] = n
    else:
        _live_refs.pop(h, None)


def shm_leaks(live_oid_hexes: Set[str]) -> List[str]:
    """Ledger entries whose object no longer has a refcount row: the
    object left scope but its segment was never freed."""
    out = []
    for h, entry in sorted(_ledger.items()):
        if h in live_oid_hexes or h in _external:
            continue
        out.append(f"{entry['kind']} segment {h[:16]}… "
                   f"({entry['nbytes']} bytes, owner {entry['owner']}) "
                   f"out of scope but never freed")
    return out


def ref_leaks(counter_snapshot: Dict) -> List[str]:
    """Refcount rows with a positive local count but zero live
    registered ObjectRef instances: a decref was lost, the row (and
    everything it pins) can never be reclaimed."""
    out = []
    for oid, (local, submitted, borrowers, pinned) in sorted(
            counter_snapshot.items(), key=lambda kv: kv[0].hex()):
        h = oid.hex()
        if local > 0 and _live_refs.get(h, 0) == 0 \
                and h not in _external and not pinned:
            out.append(f"object {h[:16]}… local={local} with no live "
                       f"ObjectRef instance (lost decref)")
    return out


# ---------------------------------------------------------------------------
# wire-message schema assertions
# ---------------------------------------------------------------------------

_wire_violations: List[str] = []
_wire_schema = None  # channel -> (tag -> arity set, tag-only allow set)
_MAX_WIRE_VIOLATIONS = 100


def _build_wire_schema():
    """Compile the static channel table into live-checkable schemas —
    generated, not hand-maintained, so the two can't drift."""
    import os as _os

    from ray_tpu_torch._private.analysis import PACKAGE_ROOT, wire_protocol
    from ray_tpu_torch._private.analysis._astutil import parse_file

    schema = {}
    for ch in wire_protocol.DEFAULT_CHANNELS:
        sent: Dict[str, Set[int]] = {}
        for relpath in {s.file for s in ch.sends}:
            tree = parse_file(_os.path.normpath(
                _os.path.join(PACKAGE_ROOT, relpath)))
            if tree is None:
                continue
            specs = [s for s in ch.sends if s.file == relpath]
            for tag, arities in wire_protocol.collect_sends(
                    tree, specs).items():
                sent.setdefault(tag, set()).update(arities)
        allow = set(ch.assume_sent) | set(ch.assume_handled) \
            | _SYNTHETIC_TAGS
        schema[ch.name] = (sent, allow)
    return schema


def check_wire(channel: str, msg) -> None:
    """Validate one received message against the channel's generated
    schema; violations are recorded, never raised."""
    if not _ENABLED:
        return
    global _wire_schema
    if _wire_schema is None:
        _wire_schema = _build_wire_schema()
    sent, allow = _wire_schema.get(channel, ({}, set()))
    if not isinstance(msg, tuple) or not msg \
            or not isinstance(msg[0], str):
        _record_wire(f"[{channel}] non-tagged frame {type(msg).__name__}")
        return
    tag = msg[0]
    if tag in allow:
        return
    arities = sent.get(tag)
    if arities is None:
        _record_wire(f"[{channel}] tag {tag!r} not in the static "
                     f"channel table")
    elif len(msg) not in arities:
        _record_wire(f"[{channel}] tag {tag!r} arrived with arity "
                     f"{len(msg)}, static senders produce "
                     f"{sorted(arities)}")
    if tag == "many" and len(msg) > 1 and isinstance(msg[1],
                                                     (list, tuple)):
        for sub in msg[1]:
            check_wire(channel, sub)


def _record_wire(violation: str) -> None:
    if len(_wire_violations) < _MAX_WIRE_VIOLATIONS \
            and violation not in _wire_violations:
        _wire_violations.append(violation)


def wire_violations() -> List[str]:
    return list(_wire_violations)


# ---------------------------------------------------------------------------
# shutdown report
# ---------------------------------------------------------------------------

_last_report: Optional[Dict] = None


def report_at_shutdown(counter_snapshot: Dict,
                       static_edges: Optional[Set[Tuple[str, str]]] = None
                       ) -> Dict:
    """Assemble the full sanitizer report (called from
    ``Worker.shutdown``); each violation is logged as a warning and the
    report is kept for ``last_report()``."""
    global _last_report
    inversions, uncharted = lock_witness_violations(static_edges)
    report = {
        "lock_inversions": inversions,
        "lock_uncharted": uncharted,
        "shm_leaks": shm_leaks({oid.hex() for oid in counter_snapshot}),
        "ref_leaks": ref_leaks(counter_snapshot),
        "wire_violations": wire_violations(),
    }
    for section in ("lock_inversions", "shm_leaks", "ref_leaks",
                    "wire_violations"):
        for v in report[section]:
            logger.warning("sanitizer [%s] %s", section, v)
    _last_report = report
    return report


def last_report() -> Optional[Dict]:
    return _last_report


def clean(report: Optional[Dict] = None) -> bool:
    """True when the report carries no violations (uncharted edges are
    informational and do not count)."""
    r = _last_report if report is None else report
    if r is None:
        return True
    return not (r["lock_inversions"] or r["shm_leaks"]
                or r["ref_leaks"] or r["wire_violations"])


reset()
