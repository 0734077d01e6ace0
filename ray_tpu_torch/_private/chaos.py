"""Seeded chaos plane: scheduleable fault injection with named sites.

Reference: the reference repo exercises its recovery paths with ad-hoc
helpers (``testing_inject_task_failure_prob``, chaos kill in
cluster_utils); real chaos frameworks (Jepsen, ChaosMonkey) make fault
schedules *deterministic* so a failing run can be replayed bit-for-bit.
This module is that layer for ray_tpu_torch: a process-wide
:class:`FaultController` owns every injection decision, driven by a
seeded :class:`FaultPlan` (fire fault KIND at the Nth arrival of SITE)
plus optional per-site probabilities whose draws are derived from
``(seed, site, arrival)`` — so two runs with the same seed inject the
identical fault sequence regardless of thread interleaving.

Injection sites threaded through the runtime (see ``SITES``):

========== ==================== =====================================
site       kinds                hooked where
========== ==================== =====================================
task       exception, hang      thread: Worker._maybe_inject_failure;
                                process: per-payload at _build_payload
worker     kill                 ProcessWorkerPool / RemoteNodePool
                                SIGKILL the assigned worker
link       delay, drop          ProcessWorkerPool pipe send and
                                RemoteNodePool._send_daemon
transfer   truncate             RemoteNodePool.fetch_object (wire
                                corruption of object bytes)
sched_tick slow                 Worker dispatch path (slow node)
heartbeat  drop                 GcsService health loop (node stays
                                connected but its heartbeat is lost)
head       kill, restart, flap  GcsService health loop: ``flap``
                                severs every remote daemon link
                                (exercising outbox replay + rejoin
                                re-attach without killing anyone);
                                ``kill`` SIGKILLs the head process
                                itself; ``restart`` is a marker for
                                external harnesses (bench/soak
                                drivers kill + relaunch the head
                                subprocess at the seeded arrival)
node       kill, restart, flap  GcsService health loop: ``kill``
                                SIGKILLs a remote node's daemon
                                with its whole worker tree (the
                                machine-death drill — the head-side
                                node-death reconciler must retry or
                                fail its adopted local leases, purge
                                ghost gossip views, and broadcast
                                route invalidation); ``flap`` severs
                                just that node's daemon link;
                                ``restart`` is a marker for external
                                harnesses (kill + relaunch the node
                                process). Params: ``node`` selects
                                the victim scheduler row (default:
                                the lowest-index alive remote node)
peer_link  delay, drop, sever   NodeDaemon peer actor lane (p2p
                                actor calls): ``delay`` stalls the
                                frame, ``drop`` loses the call
                                (immediate head fallback), ``sever``
                                kills the lane socket mid-flight so
                                every in-flight call on it falls
                                back to the head path. Polled on
                                DAEMON processes: the head mirrors
                                its armed plan to daemons through
                                the resview push, and daemon-fired
                                injections ride the outbox back as
                                ("fault", entry) reports
========== ==================== =====================================

The public surface is :mod:`ray_tpu_torch.chaos`; ``state.list_faults()``
returns the injection log and ``_private/metrics.py`` exports the
injected/recovered counters.
"""

from __future__ import annotations

import random
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

SITES: Tuple[str, ...] = (
    "task", "worker", "link", "transfer", "sched_tick", "heartbeat",
    "head", "node", "peer_link")

_SITE_KINDS: Dict[str, Tuple[str, ...]] = {
    "task": ("exception", "hang"),
    "worker": ("kill",),
    "link": ("delay", "drop"),
    "transfer": ("truncate",),
    "sched_tick": ("slow",),
    "heartbeat": ("drop",),
    "head": ("kill", "restart", "flap"),
    "node": ("kill", "restart", "flap"),
    "peer_link": ("delay", "drop", "sever"),
}

# default parameters for kinds that need one; overridable per plan entry
# or per set_probability call
_DEFAULT_PARAMS: Dict[str, Dict[str, float]] = {
    "hang": {"hang_s": 0.2},
    "delay": {"delay_s": 0.05},
    "slow": {"delay_s": 0.05},
    "truncate": {"keep_fraction": 0.5},
}


class FaultPlan:
    """A deterministic fault schedule: ``(site, when, kind[, params])``
    entries, where ``when`` is the 0-based arrival index at ``site``
    (the Nth time the runtime consults the controller for that site).
    The seed drives probability draws and retry-backoff jitter; the
    scheduled entries themselves are exact."""

    def __init__(self, seed: int,
                 faults: Iterable[Sequence[Any]] = ()):
        self.seed = int(seed)
        self.faults: List[Tuple[str, int, str, Dict[str, Any]]] = []
        for entry in faults:
            site, when, kind = entry[0], int(entry[1]), entry[2]
            params = dict(entry[3]) if len(entry) > 3 else {}
            if site not in _SITE_KINDS:
                raise ValueError(f"unknown fault site {site!r}; "
                                 f"sites: {sorted(_SITE_KINDS)}")
            if kind not in _SITE_KINDS[site]:
                raise ValueError(
                    f"site {site!r} supports kinds {_SITE_KINDS[site]}, "
                    f"got {kind!r}")
            self.faults.append((site, when, kind, params))

    def __repr__(self):
        return (f"FaultPlan(seed={self.seed}, "
                f"faults={[(s, w, k) for s, w, k, _ in self.faults]})")


class FaultController:
    """Process-wide injection-decision owner. All runtime hooks call
    :meth:`poll` (near-zero cost while disarmed: one attribute read)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._armed = False          # fast-path gate, read without lock
        self._seed = 0
        self._plan: Dict[Tuple[str, int], Tuple[str, Dict[str, Any]]] = {}
        self._probs: Dict[str, Tuple[float, Dict[str, Any]]] = {}
        self._arrivals: Dict[str, int] = {}
        self._log: List[Dict[str, Any]] = []
        self._injected: Dict[str, int] = {}
        self._recovered: Dict[str, int] = {}
        self._cfg_entry = None       # live testing_inject_task_failure_prob

    # -- configuration ------------------------------------------------------
    def arm(self, plan: FaultPlan) -> None:
        """Install a plan (replaces any previous schedule; counters and
        the log reset so ``list_faults()`` describes exactly this run)."""
        with self._lock:
            self._seed = plan.seed
            self._plan = {(s, w): (k, p) for s, w, k, p in plan.faults}
            self._arrivals = {}
            self._log = []
            self._injected = {}
            self._recovered = {}
            self._armed = True

    def set_probability(self, site: str, prob: float, **params: Any) -> None:
        """Probabilistic injection at ``site`` (seeded: the draw for the
        Nth arrival is a pure function of (seed, site, N))."""
        if site not in _SITE_KINDS:
            raise ValueError(f"unknown fault site {site!r}")
        with self._lock:
            if prob <= 0.0:
                self._probs.pop(site, None)
            else:
                self._probs[site] = (float(prob), params)
            self._armed = bool(self._plan or self._probs)

    def plan_snapshot(self) -> Optional[Dict[str, Any]]:
        """Picklable image of the armed schedule, or None when
        disarmed. Daemons mirror the head's plan from this (resview
        push) so seeded faults fire at deterministic arrivals on the
        process that actually hosts the site (e.g. ``peer_link``)."""
        with self._lock:
            if not self._armed:
                return None
            return {
                "seed": self._seed,
                "faults": [(s, w, k, dict(p))
                           for (s, w), (k, p) in sorted(self._plan.items())],
                "probs": {s: (p, dict(params))
                          for s, (p, params) in self._probs.items()},
            }

    def arm_snapshot(self, snap: Optional[Dict[str, Any]]) -> None:
        """Install (or, with None, disarm) a schedule mirrored from
        another process's :meth:`plan_snapshot`."""
        if snap is None:
            self.disarm()
            return
        self.arm(FaultPlan(snap.get("seed", 0), snap.get("faults", ())))
        for site, (p, params) in (snap.get("probs") or {}).items():
            self.set_probability(site, p, **params)

    def note_remote(self, entry: Dict[str, Any]) -> None:
        """Record an injection that FIRED on another process (a daemon
        reported it over the outbox): it joins this controller's log
        and counters so ``list_faults()``/metrics stay cluster-wide."""
        with self._lock:
            site = entry.get("site", "?")
            self._injected[site] = self._injected.get(site, 0) + 1
            e = dict(entry)
            e["seq"] = len(self._log)
            self._log.append(e)

    def disarm(self) -> None:
        """Stop injecting; the log and counters survive for inspection."""
        with self._lock:
            self._armed = False
            self._plan = {}
            self._probs = {}

    def reset(self) -> None:
        """Full reset (called at runtime shutdown)."""
        with self._lock:
            self._armed = False
            self._seed = 0
            self._plan = {}
            self._probs = {}
            self._arrivals = {}
            self._log = []
            self._injected = {}
            self._recovered = {}

    # -- the hot hook -------------------------------------------------------
    def armed(self) -> bool:
        """Lock-free fast-path gate (same read poll() itself leads
        with): callers that poll non-``task`` sites once per leased
        task may skip the whole loop when no plan is armed — arrival
        counting only happens while armed, so the skip is invisible to
        any plan's ``when`` coordinates."""
        return self._armed

    def poll(self, site: str, **context: Any) -> Optional[Dict[str, Any]]:
        """Consult the controller at an injection site. Returns a fault
        descriptor ``{"kind": ..., <params>}`` or None. Counts one
        arrival at ``site`` whenever the controller is armed (arrival
        indices are the plan's ``when`` coordinates).

        The ``task`` site additionally honors the live
        ``testing_inject_task_failure_prob`` config knob, re-read per
        task (it used to be baked into ProcessWorkerPool at
        construction).
        """
        if not self._armed:
            if site == "task":
                return self._poll_config_prob(context)
            return None
        with self._lock:
            n = self._arrivals.get(site, 0)
            self._arrivals[site] = n + 1
            hit = self._plan.get((site, n))
            if hit is not None:
                kind, params = hit
                return self._fire_locked(site, kind, n, params, context)
            prob = self._probs.get(site)
            if prob is not None:
                p, params = prob
                if self._draw(site, n) < p:
                    kind = params.get("kind", _SITE_KINDS[site][0])
                    return self._fire_locked(site, kind, n, params, context)
        if site == "task":
            return self._poll_config_prob(context)
        return None

    def note_recovery(self, site: str, **context: Any) -> None:
        """Record that the runtime recovered from an injected fault
        (retry scheduled, node respawned elsewhere, ...)."""
        with self._lock:
            self._recovered[site] = self._recovered.get(site, 0) + 1

    # -- observability ------------------------------------------------------
    def list_faults(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._log]

    def counters(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "injected": dict(self._injected),
                "recovered": dict(self._recovered),
                "injected_total": sum(self._injected.values()),
                "recovered_total": sum(self._recovered.values()),
            }

    @property
    def seed(self) -> int:
        return self._seed

    # -- internals ----------------------------------------------------------
    def _fire_locked(self, site: str, kind: str, when: int,
                     params: Dict[str, Any],
                     context: Dict[str, Any]) -> Dict[str, Any]:
        fault = dict(_DEFAULT_PARAMS.get(kind, {}))
        fault.update({k: v for k, v in params.items() if k != "kind"})
        fault["kind"] = kind
        self._injected[site] = self._injected.get(site, 0) + 1
        self._log.append({
            "seq": len(self._log), "site": site, "kind": kind,
            "when": when, "context": dict(context),
        })
        return fault

    def _draw(self, site: str, arrival: int) -> float:
        # pure function of (seed, site, arrival): thread interleaving
        # across sites cannot perturb the sequence
        return random.Random(f"{self._seed}:{site}:{arrival}").random()

    def _poll_config_prob(self, context) -> Optional[Dict[str, Any]]:
        ent = self._cfg_entry
        if ent is None:
            from ray_tpu_torch._private.config import GLOBAL_CONFIG
            ent = self._cfg_entry = GLOBAL_CONFIG.entry(
                "testing_inject_task_failure_prob")
        p = ent.value
        if p > 0.0 and random.random() < p:
            with self._lock:
                return self._fire_locked(
                    "task", "exception", self._arrivals.get("task", 0),
                    {}, dict(context))
        return None

    def backoff_jitter(self, attempt: int, task_key: str = "") -> float:
        """Deterministic jitter factor in [0.5, 1.0) for retry backoff,
        derived from the chaos seed so soak runs replay exactly."""
        return 0.5 + 0.5 * random.Random(
            f"{self._seed}:backoff:{task_key}:{attempt}").random()


_CONTROLLER = FaultController()


def get_controller() -> FaultController:
    return _CONTROLLER
