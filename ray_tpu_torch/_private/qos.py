"""Multi-tenant QoS plane: priority tiers, weighted fair-share, preemption.

Owner-side state machine for the ``qos`` knob (see config.py). Tracks
every head-owned task through queued -> running -> done, orders ready
work by strict priority tier with weighted deficit fair-share between
tenants inside a tier, decides when a starved higher tier may preempt
the lowest-tier running victim, and exports the per-node top-spilled-
tier watermark that gates local admission in the node daemons.

Design notes
------------
* Strict tiers: a higher ``priority`` always dispatches before a lower
  one; ties break by tenant fair-share, then FIFO.
* Fair share inside a tier is deficit-based: each tenant carries a
  served counter; among tenants with ready work the one with the
  smallest ``served / weight`` virtual time dispatches next. Weights
  come from the ``tenant_quotas`` JSON knob (unlisted tenants weigh 1).
  The exported deficit is ``expected - served`` where expected is the
  tenant's weight share of everything served so far — positive means
  underserved.
* Preemption is a *decision* here and an *execution* in worker.py: the
  plane reports a victim once the highest queued tier has exceeded the
  lowest running tier for ``preempt_grace_s``; the worker kills the
  victim through the same paths the deadline watcher uses, so the
  failure is a synthetic worker death (bumped attempt, journaled lease,
  exactly-once) and never a double execution.
* Everything is inert when the knob is off: the worker simply never
  constructs a plane, and no frame, envelope, or queue order changes.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

QUEUED = 0
RUNNING = 1


def parse_tenant_quotas(raw: str) -> Dict[str, float]:
    """Parse the ``tenant_quotas`` knob: a JSON object mapping tenant
    name -> positive weight. Bad JSON or bad values raise ValueError at
    init() time rather than silently running unfair."""
    if not raw:
        return {}
    try:
        obj = json.loads(raw)
    except Exception as e:  # noqa: BLE001
        raise ValueError(f"tenant_quotas is not valid JSON: {e}") from e
    if not isinstance(obj, dict):
        raise ValueError("tenant_quotas must be a JSON object "
                         "{tenant: weight}")
    out: Dict[str, float] = {}
    for k, v in obj.items():
        try:
            w = float(v)
        except (TypeError, ValueError):
            raise ValueError(
                f"tenant_quotas[{k!r}] must be a number, got {v!r}")
        if w <= 0:
            raise ValueError(
                f"tenant_quotas[{k!r}] must be positive, got {w}")
        out[str(k)] = w
    return out


class _TenantState:
    __slots__ = ("queued", "running", "preempted", "served")

    def __init__(self):
        self.queued = 0
        self.running = 0
        self.preempted = 0
        # dispatch count, the fair-share virtual-time numerator
        self.served = 0


class QosPlane:
    """Tenancy/QoS bookkeeping for one owner (the head worker)."""

    def __init__(self, tenant_quotas: str = "",
                 preempt_grace_s: float = 1.0):
        self._lock = threading.Lock()
        self._weights = parse_tenant_quotas(tenant_quotas)
        self._grace = max(0.0, float(preempt_grace_s))
        self._tenants: Dict[str, _TenantState] = {}
        # task_id -> (tenant, tier, phase); the single source of truth
        # for queued/running membership, victim discovery, and the
        # watermark. Bounded by the pending-task count.
        self._tasks: Dict[Any, Tuple[str, int, int]] = {}
        # queued-count per tier, kept incrementally so the watermark
        # read on every resview push is O(#distinct tiers)
        self._queued_by_tier: Dict[int, int] = {}
        self._preempts_by_tier: Dict[int, int] = {}
        self._preemptions_total = 0
        # starvation clock: set when the top queued tier first exceeds
        # the lowest running tier, cleared when the inversion clears
        self._starved_since: Optional[float] = None
        self._starved_tier: Optional[int] = None

    # -- weights -----------------------------------------------------
    def weight_of(self, tenant: str) -> float:
        return self._weights.get(tenant, 1.0)

    def _state(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            st = self._tenants[tenant] = _TenantState()
        return st

    # -- task lifecycle ----------------------------------------------
    def note_queued(self, task_id, tenant: str, tier: int) -> None:
        with self._lock:
            self._tasks[task_id] = (tenant, tier, QUEUED)
            self._state(tenant).queued += 1
            self._queued_by_tier[tier] = \
                self._queued_by_tier.get(tier, 0) + 1

    def note_dispatched(self, task_id) -> None:
        with self._lock:
            ent = self._tasks.get(task_id)
            if ent is None or ent[2] != QUEUED:
                return
            tenant, tier, _ = ent
            self._tasks[task_id] = (tenant, tier, RUNNING)
            st = self._state(tenant)
            st.queued -= 1
            st.running += 1
            st.served += 1
            self._dec_queued_tier(tier)

    def note_rekeyed(self, old_id, new_id) -> None:
        """A retry re-enters the queue under a fresh attempt id."""
        with self._lock:
            ent = self._tasks.pop(old_id, None)
            if ent is None:
                return
            tenant, tier, phase = ent
            st = self._state(tenant)
            if phase == RUNNING:
                st.running -= 1
                st.queued += 1
                self._queued_by_tier[tier] = \
                    self._queued_by_tier.get(tier, 0) + 1
            self._tasks[new_id] = (tenant, tier, QUEUED)

    def note_done(self, task_id) -> None:
        with self._lock:
            ent = self._tasks.pop(task_id, None)
            if ent is None:
                return
            tenant, tier, phase = ent
            st = self._state(tenant)
            if phase == RUNNING:
                st.running -= 1
            else:
                st.queued -= 1
                self._dec_queued_tier(tier)

    def _dec_queued_tier(self, tier: int) -> None:
        n = self._queued_by_tier.get(tier, 0) - 1
        if n <= 0:
            self._queued_by_tier.pop(tier, None)
        else:
            self._queued_by_tier[tier] = n

    # -- fair-share ordering -----------------------------------------
    def order(self, keys: Sequence[Tuple[int, str]]) -> List[int]:
        """Dispatch order for one drain: ``keys`` is [(tier, tenant)]
        in FIFO arrival order; returns index order. Strict tiers first,
        then weighted deficit round-robin between tenants inside each
        tier (persistent served counters, so fairness converges across
        drains), FIFO within a tenant."""
        n = len(keys)
        if n <= 1:
            return list(range(n))
        with self._lock:
            # bucket by tier, preserving FIFO per (tier, tenant)
            tiers: Dict[int, Dict[str, List[int]]] = {}
            for i, (tier, tenant) in enumerate(keys):
                tiers.setdefault(tier, {}).setdefault(tenant, []).append(i)
            out: List[int] = []
            # virtual times are SEEDED from the persistent served
            # counters and advanced locally for this drain only —
            # note_dispatched() is the sole place served actually
            # grows, so re-draining undispatched work never inflates a
            # tenant's share
            vt: Dict[str, float] = {}
            for tier in sorted(tiers, reverse=True):
                queues = tiers[tier]
                pos = {t: 0 for t in queues}
                for t in queues:
                    if t not in vt:
                        w = self._weights.get(t, 1.0)
                        vt[t] = self._state(t).served / w
                remaining = sum(len(v) for v in queues.values())
                while remaining:
                    best_t = None
                    best_vt = None
                    for t, idxs in queues.items():
                        if pos[t] >= len(idxs):
                            continue
                        if best_vt is None or vt[t] < best_vt:
                            best_vt, best_t = vt[t], t
                    out.append(queues[best_t][pos[best_t]])
                    pos[best_t] += 1
                    vt[best_t] += 1.0 / self._weights.get(best_t, 1.0)
                    remaining -= 1
            return out

    # -- watermark ----------------------------------------------------
    def top_queued_tier(self) -> Optional[int]:
        """Highest priority tier with head-queued work — the per-node
        top-spilled-tier watermark pushed on resview frames. None when
        nothing is queued (daemons admit freely)."""
        with self._lock:
            if not self._queued_by_tier:
                return None
            return max(self._queued_by_tier)

    # -- preemption decision -------------------------------------------
    def check_preempt(self, now: float):
        """Returns (victim_task_id, victim_tenant, victim_tier,
        starved_tier) once the highest queued tier has strictly
        exceeded the lowest running tier for ``preempt_grace_s``
        continuously; None otherwise. The caller executes the kill and
        then reports it via note_preempted()."""
        with self._lock:
            top_q = max(self._queued_by_tier) if self._queued_by_tier \
                else None
            victim = None
            low = None
            if top_q is not None:
                for tid, (tenant, tier, phase) in self._tasks.items():
                    if phase != RUNNING or tier >= top_q:
                        continue
                    if low is None or tier < low:
                        low = tier
                        victim = (tid, tenant, tier)
            if victim is None:
                self._starved_since = None
                self._starved_tier = None
                return None
            if self._starved_since is None or self._starved_tier != top_q:
                self._starved_since = now
                self._starved_tier = top_q
                if self._grace > 0:
                    return None
            if now - self._starved_since < self._grace:
                return None
            # one victim per grace window: restart the clock so a slow
            # kill doesn't machine-gun the whole lower tier at once
            self._starved_since = now
            return victim + (top_q,)

    def note_preempted(self, tenant: str, tier: int) -> None:
        with self._lock:
            self._state(tenant).preempted += 1
            self._preempts_by_tier[tier] = \
                self._preempts_by_tier.get(tier, 0) + 1
            self._preemptions_total += 1

    # -- introspection -------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Snapshot for metrics, state.list_tenants(), the dashboard."""
        with self._lock:
            total_served = sum(s.served for s in self._tenants.values())
            wsum = sum(self._weights.get(t, 1.0) for t in self._tenants) \
                or 1.0
            tenants = {}
            for t, st in self._tenants.items():
                w = self._weights.get(t, 1.0)
                share = w / wsum
                expected = total_served * share
                tenants[t] = {
                    "weight": w,
                    "share": share,
                    "served": st.served,
                    # positive = underserved relative to weight share
                    "deficit": expected - st.served,
                    "queued": st.queued,
                    "running": st.running,
                    "preempted": st.preempted,
                }
            return {
                "tenants": tenants,
                "preemptions_total": self._preemptions_total,
                "preempts_by_tier": dict(self._preempts_by_tier),
                "top_queued_tier": (max(self._queued_by_tier)
                                    if self._queued_by_tier else None),
            }
