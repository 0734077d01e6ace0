"""Autoscaler — demand-driven node provisioning.

Reference surface: the autoscaler monitor loop
(ray: python/ray/autoscaler/_private/ — StandardAutoscaler reads
pending demand from the GCS, bin-packs over node types, asks a
NodeProvider to launch/terminate; the fake_multi_node provider is the
test harness). Here: the monitor reads the scheduler's live tables
(ready backlog + infeasible tasks), asks the provider for nodes when
demand persists, and releases idle ones after a timeout. The provider
protocol is two callables — the virtual-cluster provider backs them
with Worker.add_cluster_node/on_node_failure, a cloud provider would
back them with instance APIs.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class AutoscalerConfig:
    min_nodes: int = 0
    max_nodes: int = 4
    # demand must persist this many consecutive polls before scaling up
    upscale_ticks: int = 2
    idle_timeout_s: float = 10.0
    poll_interval_s: float = 0.25


class VirtualNodeProvider:
    """The fake-multi-node provider: launches REAL per-node runtimes on
    this host (reference: autoscaler/_private/fake_multi_node)."""

    def __init__(self, worker, num_cpus: float = 4.0,
                 num_workers: int = 2):
        self._worker = worker
        self._num_cpus = num_cpus
        self._num_workers = num_workers

    def create_node(self):
        return self._worker.add_cluster_node(
            num_cpus=self._num_cpus, num_workers=self._num_workers)

    def terminate_node(self, entry) -> None:
        self._worker.on_node_failure(entry.node_id,
                                     reason="autoscaler scale-down")


class Autoscaler:
    """Monitor loop over the scheduler's live state."""

    def __init__(self, worker, provider,
                 config: Optional[AutoscalerConfig] = None):
        self._worker = worker
        self._provider = provider
        self._config = config or AutoscalerConfig()
        self._nodes: List[Any] = []       # provider-launched entries
        self._pressure_ticks = 0
        self._idle_since: Dict[int, float] = {}  # node index -> t
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.num_upscales = 0
        self.num_downscales = 0

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        for _ in range(self._config.min_nodes):
            self._nodes.append(self._provider.create_node())
            self.num_upscales += 1
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ray_tpu_autoscaler")
        self._thread.start()

    def stop(self) -> None:
        self._shutdown.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # -- the monitor loop ----------------------------------------------
    def _loop(self) -> None:
        cfg = self._config
        while not self._shutdown.wait(cfg.poll_interval_s):
            try:
                self._tick()
            except Exception:
                logger.exception("autoscaler tick failed")

    def _pending_demand(self) -> int:
        stats = self._worker.scheduler.stats()
        return int(stats.get("ready_queue", 0)
                   + stats.get("infeasible", 0))

    def _tick(self) -> None:
        cfg = self._config
        demand = self._pending_demand()
        if demand > 0:
            self._pressure_ticks += 1
        else:
            self._pressure_ticks = 0

        if self._pressure_ticks >= cfg.upscale_ticks \
                and len(self._nodes) < cfg.max_nodes:
            logger.info("autoscaler: %d pending for %d ticks -> +1 node",
                        demand, self._pressure_ticks)
            self._nodes.append(self._provider.create_node())
            self.num_upscales += 1
            self._pressure_ticks = 0
            return

        # scale down: a provider node with nothing running on it for
        # idle_timeout_s goes back (never below min_nodes)
        if len(self._nodes) <= cfg.min_nodes or demand > 0:
            self._idle_since.clear()
            return
        busy_nodes = {row["node_index"]
                      for row in self._worker.scheduler.task_table()
                      if row["state"] == "RUNNING"}
        now = time.monotonic()
        for entry in list(self._nodes):
            if entry.index in busy_nodes or entry.state != "ALIVE":
                self._idle_since.pop(entry.index, None)
                continue
            first = self._idle_since.setdefault(entry.index, now)
            if now - first >= cfg.idle_timeout_s:
                logger.info("autoscaler: node %d idle %.1fs -> -1 node",
                            entry.index, now - first)
                self._provider.terminate_node(entry)
                self._nodes.remove(entry)
                self._idle_since.pop(entry.index, None)
                self.num_downscales += 1
                return

    def stats(self) -> Dict[str, Any]:
        return {"provider_nodes": len(self._nodes),
                "upscales": self.num_upscales,
                "downscales": self.num_downscales}


@dataclasses.dataclass
class GangAutoscalerConfig(AutoscalerConfig):
    # v2 (gang-aware) knobs --------------------------------------------
    # mean cluster CPU (from the utilization ring) above this percent
    # counts as pressure even with an empty ready backlog; <= 0 disables
    # the ring signal and falls back to backlog-only pressure
    util_pressure_pct: float = 85.0
    # pending gangs whose name roots a still-live trace get +1 tier
    # (the trace plane's open chains ARE the critical paths: work the
    # driver is blocked on right now)
    critical_path_boost: bool = False


class GangAutoscaler(Autoscaler):
    """v2 monitor: everything v1 does, plus whole-gang scale-up.

    v1 adds one node per persistent-pressure window and lets pending
    placement groups race for whatever lands — a G-bundle STRICT_SPREAD
    gang can sit behind G separate upscale windows, each partially
    consumed by unrelated backlog. v2 reads the pending-gang table from
    the PG manager every tick, solves the tier-aware batched pack
    (kernels.pack_gangs_tiered_np) against HYPOTHETICAL capacity —
    current snapshot + k provider-template nodes — and commits the
    whole scale-up at once, smallest k first. The reservation itself
    stays atomic: nodes join, the manager is poked, and its existing
    2-phase add_bundle_nodes places every bundle of a gang or none, so
    no partial placement group is ever visible. Pressure additionally
    reads the utilization ring (profile plane) so a compute-saturated
    cluster scales before the backlog does, and live-trace roots can
    optionally boost a gang's tier (critical-path boost).
    ``util_pressure_pct`` acts only while the profile plane is on
    (``profile_hz > 0``); without it pressure is the backlog alone.
    """

    def __init__(self, worker, provider,
                 config: Optional[GangAutoscalerConfig] = None):
        super().__init__(worker, provider,
                         config or GangAutoscalerConfig())
        self.num_gang_upscales = 0

    def start(self) -> None:
        # gangs the CURRENT cluster can never fit are this scaler's
        # demand signal — park them pending instead of failing them
        manager = getattr(self._worker, "placement_groups", None)
        if manager is not None:
            manager.hold_infeasible = True
        super().start()

    def stop(self) -> None:
        manager = getattr(self._worker, "placement_groups", None)
        if manager is not None:
            manager.hold_infeasible = False
        super().stop()

    # -- pressure: utilization ring on top of backlog --------------------
    def _pending_demand(self) -> int:
        demand = super()._pending_demand()
        cfg = self._config
        pct = getattr(cfg, "util_pressure_pct", 0.0)
        plane = getattr(self._worker, "profile_plane", None)
        if demand == 0 and pct > 0 and plane is not None:
            cpus = [series.get("cpu_percent")
                    for series in plane.utilization_latest().values()
                    if series.get("cpu_percent") is not None]
            if cpus and sum(cpus) / len(cpus) >= pct:
                demand = 1
        return demand

    # -- gang tiers ------------------------------------------------------
    def _gang_tiers(self, gangs: List[Dict[str, Any]]) -> List[int]:
        tiers = [int(g["priority"]) for g in gangs]
        if not getattr(self._config, "critical_path_boost", False):
            return tiers
        plane = getattr(self._worker, "trace_plane", None)
        if plane is None:
            return tiers
        try:
            hot = {row.get("root") for row in plane.list_traces()
                   if row.get("live_spans", 0) > 0}
        except Exception:
            return tiers
        hot.discard(None)
        return [t + 1 if g["name"] and g["name"] in hot else t
                for g, t in zip(gangs, tiers)]

    # -- the gang pass ----------------------------------------------------
    def _node_template(self, cap: np.ndarray) -> np.ndarray:
        """Resource vector one provider node would contribute: the
        provider's CPU count, every other axis (memory, TPU) mirroring
        the most generous existing physical node."""
        from ray_tpu_torch._private.task_spec import RESOURCE_CPU, \
            resources_to_vector

        cpus = getattr(self._provider, "_num_cpus", 4.0)
        tmpl = np.asarray(resources_to_vector({"CPU": float(cpus)}),
                          dtype=np.float32)
        if cap.size:
            best = cap.max(axis=0)
            best[RESOURCE_CPU] = tmpl[RESOURCE_CPU]
            tmpl = best.astype(np.float32)
        return tmpl

    def _try_gang_scaleup(self) -> bool:
        """Place-before-commit: find the smallest k <= headroom such
        that the tier-aware pack admits at least one currently pending
        gang on snapshot + k template nodes, launch exactly k, and poke
        the manager. Returns True if it scaled."""
        from ray_tpu_torch._private.scheduler import kernels

        cfg = self._config
        manager = getattr(self._worker, "placement_groups", None)
        if manager is None:
            return False
        gangs = manager.pending_gangs()
        if not gangs:
            return False
        headroom = cfg.max_nodes - len(self._nodes)
        if headroom <= 0:
            return False
        avail, cap, _rows = self._worker.scheduler.pack_snapshot()
        tmpl = self._node_template(cap)
        # pad gangs to one [G,B,R] block (zero-demand rows fit anywhere
        # and consume nothing); STRICT_PACK collapses to one summed
        # bundle, STRICT_SPREAD sets the distinct-nodes flag — the
        # non-strict strategies degrade to first-fit, which is exactly
        # what the manager's real pack will accept or better
        mats = []
        for g in gangs:
            d = np.asarray(g["demands"], dtype=np.float32)
            if g["strategy"] == "STRICT_PACK":
                d = d.sum(axis=0, keepdims=True)
            mats.append(d)
        B = max(m.shape[0] for m in mats)
        demands = np.zeros((len(gangs), B, tmpl.shape[0]),
                           dtype=np.float32)
        for i, d in enumerate(mats):
            demands[i, :d.shape[0], :d.shape[1]] = d
        spread = np.asarray([g["strategy"] == "STRICT_SPREAD"
                             for g in gangs], dtype=bool)
        tiers = np.asarray(self._gang_tiers(gangs), dtype=np.int64)
        base_avail = avail if avail.size else np.zeros((0, tmpl.shape[0]),
                                                       dtype=np.float32)
        base_cap = cap if cap.size else base_avail
        if base_avail.shape[0]:
            # k=0: a gang that already fits just needs the retry thread,
            # not a new node (it is pending only transiently)
            _n0, ok0, _r0 = kernels.pack_gangs_tiered_np(
                demands, tiers, base_avail, base_cap, spread=spread)
            if ok0.any():
                manager.poke()
                return False
        for k in range(1, headroom + 1):
            extra = np.tile(tmpl, (k, 1))
            hyp_avail = np.concatenate([base_avail, extra], axis=0)
            hyp_cap = np.concatenate([base_cap, extra], axis=0)
            _node_of, ok, _rem = kernels.pack_gangs_tiered_np(
                demands, tiers, hyp_avail, hyp_cap, spread=spread)
            if ok.any():
                logger.info(
                    "gang autoscaler: %d/%d pending gang(s) fit on +%d "
                    "node(s) (top tier %d) -> scaling", int(ok.sum()),
                    len(gangs), k, int(tiers.max()))
                # the gang lands once the whole decision has joined and
                # been counted: the manager holds its retries until then
                # and is poked as the hold ends. A create_node that dies
                # mid-loop may still have registered scheduler capacity:
                # the poke comes regardless, so the manager uses what
                # landed, and k is re-evaluated from the real node count
                # next tick
                with manager.provisioning():
                    for _ in range(k):
                        self._nodes.append(self._provider.create_node())
                        self.num_upscales += 1
                    self.num_gang_upscales += 1
                return True
        return False

    def _tick(self) -> None:
        if self._try_gang_scaleup():
            self._pressure_ticks = 0
            return
        super()._tick()

    def stats(self) -> Dict[str, Any]:
        out = super().stats()
        out["gang_upscales"] = self.num_gang_upscales
        return out
