"""Public chaos-engineering surface: seeded, reproducible fault
injection against a live runtime (head-side; no-op in client mode).

Example — inject three fault kinds during a run and replay them::

    import ray_tpu_torch
    from ray_tpu_torch import chaos

    ray_tpu_torch.init(num_workers=4, _system_config={"worker_mode": "process"})
    chaos.arm(chaos.FaultPlan(seed=7, faults=[
        ("task", 5, "exception"),        # 6th task poll raises
        ("worker", 12, "kill"),          # SIGKILL the 13th assignment's worker
        ("link", 20, "delay", {"delay_s": 0.05}),
    ]))
    results = ray_tpu_torch.get([f.remote(i) for i in range(200)])
    print(chaos.list_faults())           # identical for identical seeds
    print(chaos.counters())              # injected/recovered per site

(The reference also exposes ``list_faults()`` through ``util.state`` and
the counters as metrics series; neither is ported yet.)
"""

from __future__ import annotations

from typing import Any, Dict, List

from ray_tpu_torch._private.chaos import (  # noqa: F401
    SITES,
    FaultController,
    FaultPlan,
    get_controller,
)

__all__ = [
    "FaultPlan", "FaultController", "SITES", "get_controller",
    "arm", "disarm", "reset", "set_probability", "list_faults",
    "counters",
]


def arm(plan: FaultPlan) -> None:
    """Install a seeded fault schedule (resets the log and counters)."""
    get_controller().arm(plan)


def disarm() -> None:
    """Stop injecting; keeps the log/counters for inspection."""
    get_controller().disarm()


def reset() -> None:
    """Clear schedule, log, and counters (runtime shutdown does this)."""
    get_controller().reset()


def set_probability(site: str, prob: float, **params: Any) -> None:
    """Probabilistic injection at ``site``; draws are seeded per arrival."""
    get_controller().set_probability(site, prob, **params)


def list_faults() -> List[Dict[str, Any]]:
    """The injection log: ``{seq, site, kind, when, context}`` rows."""
    return get_controller().list_faults()


def counters() -> Dict[str, Any]:
    """Injected/recovered counts per site plus totals."""
    return get_controller().counters()
