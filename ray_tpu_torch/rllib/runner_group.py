"""Fault-tolerant env-runner group shared by the algorithms.

Counterpart of ``ray_tpu/rllib/runner_group.py`` on the port's runtime.

Reference: ray: rllib/env/env_runner_group.py — a set of sampling
actors with restore-on-failure. Both PPO and DQN use the same
protocol: fan the current params out, gather rollouts, respawn dead
runners (ActorError ONLY — a TaskError/env bug or a timeout leaves the
actor alive and must not be silently respawned around), retry up to 3
rounds, fail loudly when nobody samples.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch import exceptions as rex


class RunnerGroup:
    def __init__(self, actor_cls, make_args: Callable[[int], tuple],
                 num_runners: int, seed: int):
        """actor_cls: the @remote runner class; make_args(seed) ->
        constructor args for one runner."""
        self._actor_cls = actor_cls
        self._make_args = make_args
        self._num = num_runners
        self._seed = seed
        self._respawns = 0
        self.runners: List[Any] = [
            actor_cls.remote(*make_args(seed + 1 + i))
            for i in range(num_runners)
        ]

    def respawn(self, i: int) -> None:
        try:
            # a merely-slow runner must not leak
            ray_tpu_torch.kill(self.runners[i])
        except Exception:
            pass
        # fresh seed per respawn: a fixed one would replay the same env
        # stream after every death, biasing the batch
        self._respawns += 1
        self.runners[i] = self._actor_cls.remote(
            *self._make_args(self._seed + 101 + i
                             + 1000 * self._respawns))

    def collect(self, call: Callable[[Any], Any],
                timeout: float = 120.0) -> List[Dict[str, Any]]:
        """call(runner) -> ObjectRef of one sample; returns every
        runner's batch, respawning-and-resampling dead ones."""
        batches: List[Optional[Dict[str, Any]]] = [None] * self._num
        for _attempt in range(3):
            missing = [i for i, b in enumerate(batches) if b is None]
            if not missing:
                break
            refs = {}
            for i in missing:
                try:
                    refs[i] = call(self.runners[i])
                except rex.ActorError:
                    self.respawn(i)
            for i, ref in refs.items():
                try:
                    batches[i] = ray_tpu_torch.get(ref, timeout=timeout)
                except rex.ActorError:
                    self.respawn(i)
        got = [b for b in batches if b is not None]
        if not got:
            raise rex.RayTpuError("all env runners failed")
        return got

    def stop(self) -> None:
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        self.runners = []
