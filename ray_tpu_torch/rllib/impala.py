"""IMPALA — asynchronous env-runners streaming into a V-trace learner.

Counterpart of ``ray_tpu/rllib/impala.py`` (reference: ray:
rllib/algorithms/impala/, the V-trace off-policy correction of Espeholt
et al. 2018). Semantics kept: runners sample CONTINUOUSLY with whatever
params they last received — the learner consumes completed rollouts as
they arrive (``ray_tpu_torch.wait``, never waiting for a full fan-in)
and hands the freshest params only to the runner it just drained.
Staleness is bounded by the pipeline depth (one outstanding rollout per
runner), and V-trace importance weights correct for it.

APPO (reference: rllib/algorithms/appo/) rides the same chassis with
three additions: PPO's clipped surrogate on the V-trace-corrected
advantages, an ADAPTIVE KL penalty against the behavior distribution
(coefficient raised/lowered toward kl_target once an iteration, rllib's
update_kl schedule), and a TARGET VALUE NETWORK whose estimates compute
the V-trace targets (synced every target_update_freq updates).

The learner runs on ``config.device``: V-trace is a reverse loop over
the rollout's T steps on that device (the reference's reverse
``lax.scan``), with ``detach()`` where the reference stops gradients;
the optimizer is optax's clip_by_global_norm + rmsprop (``optim.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch import exceptions as rex
from ray_tpu_torch.rllib.core import (Algorithm, AlgorithmConfig, DiscreteMLP,
                                      host_copy)
from ray_tpu_torch.rllib.optim import (clipped, rmsprop, tree_leaves,
                                       with_grad)
from ray_tpu_torch.rllib.ppo import _EnvRunner


def _make_update(lr: float, gamma: float, vf_coeff: float,
                 ent_coeff: float, max_grad_norm: float,
                 rho_bar: float, c_bar: float,
                 clip: float = 0.0, use_kl: bool = False,
                 module=None):
    module = module if module is not None else DiscreteMLP(0, 0, 0)
    optimizer = clipped(max_grad_norm, rmsprop(lr, decay=0.99, eps=1e-5))

    def vtrace(behavior_logp, target_logp, values, last_value,
               rewards, dones):
        """V-trace targets + policy-gradient advantages, [T, B] in, as
        one reverse loop over T on the inputs' device."""
        rhos = torch.exp(target_logp - behavior_logp)
        clipped_rho = torch.clamp(rhos, max=rho_bar)
        cs = torch.clamp(rhos, max=c_bar)
        next_values = torch.cat([values[1:], last_value[None]], 0)
        discounts = gamma * (1.0 - dones)
        deltas = clipped_rho * (rewards + discounts * next_values
                                - values)
        acc = torch.zeros_like(last_value)
        dvs = [acc] * len(deltas)
        for t in reversed(range(len(deltas))):
            acc = deltas[t] + discounts[t] * cs[t] * acc
            dvs[t] = acc
        vs = values + torch.stack(dvs)
        vs_next = torch.cat([vs[1:], last_value[None]], 0)
        pg_adv = clipped_rho * (rewards + discounts * vs_next - values)
        return vs, pg_adv

    def loss_fn(params, target_params, kl_coef, obs, actions,
                behavior_logp, behavior_dist, rewards, dones, last_obs):
        dist = module.apply(params, obs)
        values = module.value_of(dist)
        target_logp, entropy = module.logp_entropy(dist, actions)
        # V-trace baseline values: the TARGET network's estimates when
        # one is provided (APPO), else the online net's (IMPALA)
        if target_params is not None:
            tdist = module.apply(target_params, obs)
            base_values = module.value_of(tdist)
            base_last = module.value_of(
                module.apply(target_params, last_obs))
        else:
            base_values = values
            base_last = module.value_of(module.apply(params, last_obs))
        vs, pg_adv = vtrace(behavior_logp, target_logp.detach(),
                            base_values.detach(), base_last.detach(),
                            rewards, dones)
        adv = pg_adv.detach()
        if clip:
            # APPO: PPO's clipped surrogate on the V-trace-corrected
            # advantages
            ratio = torch.exp(target_logp - behavior_logp)
            surr = torch.minimum(
                ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
            pi_loss = -surr.mean()
        else:
            pi_loss = -(adv * target_logp).mean()
        vf_loss = torch.square(values - vs.detach()).mean()
        ent = entropy.mean()
        total = pi_loss + vf_coeff * vf_loss - ent_coeff * ent
        kl = torch.zeros((), device=obs.device)
        if use_kl:
            # adaptive KL penalty against the BEHAVIOR distribution
            # (the params that produced the rollout) — keeps the async
            # update from straying while V-trace's clipping saturates
            kl = module.kl(behavior_dist, dist).mean()
            total = total + kl_coef * kl
        return total, (pi_loss, vf_loss, ent, kl)

    def update(params, target_params, opt_state, kl_coef, obs, actions,
               behavior_logp, behavior_dist, rewards, dones, last_obs):
        """-> (params, opt_state, loss, (pi_loss, vf_loss, entropy,
        kl)); new tensors out."""
        params = with_grad(params)
        loss, aux = loss_fn(params, target_params, kl_coef, obs, actions,
                            behavior_logp, behavior_dist, rewards, dones,
                            last_obs)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        params, opt_state = optimizer.step(params, grads, opt_state)
        return (params, opt_state, loss.detach(),
                tuple(a.detach() for a in aux))

    return optimizer, update


@dataclasses.dataclass
class IMPALAConfig(AlgorithmConfig):
    rollout_len: int = 64
    lr: float = 5e-3
    vf_coeff: float = 0.5
    ent_coeff: float = 0.01
    max_grad_norm: float = 40.0
    rho_bar: float = 1.0             # V-trace rho clip
    c_bar: float = 1.0               # V-trace c clip
    clip: float = 0.0                # >0: clipped surrogate (APPO)
    updates_per_iter: int = 8        # rollouts consumed per train()
    sample_timeout_s: float = 120.0


class IMPALA(Algorithm):
    """Async actor-learner: the learner drains whichever runner
    finishes first, updates, and re-arms ONLY that runner with fresh
    params — the others keep sampling with params at most one pipeline
    slot stale (bounded staleness, corrected by V-trace)."""

    runner_cls = _EnvRunner
    _use_kl = False

    def setup(self) -> None:
        cfg = self.config
        self.target_params = None
        self.kl_coef = float(getattr(cfg, "kl_coef_init", 0.0))
        self._optimizer, self._update = _make_update(
            cfg.lr, cfg.gamma, cfg.vf_coeff, cfg.ent_coeff,
            cfg.max_grad_norm, cfg.rho_bar, cfg.c_bar,
            clip=cfg.clip, use_kl=self._use_kl, module=self.module)
        self.opt_state = self._optimizer.init(self.params)

    def after_runners(self) -> None:
        self._params_ref = ray_tpu_torch.put(host_copy(self.params))
        # prime the pipeline: one outstanding rollout per runner
        self._inflight: Dict[Any, int] = {}
        for i in range(self.config.num_env_runners):
            self._arm(i)

    # -- async plumbing -------------------------------------------------
    def _arm(self, i: int) -> None:
        """One outstanding sample on runner i with the CURRENT params."""
        try:
            ref = self._group.runners[i].sample.remote(
                self._params_ref, self._connector_state)
        except rex.ActorError:
            self._group.respawn(i)
            ref = self._group.runners[i].sample.remote(
                self._params_ref, self._connector_state)
        self._inflight[ref] = i

    def _next_batch(self):
        """The first completed rollout from ANY runner; a dead runner
        respawns and re-arms without stalling the learner."""
        deadline = time.monotonic() + self.config.sample_timeout_s
        while True:
            if not self._inflight:
                raise rex.RayTpuError("no env runners in flight")
            timeout = max(0.1, deadline - time.monotonic())
            ready, _ = ray_tpu_torch.wait(list(self._inflight),
                                          num_returns=1, timeout=timeout)
            if not ready:
                raise rex.RayTpuError(
                    "no rollout arrived within sample_timeout_s")
            ref = ready[0]
            i = self._inflight.pop(ref)
            try:
                return ray_tpu_torch.get(ref), i
            except rex.ActorError:
                self._group.respawn(i)
                self._arm(i)

    def _after_update(self, aux) -> None:
        """Per-update hook (APPO: target network sync)."""

    def _update_kl(self, mean_kl: float) -> None:
        """Per-ITERATION hook (APPO: adaptive KL coefficient).
        Adapting per update whiplashed the coefficient — 8 compounding
        x1.5 steps per iteration drove it to the clamp and collapsed
        the policy; the reference adapts once per training iteration
        on the mean sampled KL."""

    # -- training -------------------------------------------------------
    def _learn(self, batch):
        """One update on a rollout batch: (loss, aux) as tensors."""
        bdist = tuple(self._input(d) for d in batch["dist_inputs"])
        actions = batch["actions"]
        act_dtype = torch.float32 if actions.dtype.kind == "f" \
            else torch.int64
        self.params, self.opt_state, loss, aux = self._update(
            self.params, self.target_params, self.opt_state,
            self.kl_coef, self._input(batch["obs"]),
            self._input(actions, act_dtype), self._input(batch["logp"]),
            bdist, self._input(batch["rewards"]),
            self._input(batch["dones"]), self._input(batch["last_obs"]))
        return loss, aux

    def train(self) -> Dict[str, Any]:
        """One iteration: consume updates_per_iter rollouts as they
        stream in; each consumption re-arms ONLY its producer. Besides
        the reference's keys, ``learner_ms`` is the mean host time of
        one update, its loss read back included."""
        cfg = self.config
        losses: List[float] = []
        kls: List[float] = []
        ep_returns: List[float] = []
        env_steps = 0
        learn_s = 0.0
        t0 = time.perf_counter()
        for _ in range(cfg.updates_per_iter):
            batch, i = self._next_batch()
            self._merge_connector_deltas([batch])
            t1 = time.perf_counter()
            loss, aux = self._learn(batch)
            losses.append(float(loss))
            learn_s += time.perf_counter() - t1
            kls.append(float(aux[3]))
            self._after_update(aux)
            ep_returns.extend(batch["episode_returns"])
            env_steps += batch["actions"].shape[0] \
                * batch["actions"].shape[1]
            # freshest params go to the runner just drained; the rest
            # keep streaming with their (bounded-stale) copy
            self._params_ref = ray_tpu_torch.put(host_copy(self.params))
            self._arm(i)
        dt = time.perf_counter() - t0
        if self._use_kl and kls:
            self._update_kl(float(np.mean(kls)))
        self.iteration += 1
        out = {
            "training_iteration": self.iteration,
            "episode_return_mean": (float(np.mean(ep_returns))
                                    if ep_returns else float("nan")),
            "num_episodes": len(ep_returns),
            "num_env_steps": env_steps,
            "env_steps_per_sec": env_steps / max(dt, 1e-9),
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "learner_ms": learn_s / max(len(losses), 1) * 1e3,
        }
        if self._use_kl:
            out["kl"] = float(np.mean(kls)) if kls else float("nan")
            out["kl_coef"] = self.kl_coef
        return out

    def stop(self) -> None:
        self._inflight.clear()
        super().stop()


@dataclasses.dataclass
class APPOConfig(IMPALAConfig):
    """Async PPO (reference: rllib/algorithms/appo/): the IMPALA
    architecture — async runners, V-trace correction — plus PPO's
    clipped surrogate, an adaptive KL penalty toward kl_target, and a
    target value network for the V-trace baseline."""

    clip: float = 0.2
    kl_target: float = 0.05
    kl_coef_init: float = 0.2
    target_update_freq: int = 4      # updates between target-net syncs


class APPO(IMPALA):
    _use_kl = True
    needs_dist_inputs = True

    def setup(self) -> None:
        self._updates_done = 0
        super().setup()
        # target value network starts as the online params (the update
        # makes new tensors, so sharing them is a copy)
        self.target_params = self.params

    def _update_kl(self, mean_kl: float) -> None:
        # rllib's update_kl schedule, once per iteration on the mean
        # sampled KL: raise above 2x target, lower below 0.5x target
        cfg = self.config
        if mean_kl > 2.0 * cfg.kl_target:
            self.kl_coef = min(self.kl_coef * 1.5, 10.0)
        elif mean_kl < 0.5 * cfg.kl_target:
            self.kl_coef = max(self.kl_coef * 0.5, 1e-4)

    def _after_update(self, aux) -> None:
        cfg = self.config
        self._updates_done += 1
        if self._updates_done % max(1, cfg.target_update_freq) == 0:
            self.target_params = self.params


IMPALAConfig.algo_class = IMPALA
APPOConfig.algo_class = APPO
