"""SAC — soft actor-critic for continuous control.

Counterpart of ``ray_tpu/rllib/sac.py`` (reference: ray:
rllib/algorithms/sac/ — stochastic gaussian policy, twin Q critics with
target networks, entropy-regularized objective with a LEARNED
temperature alpha tuned toward a target entropy). Semantics kept:
off-policy replay, tanh-squashed gaussian actions, clipped-double-Q
targets, polyak-averaged target critics, automatic entropy tuning.

The whole update — both critic losses, the actor loss through the
reparameterized sample, and the alpha loss — runs on the learner's
device. Its two gaussian noise draws come from the learner's
``torch.Generator`` and enter the update as arguments (the reference
draws them with ``jax.random`` inside its jitted step), so one update can
be fed any noise; the replay buffer is a host-side numpy ring.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.core import (Algorithm, AlgorithmConfig, RLModule,
                                      _mlp_apply, _mlp_init, host_copy)
from ray_tpu_torch.rllib.optim import (Optimizer, adam, clipped,
                                       tree_leaves, tree_unflatten,
                                       with_grad)
from ray_tpu_torch.rllib.ppo import _EnvRunner


def _q_apply(params, obs, act):
    return _mlp_apply(params, torch.cat([obs, act], -1))[..., 0]


class _SACModule(RLModule):
    """Tanh-squashed gaussian actor + twin Q critics.

    ``apply`` returns (mean, log_std) of the PRE-squash gaussian; the
    runner samples a = tanh(u) * scale with the change-of-variables
    logp. Critics live in the same param tree under "q1"/"q2"."""

    LOG_STD_MIN, LOG_STD_MAX = -10.0, 2.0

    def __init__(self, obs_dim: int, action_dim: int, hidden: int,
                 action_low: float, action_high: float):
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.hidden = hidden
        # asymmetric bounds: a = center + half * tanh(u)
        self.action_center = (action_high + action_low) / 2.0
        self.action_half = (action_high - action_low) / 2.0

    def init(self, generator, device=None):
        d, a, h = self.obs_dim, self.action_dim, self.hidden
        return {
            "pi": _mlp_init(generator, [d, h, h, 2 * a], device),
            "q1": _mlp_init(generator, [d + a, h, h, 1], device),
            "q2": _mlp_init(generator, [d + a, h, h, 1], device),
        }

    def apply(self, params, obs):
        out = _mlp_apply(params["pi"], obs)
        mean = out[..., :self.action_dim]
        log_std = torch.clamp(out[..., self.action_dim:],
                              self.LOG_STD_MIN, self.LOG_STD_MAX)
        return mean, log_std

    # -- sampling (torch, in the loss; np_sample is its numpy twin) ----
    def squashed_sample(self, dist, noise):
        """a = tanh(mean + std * noise) * scale, with the tanh
        change-of-variables log-prob."""
        mean, log_std = dist
        u = mean + torch.exp(log_std) * noise
        logp_u = (-0.5 * torch.square(noise) - log_std
                  - 0.5 * math.log(2 * math.pi)).sum(-1)
        a = torch.tanh(u)
        # log det of d tanh(u)/du, the numerically stable form
        logp = logp_u - (2 * (math.log(2.0) - u
                              - torch.log1p(torch.exp(-2 * u)))).sum(-1)
        return self.action_center + a * self.action_half, logp

    def np_sample(self, dist, rng):
        # pure numpy (same math as squashed_sample): the rollout hot
        # loop stays on the host
        mean, log_std = np.asarray(dist[0]), np.asarray(dist[1])
        noise = rng.standard_normal(mean.shape).astype(np.float32)
        u = mean + np.exp(log_std) * noise
        logp_u = (-0.5 * np.square(noise) - log_std
                  - 0.5 * np.log(2 * np.pi)).sum(-1)
        logp = logp_u - (2 * (np.log(2.0) - u
                              - np.log1p(np.exp(-2 * u)))).sum(-1)
        a = self.action_center + np.tanh(u) * self.action_half
        return a.astype(np.float32), logp.astype(np.float32)

    def value_of(self, dist):
        # runners buffer a zero value head (SAC is off-policy; the
        # critics live in the learner, not the rollout path)
        return np.zeros(np.shape(dist[0])[:-1], np.float32)


class _SACReplay:
    """Numpy ring of (obs, act, rew, next_obs, done)."""

    def __init__(self, capacity: int, obs_dim: int, act_dim: int):
        self.capacity = capacity
        self.size = 0
        self._i = 0
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.act = np.zeros((capacity, act_dim), np.float32)
        self.rew = np.zeros(capacity, np.float32)
        self.nobs = np.zeros((capacity, obs_dim), np.float32)
        self.done = np.zeros(capacity, np.float32)

    def add_batch(self, batch: Dict[str, np.ndarray],
                  dones_are_truncations: bool = False) -> None:
        obs = batch["obs"].reshape(-1, self.obs.shape[1])
        act = batch["actions"].reshape(-1, self.act.shape[1])
        rew = batch["rewards"].reshape(-1)
        done = batch["dones"].reshape(-1)
        # next-obs within the rollout: shift by one step; the last
        # step of each env bootstraps from last_obs
        nobs = np.concatenate(
            [batch["obs"][1:], batch["last_obs"][None]], 0
        ).reshape(-1, self.obs.shape[1])
        if dones_are_truncations:
            # time-limit-only envs (Pendulum): masking the bootstrap at
            # the limit biases Q with a false value cliff. Boundary
            # transitions pair s_T with the NEXT episode's reset obs —
            # drop those rows and bootstrap through everything else.
            keep = np.flatnonzero(done <= 0.5)
            obs, act, rew, nobs = (obs[keep], act[keep], rew[keep],
                                   nobs[keep])
            done = np.zeros(len(keep), np.float32)
        # vectorized ring insert (the DQN buffer's pattern)
        k = len(obs)
        if not k:
            return
        idx = (self._i + np.arange(k)) % self.capacity
        self.obs[idx] = obs
        self.act[idx] = act
        self.rew[idx] = rew
        self.nobs[idx] = nobs
        self.done[idx] = done
        self._i = int((self._i + k) % self.capacity)
        self.size = min(self.size + k, self.capacity)

    def sample(self, rng, n: int) -> Dict[str, np.ndarray]:
        idx = rng.integers(0, self.size, n)
        return {"obs": self.obs[idx], "act": self.act[idx],
                "rew": self.rew[idx], "nobs": self.nobs[idx],
                "done": self.done[idx]}


def _make_update(module: _SACModule, lr: float, gamma: float,
                 tau: float, target_entropy: float,
                 max_grad_norm: float = 0.0):
    """(optimizers, update): ``update(params, target_q, log_alpha,
    opt_states, noise_next, noise_pi, batch)`` -> (params, target_q,
    log_alpha, opt_states, (q_loss, pi_loss, entropy)). ``noise_next``
    and ``noise_pi`` are standard normals of the actions' shape
    [batch, action_dim]: the critic target's next-action sample and the
    actor's reparameterized sample. New tensors out."""
    def _opt():
        if max_grad_norm > 0:
            return clipped(max_grad_norm, adam(lr))
        return Optimizer(adam(lr))

    pi_opt = _opt()
    q_opt = _opt()
    a_opt = Optimizer(adam(lr))  # a scalar needs no norm clip

    def update(params, target_q, log_alpha, opt_states, noise_next,
               noise_pi, batch):
        obs, act, rew = batch["obs"], batch["act"], batch["rew"]
        nobs, done = batch["nobs"], batch["done"]
        alpha = torch.exp(log_alpha)

        # -- critic target: clipped double-Q on the next action -------
        with torch.no_grad():
            ndist = module.apply(params, nobs)
            na, nlogp = module.squashed_sample(ndist, noise_next)
            tq = torch.minimum(_q_apply(target_q["q1"], nobs, na),
                               _q_apply(target_q["q2"], nobs, na))
            y = rew + gamma * (1.0 - done) * (tq - alpha * nlogp)

        qparams = with_grad({"q1": params["q1"], "q2": params["q2"]})
        q1 = _q_apply(qparams["q1"], obs, act)
        q2 = _q_apply(qparams["q2"], obs, act)
        q_loss = (torch.square(q1 - y) + torch.square(q2 - y)).mean()
        q_grads = torch.autograd.grad(q_loss, tree_leaves(qparams))
        qparams, q_state = q_opt.step(qparams, q_grads, opt_states["q"])
        params = dict(params, q1=qparams["q1"], q2=qparams["q2"])

        # -- actor: maximize min-Q of the reparameterized sample ------
        pp = with_grad(params["pi"])
        dist = module.apply({"pi": pp}, obs)
        a, logp = module.squashed_sample(dist, noise_pi)
        q = torch.minimum(_q_apply(params["q1"], obs, a),
                          _q_apply(params["q2"], obs, a))
        pi_loss = (alpha * logp - q).mean()
        pi_grads = torch.autograd.grad(pi_loss, tree_leaves(pp))
        new_pi, pi_state = pi_opt.step(pp, pi_grads, opt_states["pi"])
        params = dict(params, pi=new_pi)
        logp = logp.detach()

        # -- temperature: tune toward the target entropy --------------
        la = log_alpha.detach().requires_grad_(True)
        a_loss = -(torch.exp(la) * (logp + target_entropy)).mean()
        (a_grad,) = torch.autograd.grad(a_loss, [la])
        log_alpha, a_state = a_opt.step(la, [a_grad], opt_states["alpha"])

        # -- polyak target sync ---------------------------------------
        with torch.no_grad():
            target_q = {k: _polyak(target_q[k], qparams[k], tau)
                        for k in ("q1", "q2")}
        return (params, target_q, log_alpha,
                {"q": q_state, "pi": pi_state, "alpha": a_state},
                (q_loss.detach(), pi_loss.detach(), -logp.mean()))

    return {"pi": pi_opt, "q": q_opt, "alpha": a_opt}, update


def _polyak(target, online, tau: float):
    """(1 - tau) * target + tau * online, leaf by leaf."""
    return tree_unflatten(target, [
        (1.0 - tau) * t + tau * o.detach()
        for t, o in zip(tree_leaves(target), tree_leaves(online))])


@dataclasses.dataclass
class SACConfig(AlgorithmConfig):
    rollout_len: int = 64
    hidden: int = 64
    lr: float = 3e-4
    tau: float = 0.005               # polyak rate
    buffer_capacity: int = 100_000
    batch_size: int = 256
    # keep the update-to-data ratio near SAC's canonical 1:1 — at the
    # old default (1:16) Pendulum never learned; 256 updates per
    # 512-step collect solved it (-1622 -> -218 in 40 iterations)
    updates_per_iteration: int = 256
    learning_starts: int = 1_000
    target_entropy: float = 0.0      # 0 = -action_dim (the default)
    max_grad_norm: float = 0.0       # 0 = unclipped (SAC's default;
    #                                  the calibrated Pendulum run)


class SAC(Algorithm):
    runner_cls = _EnvRunner

    def _make_module(self, probe_env):
        if not getattr(probe_env, "action_dim", 0):
            raise ValueError(
                "SAC is continuous-control only: the env must expose "
                "action_dim/action_low/action_high")
        return _SACModule(probe_env.observation_dim,
                          probe_env.action_dim, self.config.hidden,
                          float(getattr(probe_env, "action_low", -1.0)),
                          float(getattr(probe_env, "action_high", 1.0)))

    def setup(self) -> None:
        cfg = self.config
        te = (cfg.target_entropy
              if cfg.target_entropy else -float(self._action_dim))
        self._optimizers, self._update = _make_update(
            self.module, cfg.lr, cfg.gamma, cfg.tau, te,
            max_grad_norm=cfg.max_grad_norm)
        # the update makes new tensors, so sharing them is a copy
        self.target_params = {"q1": self.params["q1"],
                              "q2": self.params["q2"]}
        self.log_alpha = torch.zeros((), device=self.device)
        self._opt_states = {
            "pi": self._optimizers["pi"].init(self.params["pi"]),
            "q": self._optimizers["q"].init(
                {"q1": self.params["q1"], "q2": self.params["q2"]}),
            "alpha": self._optimizers["alpha"].init(self.log_alpha),
        }
        # the update's noise (the reference's PRNGKey(seed + 17))
        self._gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 17)
        self.buffer = _SACReplay(cfg.buffer_capacity, self._obs_dim,
                                 self._action_dim)
        self._truncation_dones = bool(
            getattr(self._probe, "dones_are_truncations", False))
        self.env_steps = 0
        self._np_rng = np.random.default_rng(cfg.seed)

    def checkpoint_state(self) -> Dict[str, Any]:
        # the frame's whitelist misses SAC's extra learner state
        state = super().checkpoint_state()
        state["log_alpha"] = self.log_alpha
        state["_opt_states"] = self._opt_states
        state["_rng_state"] = self._gen.get_state()
        return state

    def restore_state(self, state: Dict[str, Any]) -> None:
        state = dict(state)
        rng_state = state.pop("_rng_state", None)
        super().restore_state(state)
        if rng_state is not None:
            self._gen.set_state(rng_state.cpu())

    def _noise(self, n: int) -> torch.Tensor:
        return torch.randn((n, self._action_dim), generator=self._gen,
                           device=self.device)

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        params_ref = ray_tpu_torch.put(host_copy(self.params))
        batches = self._group.collect(
            lambda r: r.sample.remote(params_ref,
                                      self._connector_state))
        self._merge_connector_deltas(batches)
        ep_returns: List[float] = []
        for b in batches:
            self.buffer.add_batch(b, self._truncation_dones)
            self.env_steps += b["rewards"].size
            ep_returns.extend(b["episode_returns"])

        q_losses: List[float] = []
        entropy = float("nan")
        if self.buffer.size >= max(cfg.learning_starts,
                                   cfg.batch_size):
            for _ in range(cfg.updates_per_iteration):
                mb = self.buffer.sample(self._np_rng, cfg.batch_size)
                noise_next = self._noise(cfg.batch_size)
                noise_pi = self._noise(cfg.batch_size)
                (self.params, self.target_params, self.log_alpha,
                 self._opt_states, aux) = self._update(
                    self.params, self.target_params, self.log_alpha,
                    self._opt_states, noise_next, noise_pi,
                    {k: self._input(v) for k, v in mb.items()})
                q_losses.append(float(aux[0]))
                entropy = float(aux[2])
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": (float(np.mean(ep_returns))
                                    if ep_returns else float("nan")),
            "num_episodes": len(ep_returns),
            "num_env_steps": int(self.env_steps),
            "alpha": float(np.exp(float(self.log_alpha))),
            "entropy": entropy,
            "q_loss": (float(np.mean(q_losses))
                       if q_losses else float("nan")),
        }


SACConfig.algo_class = SAC
