"""PPO — env-runner actors + a torch learner on the card.

Counterpart of ``ray_tpu/rllib/ppo.py`` (reference: ray:
rllib/algorithms/ppo/, rllib/env/env_runner_group.py,
rllib/core/learner/). BASELINE config 5's workload through the real
library: rollouts on CPU actors, GAE on the host, the clipped surrogate
+ value + entropy loss, its backward and the optimizer (optax's
clip_by_global_norm + adam, ``optim.py``) on the learner's device.

The runners' forward runs on the host in CPU torch, where the reference
jits it per runner: a runner is a CPU actor stepping Python envs, and
its per-step forward ([envs, obs] x [obs, 32]) is smaller than one
host-to-device round trip. The learner ``ray.put``s a CPU copy of its
params once a round; in process mode the runners see no card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.core import (Algorithm, AlgorithmConfig, DiscreteMLP,
                                      _mlp_apply, _mlp_init, as_input,
                                      host_copy)
from ray_tpu_torch.rllib.optim import adam, clipped, tree_leaves, with_grad

# ----------------------------------------------------------------------
# policy network (MLP: logits + value head) — kept as module-level
# functions for the discrete-only consumers (multi_agent, offline);
# the Algorithm frame goes through RLModule instead (core.py)
# ----------------------------------------------------------------------


def _policy_apply(params, obs):
    x = _mlp_apply(params, obs)
    return x[..., :-1], x[..., -1]


def _policy_init(generator, obs_dim: int, num_actions: int, hidden: int,
                 device=None):
    return _mlp_init(generator, [obs_dim, hidden, hidden, num_actions + 1],
                     device)


# ----------------------------------------------------------------------
# env runner actor (reference: rllib EnvRunner)
# ----------------------------------------------------------------------

@ray_tpu_torch.remote
class _EnvRunner:
    def __init__(self, env_maker, num_envs: int, rollout_len: int,
                 seed: int, connectors=None, module=None,
                 action_connectors=None, need_dist_inputs=False):
        self.envs = [env_maker(seed * 1000 + i) for i in range(num_envs)]
        self.obs = np.stack([e.reset() for e in self.envs])
        # env-to-module connector pipeline (rllib ConnectorV2 analog):
        # observations transform before the module forward AND before
        # buffering, so the learner sees exactly what the policy saw
        self.connectors = connectors
        # module-to-env pipeline: RAW actions (+ logp) are buffered for
        # the learner; TRANSFORMED actions go to env.step
        self.action_connectors = action_connectors
        # the RLModule (core.py): apply -> dist inputs, np_sample.
        # None = legacy discrete-MLP path (module-level _policy_apply)
        self.module = module if module is not None \
            else DiscreteMLP(0, 0, 0)
        # behavior dist inputs are a full obs-buffer-sized extra array
        # per rollout; only KL-penalized learners (APPO) read them
        self.need_dist_inputs = need_dist_inputs
        self.rollout_len = rollout_len
        self.episode_returns: List[float] = []
        self.running = np.zeros(len(self.envs))
        self.rng = np.random.default_rng(seed)

    def _apply(self, params, obs):
        """The module's forward in CPU torch; the dist inputs as numpy."""
        with torch.no_grad():
            dist = self.module.apply(params, as_input(obs))
        return tuple(d.numpy() for d in dist)

    def sample(self, params, connector_state=None) -> Dict[str, Any]:
        """One rollout with the given policy params (CPU tensors): batch
        arrays + completed-episode returns (+ this runner's
        connector-state delta when a pipeline is configured)."""
        apply = self._apply
        pipeline = self.connectors
        prior = connector_state
        delta = None
        if pipeline is not None:
            if prior is None:
                prior = pipeline.init_state()
            delta = pipeline.init_state()
        T, N = self.rollout_len, len(self.envs)
        module = self.module
        act_pipe = self.action_connectors
        # obs/action buffers allocate from the FIRST batch: a connector
        # may change the observation shape, and the module decides the
        # action dtype/shape (int32 [N] categorical, f32 [N, D] gaussian)
        obs_buf = None
        act_buf = None
        dist_buf = None
        logp_buf = np.zeros((T, N), np.float32)
        val_buf = np.zeros((T, N), np.float32)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.float32)
        self.episode_returns = []

        for t in range(T):
            step_obs = self.obs
            if pipeline is not None:
                step_obs, delta = pipeline.observe_and_transform(
                    self.obs, prior, delta)
            if obs_buf is None:
                obs_buf = np.zeros((T,) + np.shape(step_obs), np.float32)
            dist = apply(params, step_obs)
            value = np.asarray(module.value_of(dist))
            actions, logp = module.np_sample(dist, self.rng)
            if act_buf is None:
                act_buf = np.zeros((T,) + actions.shape, actions.dtype)
                # behavior distribution inputs (minus the value head):
                # off-policy learners (APPO's KL term) need the full
                # behavior dist, not just the taken action's logp
                dist_buf = ([np.zeros((T,) + np.shape(d), np.float32)
                             for d in dist[:-1]]
                            if self.need_dist_inputs else [])
            env_actions = actions if act_pipe is None \
                else act_pipe.to_env(actions)
            discrete = act_buf.dtype.kind in "iu"
            obs_buf[t] = step_obs
            act_buf[t] = actions
            if dist_buf:
                for j, d in enumerate(dist[:-1]):
                    dist_buf[j][t] = np.asarray(d)
            logp_buf[t] = logp
            val_buf[t] = value
            for i, env in enumerate(self.envs):
                a = env_actions[i]
                nobs, r, done = env.step(int(a) if discrete else a)
                rew_buf[t, i] = r
                self.running[i] += r
                if done:
                    done_buf[t, i] = 1.0
                    self.episode_returns.append(self.running[i])
                    self.running[i] = 0.0
                    nobs = env.reset()
                self.obs[i] = nobs

        last_obs = self.obs
        if pipeline is not None:
            last_obs = pipeline.transform(
                self.obs, pipeline.effective(prior, delta))
        last_val = module.value_of(apply(params, last_obs))
        out = {
            "obs": obs_buf, "actions": act_buf, "logp": logp_buf,
            "values": val_buf, "rewards": rew_buf, "dones": done_buf,
            "dist_inputs": dist_buf,
            "last_values": np.asarray(last_val, np.float32),
            # the observation AFTER the rollout: off-policy learners
            # (IMPALA) bootstrap it under the TARGET params
            "last_obs": np.copy(last_obs),
            "episode_returns": list(self.episode_returns),
        }
        if pipeline is not None:
            out["connector_state"] = delta  # DELTA only; driver merges
        return out


def _logsumexp(x):
    m = x.max(axis=-1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(axis=-1, keepdims=True))


# ----------------------------------------------------------------------
# GAE (host) + the PPO update (learner device)
# ----------------------------------------------------------------------

def _gae(batch, gamma: float, lam: float):
    rew, val, done = batch["rewards"], batch["values"], batch["dones"]
    T, N = rew.shape
    adv = np.zeros((T, N), np.float32)
    last_adv = np.zeros(N, np.float32)
    next_val = batch["last_values"]
    for t in reversed(range(T)):
        nonterminal = 1.0 - done[t]
        delta = rew[t] + gamma * next_val * nonterminal - val[t]
        last_adv = delta + gamma * lam * nonterminal * last_adv
        adv[t] = last_adv
        next_val = val[t]
    returns = adv + val
    return adv, returns


def _make_update(lr: float, clip: float, vf_coeff: float,
                 ent_coeff: float, max_grad_norm: float,
                 module=None):
    """(optimizer, update): ``update(params, opt_state, obs, actions,
    old_logp, adv, returns) -> (params, opt_state, loss, aux)`` on the
    inputs' device, aux = (pi_loss, vf_loss, entropy, grad_norm), the
    global norm of the gradient before clipping. New tensors out."""
    module = module if module is not None else DiscreteMLP(0, 0, 0)
    optimizer = clipped(max_grad_norm, adam(lr))

    def loss_fn(params, obs, actions, old_logp, adv, returns):
        dist = module.apply(params, obs)
        value = module.value_of(dist)
        logp, entropy = module.logp_entropy(dist, actions)
        ratio = torch.exp(logp - old_logp)
        surr = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        pi_loss = -surr.mean()
        vf_loss = torch.square(value - returns).mean()
        total = pi_loss + vf_coeff * vf_loss - ent_coeff * entropy.mean()
        return total, (pi_loss, vf_loss, entropy.mean())

    def update(params, opt_state, obs, actions, old_logp, adv, returns):
        params = with_grad(params)
        loss, aux = loss_fn(params, obs, actions, old_logp, adv, returns)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        params, opt_state = optimizer.step(params, grads, opt_state)
        # the clip's state: this step's global norm before the clip
        return (params, opt_state, loss.detach(),
                tuple(a.detach() for a in aux) + (opt_state[0],))

    return optimizer, update


# ----------------------------------------------------------------------
# config + algorithm (reference: PPOConfig / Algorithm.train())
# ----------------------------------------------------------------------

@dataclasses.dataclass
class PPOConfig(AlgorithmConfig):
    """reference: rllib/algorithms/ppo/PPOConfig, on the shared
    AlgorithmConfig root (core.py). A continuous-action env (exposing
    ``action_dim`` instead of ``num_actions``) gets a gaussian policy
    head automatically."""

    gae_lambda: float = 0.95
    clip: float = 0.2
    vf_coeff: float = 0.5
    ent_coeff: float = 0.01
    num_epochs: int = 4
    minibatches: int = 4


class PPO(Algorithm):
    runner_cls = None  # set below (class defined above this point)

    def setup(self) -> None:
        cfg = self.config
        self._optimizer, self._update = _make_update(
            cfg.lr, cfg.clip, cfg.vf_coeff, cfg.ent_coeff,
            cfg.max_grad_norm, module=self.module)
        self.opt_state = self._optimizer.init(self.params)

    def _collect(self) -> List[Dict[str, Any]]:
        """Fan a host copy of the current params out, gather rollouts;
        dead runners respawn and re-sample (rllib/runner_group.py).
        Connector-state deltas merge exactly (parallel Welford) and the
        merged state ships with the NEXT round's params."""
        params_ref = ray_tpu_torch.put(host_copy(self.params))
        cstate = self._connector_state
        batches = self._group.collect(
            lambda r: r.sample.remote(params_ref, cstate))
        self._merge_connector_deltas(batches)
        return batches

    def train(self) -> Dict[str, Any]:
        """One iteration: sample -> GAE -> minibatched PPO epochs.
        Besides the reference's keys, ``learner_ms`` is the mean host
        time of one update, its loss read back included."""
        cfg = self.config
        batches = self._collect()
        obs, actions, logp, adv, returns, ep_returns = [], [], [], [], \
            [], []
        for b in batches:
            a, r = _gae(b, cfg.gamma, cfg.gae_lambda)
            obs.append(b["obs"].reshape(-1, b["obs"].shape[-1]))
            actions.append(b["actions"].reshape(
                (-1,) + b["actions"].shape[2:]))
            logp.append(b["logp"].reshape(-1))
            adv.append(a.reshape(-1))
            returns.append(r.reshape(-1))
            ep_returns.extend(b["episode_returns"])
        obs = np.concatenate(obs)
        actions = np.concatenate(actions)
        logp = np.concatenate(logp)
        adv = np.concatenate(adv)
        returns = np.concatenate(returns)
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)

        n = len(obs)
        # the whole batch moves to the learner's device once; the
        # minibatches index it there
        act_dtype = torch.float32 if actions.dtype.kind == "f" \
            else torch.int64
        t_obs, t_act, t_logp, t_adv, t_ret = (
            self._input(obs), self._input(actions, act_dtype),
            self._input(logp), self._input(adv), self._input(returns))
        idx = np.arange(n)
        rng = np.random.default_rng(cfg.seed + self.iteration)
        losses, secs = [], 0.0
        for _ in range(cfg.num_epochs):
            rng.shuffle(idx)
            for mb in np.array_split(idx, cfg.minibatches):
                t0 = time.perf_counter()
                sel = torch.as_tensor(mb, device=self.device)
                self.params, self.opt_state, loss, _aux = self._update(
                    self.params, self.opt_state, t_obs[sel], t_act[sel],
                    t_logp[sel], t_adv[sel], t_ret[sel])
                losses.append(float(loss))
                secs += time.perf_counter() - t0
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": (float(np.mean(ep_returns))
                                    if ep_returns else float("nan")),
            "num_episodes": len(ep_returns),
            "num_env_steps": int(n),
            "loss": float(np.mean(losses)),
            "learner_ms": secs / max(len(losses), 1) * 1e3,
        }


PPO.runner_cls = _EnvRunner
PPOConfig.algo_class = PPO
