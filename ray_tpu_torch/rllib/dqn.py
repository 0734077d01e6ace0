"""DQN — the second algorithm family on the env-runner/learner split.

Counterpart of ``ray_tpu/rllib/dqn.py`` (reference: ray:
rllib/algorithms/dqn/ — replay buffer, epsilon-greedy exploration,
target network, double-Q update) on the architecture PPO uses here:
rollouts on CPU env-runner actors (their Q forward in CPU torch), the
update on the learner's device. The replay buffer is a host-side numpy
ring, a copy of the reference's; its minibatches feed the learner.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.core import (Algorithm, AlgorithmConfig, RLModule,
                                      _mlp_apply, _mlp_init, as_input,
                                      host_copy)
from ray_tpu_torch.rllib.optim import adam, clipped, tree_leaves, with_grad


# ----------------------------------------------------------------------
# env runner actor (reference: rllib EnvRunner with epsilon-greedy
# exploration for value-based algorithms)
# ----------------------------------------------------------------------

@ray_tpu_torch.remote
class _DQNRunner:
    def __init__(self, env_maker, num_envs: int, rollout_len: int,
                 seed: int):
        self.envs = [env_maker(seed * 1000 + i) for i in range(num_envs)]
        self.obs = np.stack([e.reset() for e in self.envs])
        self.rollout_len = rollout_len
        self.running = np.zeros(len(self.envs))
        self.rng = np.random.default_rng(seed)

    def sample(self, params, epsilon: float) -> Dict[str, Any]:
        """rollout_len epsilon-greedy steps per env with the given
        params (CPU tensors); returns flat transition arrays +
        completed-episode returns."""
        T, N = self.rollout_len, len(self.envs)
        d = self.envs[0].observation_dim
        na = self.envs[0].num_actions
        obs_buf = np.zeros((T, N, d), np.float32)
        next_buf = np.zeros((T, N, d), np.float32)
        act_buf = np.zeros((T, N), np.int32)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.float32)
        episode_returns: List[float] = []

        for t in range(T):
            with torch.no_grad():
                q = _mlp_apply(params, as_input(self.obs)).numpy()
            greedy = np.argmax(q, axis=-1)
            explore = self.rng.random(N) < epsilon
            actions = np.where(explore,
                               self.rng.integers(0, na, size=N), greedy)
            obs_buf[t] = self.obs
            act_buf[t] = actions
            for i, env in enumerate(self.envs):
                nobs, r, done = env.step(int(actions[i]))
                rew_buf[t, i] = r
                self.running[i] += r
                done_buf[t, i] = 1.0 if done else 0.0
                next_buf[t, i] = nobs
                if done:
                    episode_returns.append(self.running[i])
                    self.running[i] = 0.0
                    nobs = env.reset()
                self.obs[i] = nobs
        return {
            "obs": obs_buf.reshape(-1, d),
            "next_obs": next_buf.reshape(-1, d),
            "actions": act_buf.reshape(-1),
            "rewards": rew_buf.reshape(-1),
            "dones": done_buf.reshape(-1),
            "episode_returns": episode_returns,
        }


# ----------------------------------------------------------------------
# replay buffer (host-side ring; reference:
# rllib/utils/replay_buffers/)
# ----------------------------------------------------------------------

class ReplayBuffer:
    def __init__(self, capacity: int, obs_dim: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros(capacity, np.int32)
        self.rewards = np.zeros(capacity, np.float32)
        self.dones = np.zeros(capacity, np.float32)
        self.size = 0
        self._pos = 0

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(batch["actions"])
        idx = (self._pos + np.arange(n)) % self.capacity
        self.obs[idx] = batch["obs"]
        self.next_obs[idx] = batch["next_obs"]
        self.actions[idx] = batch["actions"]
        self.rewards[idx] = batch["rewards"]
        self.dones[idx] = batch["dones"]
        self._pos = int((self._pos + n) % self.capacity)
        self.size = min(self.size + n, self.capacity)

    def sample(self, rng, batch_size: int) -> Dict[str, np.ndarray]:
        idx = rng.integers(0, self.size, size=batch_size)
        return {"obs": self.obs[idx], "next_obs": self.next_obs[idx],
                "actions": self.actions[idx],
                "rewards": self.rewards[idx], "dones": self.dones[idx]}


# ----------------------------------------------------------------------
# double-DQN update (learner device)
# ----------------------------------------------------------------------

def _make_update(lr: float, gamma: float, max_grad_norm: float):
    optimizer = clipped(max_grad_norm, adam(lr))

    def loss_fn(params, target_params, obs, actions, rewards, next_obs,
                dones):
        q = _mlp_apply(params, obs)
        q_sa = torch.gather(q, -1, actions[:, None])[:, 0]
        # double DQN: online net picks the action, target net scores it
        with torch.no_grad():
            next_q_online = _mlp_apply(params, next_obs)
            next_a = torch.argmax(next_q_online, dim=-1)
            next_q_target = _mlp_apply(target_params, next_obs)
            next_v = torch.gather(next_q_target, -1, next_a[:, None])[:, 0]
            target = rewards + gamma * next_v * (1.0 - dones)
        td = q_sa - target
        return torch.where(torch.abs(td) < 1.0, 0.5 * td * td,
                           torch.abs(td) - 0.5).mean()  # Huber

    def update(params, target_params, opt_state, obs, actions, rewards,
               next_obs, dones):
        """-> (params, opt_state, loss); actions int64. New tensors."""
        params = with_grad(params)
        loss = loss_fn(params, target_params, obs, actions, rewards,
                       next_obs, dones)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        params, opt_state = optimizer.step(params, grads, opt_state)
        return params, opt_state, loss.detach()

    return optimizer, update


# ----------------------------------------------------------------------
# config + algorithm (reference: DQNConfig / Algorithm.train())
# ----------------------------------------------------------------------

class _QModule(RLModule):
    """Q-network as an RLModule (argmax policy; exploration is the
    runner's epsilon-greedy, not a distribution sample): core's MLP with
    a [batch, num_actions] head, where the reference repeats _mlp_init
    and _mlp_apply as _q_init and _q_apply."""

    def __init__(self, obs_dim: int, num_actions: int, hidden: int):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hidden = hidden

    def init(self, generator, device=None):
        return _mlp_init(generator, [self.obs_dim, self.hidden, self.hidden,
                                     self.num_actions], device)

    def apply(self, params, obs):
        return (_mlp_apply(params, obs),)

    def np_sample(self, dist, rng):
        q = np.asarray(dist[0])
        actions = q.argmax(-1).astype(np.int32)
        return actions, np.zeros(actions.shape, np.float32)


@dataclasses.dataclass
class DQNConfig(AlgorithmConfig):
    rollout_len: int = 64
    hidden: int = 64
    lr: float = 1e-3
    buffer_capacity: int = 50_000
    batch_size: int = 128
    updates_per_iteration: int = 32
    learning_starts: int = 500
    target_update_freq: int = 200     # gradient steps between syncs
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_steps: int = 4_000  # env steps to anneal over
    max_grad_norm: float = 10.0


class DQN(Algorithm):
    runner_cls = _DQNRunner

    def _make_module(self, probe_env):
        return _QModule(probe_env.observation_dim,
                        probe_env.num_actions, self.config.hidden)

    def _runner_args(self, seed: int) -> tuple:
        cfg = self.config
        return (self._env_maker, cfg.num_envs_per_runner,
                cfg.rollout_len, seed)

    def setup(self) -> None:
        config = self.config
        if config.obs_connectors or config.action_connectors:
            # the DQN runner's epsilon-greedy path doesn't thread the
            # connector pipelines; silently ignoring the config would
            # train on raw observations while claiming otherwise
            raise NotImplementedError(
                "DQN does not support obs/action connectors yet; "
                "normalize observations in env_maker, or use PPO/"
                "IMPALA/APPO")
        # the update makes new tensors, so sharing them is a copy
        self.target_params = self.params
        self._optimizer, self._update = _make_update(
            config.lr, config.gamma, config.max_grad_norm)
        self.opt_state = self._optimizer.init(self.params)
        self.buffer = ReplayBuffer(config.buffer_capacity, self._obs_dim)
        self.env_steps = 0
        self.grad_steps = 0
        self._rng = np.random.default_rng(config.seed)

    @property
    def epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self.env_steps / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_start + frac * (cfg.epsilon_end
                                           - cfg.epsilon_start)

    def _collect(self) -> List[Dict[str, Any]]:
        """Shared fault-tolerant group (rllib/runner_group.py)."""
        params_ref = ray_tpu_torch.put(host_copy(self.params))
        eps = self.epsilon
        return self._group.collect(
            lambda r: r.sample.remote(params_ref, eps))

    def train(self) -> Dict[str, Any]:
        """One iteration: collect -> replay -> K double-DQN updates."""
        cfg = self.config
        ep_returns: List[float] = []
        for b in self._collect():
            self.buffer.add_batch(b)
            self.env_steps += len(b["actions"])
            ep_returns.extend(b["episode_returns"])

        losses = []
        if self.buffer.size >= max(cfg.learning_starts, cfg.batch_size):
            for _ in range(cfg.updates_per_iteration):
                mb = self.buffer.sample(self._rng, cfg.batch_size)
                self.params, self.opt_state, loss = self._update(
                    self.params, self.target_params, self.opt_state,
                    self._input(mb["obs"]),
                    self._input(mb["actions"], torch.int64),
                    self._input(mb["rewards"]),
                    self._input(mb["next_obs"]),
                    self._input(mb["dones"]))
                losses.append(float(loss))
                self.grad_steps += 1
                if self.grad_steps % cfg.target_update_freq == 0:
                    self.target_params = self.params
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": (float(np.mean(ep_returns))
                                    if ep_returns else float("nan")),
            "num_episodes": len(ep_returns),
            "num_env_steps": int(self.env_steps),
            "epsilon": float(self.epsilon),
            "loss": float(np.mean(losses)) if losses else float("nan"),
        }


DQNConfig.algo_class = DQN
