"""Multi-agent RL: MultiAgentEnv + per-policy PPO learners.

Counterpart of ``ray_tpu/rllib/multi_agent.py`` (reference surface:
rllib's multi-agent stack, ray: rllib/env/multi_agent_env.py
MultiAgentEnv; the policies= / policy_mapping_fn= config of
AlgorithmConfig.multi_agent()). Semantics kept: an env step consumes a
dict of per-agent actions and yields per-agent
observations/rewards/dones; agents map to named POLICIES (many agents
may share one — parameter sharing), and each policy trains on exactly
the transitions its agents produced.

Per step, agents are GROUPED BY POLICY and each policy's forward runs
as one batched CPU-torch apply over its agents x envs in the runner —
not a Python loop over agents; each policy's update is the PPO update
of ``ppo.py`` on the learner's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.core import (Algorithm, AlgorithmConfig, as_input,
                                      host_copy)
from ray_tpu_torch.rllib.ppo import (_gae, _logsumexp, _make_update,
                                     _policy_apply, _policy_init)


class MultiAgentEnv:
    """Protocol (reference: rllib MultiAgentEnv):

    reset() -> {agent_id: obs}
    step({agent_id: action}) -> (obs_dict, reward_dict, done_dict)
      where done_dict carries per-agent dones plus "__all__".
    Attrs: agent_ids (list), observation_dims / num_actions (dicts
    keyed by agent id).

    SCOPE: the runner assumes a FIXED agent set for the whole episode
    — every agent appears in every step's dicts until "__all__"
    (agents that "finish early" must keep emitting terminal obs with
    done[agent]=True). Dynamic agent entry/exit (the reference's
    omit-finished-agents convention) is not supported.
    """

    agent_ids: List[str] = []

    def reset(self) -> Dict[str, Any]:
        raise NotImplementedError

    def step(self, actions: Dict[str, int]):
        raise NotImplementedError


class IndependentCartPoles(MultiAgentEnv):
    """Two agents, each balancing its OWN CartPole — the minimal
    multi-agent testbed: per-agent rewards, a shared episode boundary
    ("__all__" when either pole falls), and agents that can share or
    split policies."""

    agent_ids = ["a0", "a1"]

    def __init__(self, seed: int = 0):
        from ray_tpu_torch.rllib.env import CartPoleEnv

        self._envs = {"a0": CartPoleEnv(seed * 2 + 1),
                      "a1": CartPoleEnv(seed * 2 + 2)}
        self.observation_dims = {a: 4 for a in self.agent_ids}
        self.num_actions = {a: 2 for a in self.agent_ids}

    def reset(self) -> Dict[str, Any]:
        return {a: e.reset() for a, e in self._envs.items()}

    def step(self, actions: Dict[str, int]):
        obs, rew, done = {}, {}, {}
        any_done = False
        for a, env in self._envs.items():
            o, r, d = env.step(int(actions[a]))
            obs[a], rew[a], done[a] = o, r, d
            any_done = any_done or d
        done["__all__"] = any_done
        return obs, rew, done


class TwoStepGame(MultiAgentEnv):
    """The COUPLED cooperative matrix game of the QMIX paper
    (reference: rllib's TwoStepGame example env, examples/envs/classes/
    two_step_game.py): two agents, shared reward, and a payoff that
    depends on the JOINT action — unlike IndependentCartPoles, no
    agent can learn its part in isolation.

    Step 1: agent a0's action picks the branch (0 -> state 2A,
    1 -> state 2B); a1's action is ignored. Step 2: in 2A every joint
    action pays 7; in 2B the payoff matrix is [[0, 1], [1, 8]] — the
    optimum 8 requires BOTH agents to coordinate on action 1, and the
    safe branch caps at 7. Observations: one-hot state + agent id.
    """

    agent_ids = ["a0", "a1"]
    PAYOFF_2B = ((0.0, 1.0), (1.0, 8.0))

    def __init__(self, seed: int = 0):
        self.observation_dims = {a: 4 for a in self.agent_ids}
        self.num_actions = {a: 2 for a in self.agent_ids}
        self._state = 0

    def _obs(self):
        out = {}
        for i, a in enumerate(self.agent_ids):
            v = np.zeros(4, np.float32)
            v[self._state] = 1.0
            v[3] = float(i)
            out[a] = v
        return out

    def reset(self):
        self._state = 0
        return self._obs()

    def step(self, actions):
        if self._state == 0:
            self._state = 1 if int(actions["a0"]) == 0 else 2
            obs = self._obs()
            return obs, {a: 0.0 for a in self.agent_ids}, \
                {"a0": False, "a1": False, "__all__": False}
        if self._state == 1:
            r = 7.0
        else:
            r = self.PAYOFF_2B[int(actions["a0"])][int(actions["a1"])]
        self._state = 0
        obs = self._obs()
        return obs, {a: r for a in self.agent_ids}, \
            {"a0": True, "a1": True, "__all__": True}


@ray_tpu_torch.remote
class _MultiAgentRunner:
    """Vector of multi-agent envs; one rollout batches each POLICY's
    forward across (its agents x envs) in a single CPU-torch apply."""

    def __init__(self, env_maker, num_envs: int, rollout_len: int,
                 policy_of: Dict[str, str], seed: int):
        self.envs = [env_maker(seed * 1000 + i) for i in range(num_envs)]
        self.agent_ids = list(self.envs[0].agent_ids)
        self.policy_of = dict(policy_of)
        self.rollout_len = rollout_len
        self.obs = [e.reset() for e in self.envs]
        self.rng = np.random.default_rng(seed)
        self.running = {a: np.zeros(num_envs) for a in self.agent_ids}

    def sample(self, params_by_policy: Dict[str, Any]) -> Dict[str, Any]:
        """One rollout; returns per-POLICY batches shaped like the
        single-agent runner's ({obs, actions, logp, values, rewards,
        dones, last_values, episode_returns}); params are CPU tensors."""
        T, N = self.rollout_len, len(self.envs)
        agents = self.agent_ids
        by_policy: Dict[str, List[str]] = {}
        for a in agents:
            by_policy.setdefault(self.policy_of[a], []).append(a)
        obs_dim = {a: self.envs[0].observation_dims[a] for a in agents}
        buf = {a: {"obs": np.zeros((T, N, obs_dim[a]), np.float32),
                   "actions": np.zeros((T, N), np.int32),
                   "logp": np.zeros((T, N), np.float32),
                   "values": np.zeros((T, N), np.float32),
                   "rewards": np.zeros((T, N), np.float32),
                   "dones": np.zeros((T, N), np.float32)}
               for a in agents}
        episode_returns: Dict[str, List[float]] = {a: [] for a in agents}

        def policy_forward(pid, obs_stack):
            # [n_agents*N, obs] through ONE apply
            with torch.no_grad():
                logits, values = _policy_apply(params_by_policy[pid],
                                               as_input(obs_stack))
            return logits.numpy(), values.numpy()

        for t in range(T):
            actions: List[Dict[str, int]] = [dict() for _ in range(N)]
            for pid, pagents in by_policy.items():
                stack = np.concatenate(
                    [np.stack([self.obs[i][a] for i in range(N)])
                     for a in pagents])  # [len(pagents)*N, obs]
                logits, values = policy_forward(pid, stack)
                u = self.rng.gumbel(size=logits.shape)
                acts = np.argmax(logits + u, axis=-1)
                logp_all = logits - _logsumexp(logits)
                for j, a in enumerate(pagents):
                    sl = slice(j * N, (j + 1) * N)
                    buf[a]["obs"][t] = stack[sl]
                    buf[a]["actions"][t] = acts[sl]
                    buf[a]["logp"][t] = logp_all[sl][np.arange(N),
                                                     acts[sl]]
                    buf[a]["values"][t] = values[sl]
                    for i in range(N):
                        actions[i][a] = int(acts[sl][i])
            for i, env in enumerate(self.envs):
                obs, rew, done = env.step(actions[i])
                for a in agents:
                    buf[a]["rewards"][t, i] = rew[a]
                    self.running[a][i] += rew[a]
                    # per-AGENT done cuts that agent's bootstrapping
                    # even before "__all__" ends the episode
                    buf[a]["dones"][t, i] = (
                        1.0 if (done.get(a) or done["__all__"]) else 0.0)
                if done["__all__"]:
                    for a in agents:
                        episode_returns[a].append(self.running[a][i])
                        self.running[a][i] = 0.0
                    obs = env.reset()
                self.obs[i] = obs

        out: Dict[str, Any] = {}
        for pid, pagents in by_policy.items():
            stack = np.concatenate(
                [np.stack([self.obs[i][a] for i in range(N)])
                 for a in pagents])
            _, last_vals = policy_forward(pid, stack)
            # concatenate agents along the ENV axis: the learner sees
            # one [T, n_agents*N] batch per policy
            out[pid] = {
                k: np.concatenate([buf[a][k] for a in pagents], axis=1)
                for k in ("obs", "actions", "logp", "values",
                          "rewards", "dones")}
            out[pid]["last_values"] = last_vals
            out[pid]["episode_returns"] = [
                r for a in pagents for r in episode_returns[a]]
        return out


@dataclasses.dataclass
class MultiAgentPPOConfig(AlgorithmConfig):
    """reference: AlgorithmConfig.multi_agent(policies=...,
    policy_mapping_fn=...), on the shared AlgorithmConfig root.
    policies maps policy id -> (obs_dim, num_actions);
    policy_mapping_fn maps agent id -> policy id (default: one shared
    policy for every agent)."""

    policies: Optional[Dict[str, tuple]] = None
    policy_mapping_fn: Optional[Callable[[str], str]] = None
    gae_lambda: float = 0.95
    clip: float = 0.2
    vf_coeff: float = 0.5
    ent_coeff: float = 0.01
    num_epochs: int = 4
    minibatches: int = 4


class MultiAgentPPO(Algorithm):
    runner_cls = _MultiAgentRunner

    def _make_module(self, probe_env):
        return None  # per-POLICY param dicts below, not one module

    def _runner_args(self, seed: int) -> tuple:
        cfg = self.config
        return (self._env_maker, cfg.num_envs_per_runner,
                cfg.rollout_len, self._policy_of, seed)

    def _default_env_maker(self):
        return lambda seed: IndependentCartPoles(seed)

    def setup(self) -> None:
        config = self.config
        if config.obs_connectors or config.action_connectors:
            # the multi-agent runner doesn't thread the connector
            # pipelines; reject loudly rather than silently no-op
            raise NotImplementedError(
                "MultiAgentPPO does not support obs/action connectors "
                "yet; transform observations in the env")
        probe = self._probe  # the base's probe env, not a second one
        mapping = config.policy_mapping_fn or (lambda aid: "shared")
        self._policy_of = {a: mapping(a) for a in probe.agent_ids}
        if config.policies is not None:
            policies = dict(config.policies)
        else:
            policies = {}
            for a in probe.agent_ids:
                policies[self._policy_of[a]] = (
                    probe.observation_dims[a], probe.num_actions[a])
        unknown = set(self._policy_of.values()) - set(policies)
        if unknown:
            raise ValueError(
                f"policy_mapping_fn produced undeclared policies: "
                f"{sorted(unknown)}")
        self.params: Dict[str, Any] = {}
        self.opt_state: Dict[str, Any] = {}
        self._update: Dict[str, Any] = {}
        for k, (obs_dim, n_act) in policies.items():
            import zlib

            # stable per-policy seed: hash() is salted per process
            # (config.seed would silently not reproduce runs)
            self.params[k] = _policy_init(
                torch.Generator().manual_seed(
                    config.seed + zlib.crc32(k.encode()) % 100_000),
                obs_dim, n_act, config.hidden, self.device)
            opt, upd = _make_update(config.lr, config.clip,
                                    config.vf_coeff, config.ent_coeff,
                                    config.max_grad_norm)
            self.opt_state[k] = opt.init(self.params[k])
            self._update[k] = upd

    def train(self) -> Dict[str, Any]:
        """One iteration: collect, then per-policy PPO epochs over the
        transitions that policy's agents produced."""
        cfg = self.config
        params_ref = ray_tpu_torch.put(host_copy(dict(self.params)))
        batches = self._group.collect(
            lambda r: r.sample.remote(params_ref))
        metrics: Dict[str, Any] = {"training_iteration": None}
        ep_returns: List[float] = []
        total_steps = 0
        for pid in self.params:
            per = [b[pid] for b in batches if pid in b]
            if not per:
                continue
            obs, actions, logp, adv, returns = [], [], [], [], []
            for b in per:
                a, r = _gae(b, cfg.gamma, cfg.gae_lambda)
                obs.append(b["obs"].reshape(-1, b["obs"].shape[-1]))
                actions.append(b["actions"].reshape(-1))
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
            total_steps += len(obs)
            t_obs, t_act, t_logp, t_adv, t_ret = (
                self._input(obs), self._input(actions, torch.int64),
                self._input(logp), self._input(adv), self._input(returns))
            idx = np.arange(len(obs))
            rng = np.random.default_rng(cfg.seed + self.iteration)
            losses = []
            for _ in range(cfg.num_epochs):
                rng.shuffle(idx)
                for mb in np.array_split(idx, cfg.minibatches):
                    sel = torch.as_tensor(mb, device=self.device)
                    (self.params[pid], self.opt_state[pid], loss,
                     _aux) = self._update[pid](
                        self.params[pid], self.opt_state[pid],
                        t_obs[sel], t_act[sel], t_logp[sel], t_adv[sel],
                        t_ret[sel])
                    losses.append(float(loss))
            metrics[f"loss_{pid}"] = float(np.mean(losses))
        self.iteration += 1
        metrics.update({
            "training_iteration": self.iteration,
            # AGENT-episodes: one entry per agent per env episode (the
            # mean blends per-agent returns; divide num_episodes by the
            # agent count for env-episode counts on symmetric envs)
            "episode_return_mean": (float(np.mean(ep_returns))
                                    if ep_returns else float("nan")),
            "num_episodes": len(ep_returns),
            "num_env_steps": total_steps,
        })
        return metrics


MultiAgentPPOConfig.algo_class = MultiAgentPPO
