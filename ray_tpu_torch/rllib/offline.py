"""Offline RL: episode datasets + behavior cloning.

Counterpart of ``ray_tpu/rllib/offline.py`` (reference surface: rllib's
offline stack, ray: rllib/offline/ — dataset readers/writers feeding
offline algorithms like BC/CQL/MARWIL through ray.data). Transitions
live in a ``ray_tpu_torch.data`` Dataset (recording, shuffling and
ingestion ride the port's data plane), and the BC learner is one
negative-log-likelihood update, on the learner's device, of the same
policy network the online algorithms use.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch.rllib.core import Algorithm, AlgorithmConfig, as_input
from ray_tpu_torch.rllib.optim import Optimizer, adam, tree_leaves, with_grad
from ray_tpu_torch.rllib.ppo import _policy_apply


def collect_episodes(env_maker, policy_fn, num_episodes: int,
                     seed: int = 0):
    """Roll ``policy_fn(obs) -> action`` in the env and return a
    ray_tpu_torch.data Dataset of transition rows {obs, action, reward,
    done} (reference: rllib output writers producing SampleBatch
    datasets)."""
    from ray_tpu_torch import data

    rows: List[Dict[str, Any]] = []
    for ep in range(num_episodes):
        env = env_maker(seed + ep)
        obs = env.reset()
        done = False
        while not done:
            action = int(policy_fn(obs))
            nobs, reward, done = env.step(action)
            rows.append({"obs": [float(x) for x in obs],
                         "action": action,
                         "reward": float(reward),
                         "done": bool(done)})
            obs = nobs
    return data.from_items(rows, parallelism=max(1, num_episodes // 4))


@dataclasses.dataclass
class BCConfig(AlgorithmConfig):
    """Behavior cloning from a transition dataset (reference:
    rllib/algorithms/bc/). On the shared AlgorithmConfig root — no env
    runners (the data IS the experience), so num_env_runners=0."""

    dataset: Any = None              # ray_tpu_torch.data Dataset of rows
    lr: float = 1e-2
    batch_size: int = 256
    num_env_runners: int = 0


def _make_update(lr: float):
    """(optimizer, update): ``update(params, opt_state, obs, actions)``
    -> (params, opt_state, loss), the mean NLL of the actions; actions
    int64. New tensors out."""
    optimizer = Optimizer(adam(lr))

    def update(params, opt_state, obs, actions):
        params = with_grad(params)
        logits, _v = _policy_apply(params, obs)
        logp = torch.log_softmax(logits, dim=-1)
        loss = -torch.gather(logp, -1, actions[:, None])[:, 0].mean()
        grads = torch.autograd.grad(loss, tree_leaves(params))
        params, opt_state = optimizer.step(params, grads, opt_state)
        return params, opt_state, loss.detach()

    return optimizer, update


class BC(Algorithm):
    """Supervised imitation: maximize log pi(action | obs) over the
    dataset. The policy module is the SAME DiscreteMLP the online
    algorithms train, so a cloned policy drops into their evaluation
    path."""

    def setup(self) -> None:
        config = self.config
        if config.dataset is None:
            raise ValueError("BCConfig.dataset is required")
        optimizer, self._update = _make_update(config.lr)
        self.opt_state = optimizer.init(self.params)
        # materialize ONCE into arrays; epochs reshuffle indices
        rows = config.dataset.take_all()
        self._obs = np.asarray([r["obs"] for r in rows], np.float32)
        self._actions = np.asarray([r["action"] for r in rows], np.int32)
        self._rng = np.random.default_rng(config.seed)

    def train(self) -> Dict[str, Any]:
        """One epoch over the dataset in shuffled minibatches."""
        n = len(self._obs)
        idx = self._rng.permutation(n)
        bs = self.config.batch_size
        losses = []
        for i in range(0, n, bs):
            mb = idx[i:i + bs]
            self.params, self.opt_state, loss = self._update(
                self.params, self.opt_state, self._input(self._obs[mb]),
                self._input(self._actions[mb], torch.int64))
            losses.append(float(loss))
        self.iteration += 1
        return {"training_iteration": self.iteration,
                "num_samples": n,
                "loss": float(np.mean(losses))}

    def evaluate(self, num_episodes: int = 10,
                 seed: int = 10_000) -> Dict[str, Any]:
        """Greedy rollouts of the cloned policy (its forward on the
        learner's device)."""
        returns = []
        for ep in range(num_episodes):
            env = self._env_maker(seed + ep)
            obs = env.reset()
            done = False
            total = 0.0
            while not done:
                with torch.no_grad():
                    logits, _v = _policy_apply(
                        self.params, as_input(obs, self.device))
                obs, r, done = env.step(int(torch.argmax(logits)))
                total += r
            returns.append(total)
        return {"episode_return_mean": float(np.mean(returns)),
                "num_episodes": num_episodes}


BCConfig.algo_class = BC
