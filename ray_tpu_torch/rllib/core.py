"""rllib core abstractions: RLModule, action distributions, Algorithm.

Counterpart of ``ray_tpu/rllib/core.py`` (reference surface: ray:
rllib/core/rl_module/, rllib/core/learner/, rllib/algorithms/
algorithm.py + algorithm_config.py). The single frame every algorithm
plugs into:

- ``RLModule``: init / apply -> distribution inputs / numpy
  rollout-side sampling / torch learner-side logp+entropy. Two concrete
  modules: ``DiscreteMLP`` (categorical head + value) and
  ``GaussianMLP`` (diagonal-gaussian head + value, continuous control).
- ``AlgorithmConfig``: the shared config root (env, runners, optimizer
  family, connector pipelines, seed, the learner's ``device``) with
  ``build()``.
- ``Algorithm``: env probe, module selection from the env's action
  space, runner group construction, checkpoint save/restore,
  ``train()``/``stop()``.

Parameters are a tree of tensors, ``{"layers": [(w, b), ...]}`` (plus
``"log_std"`` for the gaussian head), not a stateful ``nn.Module``: they
cross ``ray.put`` every round and the optimizers (``optim.py``) update
them functionally. The learner holds them on ``config.device`` (None
means the card, and raises without one); runners get CPU copies and run
their forward in CPU torch on the host.
"""

from __future__ import annotations

import dataclasses
import math
import pickle
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.optim import tree_map

# ----------------------------------------------------------------------
# modules (reference: rllib/core/rl_module/)
# ----------------------------------------------------------------------


def _mlp_init(generator: torch.Generator, sizes, device=None):
    """Weights ``normal * 1/sqrt(fan_in)`` drawn from ``generator`` (a
    CPU generator: the same seed gives the same params on every device),
    zero biases, on ``device`` (None: the card)."""
    from ray_tpu_torch.models.transformer import resolve_device

    device = resolve_device(device, "RLModule.init")
    layers = []
    for m, n in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((m, n), generator=generator) * (1.0 / np.sqrt(m))
        layers.append((w.to(device), torch.zeros(n, device=device)))
    return {"layers": layers}


def _mlp_apply(params, x):
    layers = params["layers"]
    for i, (w, b) in enumerate(layers):
        x = x @ w + b
        if i < len(layers) - 1:
            x = torch.tanh(x)
    return x


def _np_logsumexp(x):
    m = x.max(axis=-1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(axis=-1, keepdims=True))


def params_from_jax(tree, device=None):
    """The reference's parameter tree (jax or numpy arrays in dicts,
    lists and tuples: ``{"layers": [(w, b), ...], "log_std"}``, SAC's
    ``{"pi", "q1", "q2"}``) as the port's: the same structure, each
    array an f32 tensor on ``device`` (None: the card). The RLlib
    counterpart of ``models/transformer.py::params_from_jax``."""
    from ray_tpu_torch.models.transformer import resolve_device

    dev = resolve_device(device, "params_from_jax")
    return tree_map(
        lambda x: torch.tensor(np.asarray(x, np.float32), device=dev),
        tree)


def host_copy(tree):
    """A tree's tensors detached and on the CPU (a CPU tensor is not
    copied): what crosses ``ray.put`` to runners and into checkpoints."""
    return tree_map(lambda t: t.detach().cpu()
                    if isinstance(t, torch.Tensor) else t, tree)


def to_device(tree, device):
    return tree_map(lambda t: t.to(device)
                    if isinstance(t, torch.Tensor) else t, tree)


def as_input(x, device="cpu", dtype=torch.float32) -> torch.Tensor:
    """A numpy batch as a tensor of ``dtype`` on ``device`` (the
    reference's ``jnp.asarray``, which makes f64 input f32)."""
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


class RLModule:
    """One policy abstraction shared by every algorithm.

    Split by where the code runs:
    - ``apply(params, obs)`` — torch; returns the distribution inputs
      tuple (runners call it on CPU tensors, the learner inside its
      loss on its device).
    - ``np_sample(dist, rng)`` — numpy, on the env-runner host: sample
      actions + behavior logp from the distribution inputs.
    - ``logp_entropy(dist, actions)`` — torch, inside the loss:
      per-sample target logp and per-sample entropy.
    - ``value_of(dist)`` — the critic value from the same forward.
    """

    def init(self, generator: torch.Generator, device=None):
        """Params drawn from ``generator`` on ``device`` (None: the card,
        raising without one)."""
        raise NotImplementedError

    def apply(self, params, obs):
        raise NotImplementedError

    def np_sample(self, dist, rng):
        raise NotImplementedError

    def logp_entropy(self, dist, actions):
        raise NotImplementedError

    def kl(self, dist_a, dist_b):
        """Per-sample KL(dist_a || dist_b) from two dist-input tuples
        (value heads ignored) — APPO's adaptive penalty term."""
        raise NotImplementedError

    def value_of(self, dist):
        return dist[-1]


@dataclasses.dataclass(frozen=True)
class DiscreteMLP(RLModule):
    """tanh-MLP -> (logits, value); categorical actions."""

    obs_dim: int
    num_actions: int
    hidden: int = 32

    def init(self, generator, device=None):
        return _mlp_init(generator, [self.obs_dim, self.hidden, self.hidden,
                                     self.num_actions + 1], device)

    def apply(self, params, obs):
        out = _mlp_apply(params, obs)
        return out[..., :-1], out[..., -1]  # logits, value

    def np_sample(self, dist, rng):
        logits = np.asarray(dist[0])
        u = rng.gumbel(size=logits.shape)
        actions = np.argmax(logits + u, axis=-1)
        logp_all = logits - _np_logsumexp(logits)
        logp = np.take_along_axis(
            logp_all, actions[..., None], axis=-1)[..., 0]
        return actions.astype(np.int32), logp.astype(np.float32)

    def logp_entropy(self, dist, actions):
        logp_all = torch.log_softmax(dist[0], dim=-1)
        logp = torch.gather(logp_all, -1,
                            actions.long()[..., None])[..., 0]
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1)
        return logp, entropy

    def kl(self, dist_a, dist_b):
        la = torch.log_softmax(dist_a[0], dim=-1)
        lb = torch.log_softmax(dist_b[0], dim=-1)
        return (torch.exp(la) * (la - lb)).sum(-1)


@dataclasses.dataclass(frozen=True)
class GaussianMLP(RLModule):
    """tanh-MLP -> (mean, log_std, value); diagonal-gaussian actions.

    The log_std is a state-independent learned vector (the reference
    PPO default for continuous control). Sampling returns the RAW
    gaussian action; squashing/clipping to the env's bounds is the
    module-to-env action connector's job, and logp is taken on the raw
    action (standard for clip-style bounds)."""

    obs_dim: int
    action_dim: int
    hidden: int = 32

    def init(self, generator, device=None):
        params = _mlp_init(generator, [self.obs_dim, self.hidden,
                                       self.hidden, self.action_dim + 1],
                           device)
        params["log_std"] = torch.full((self.action_dim,), -0.5,
                                       device=params["layers"][0][1].device)
        return params

    def apply(self, params, obs):
        out = _mlp_apply(params, obs)
        mean = out[..., :self.action_dim]
        value = out[..., -1]
        log_std = params["log_std"].expand(mean.shape)
        return mean, log_std, value

    def np_sample(self, dist, rng):
        mean, log_std = np.asarray(dist[0]), np.asarray(dist[1])
        std = np.exp(log_std)
        noise = rng.standard_normal(mean.shape).astype(np.float32)
        actions = mean + std * noise
        logp = (-0.5 * np.square(noise) - log_std
                - 0.5 * np.log(2 * np.pi)).sum(-1)
        return actions.astype(np.float32), logp.astype(np.float32)

    def logp_entropy(self, dist, actions):
        mean, log_std = dist[0], dist[1]
        z = (actions - mean) / torch.exp(log_std)
        logp = (-0.5 * torch.square(z) - log_std
                - 0.5 * math.log(2 * math.pi)).sum(-1)
        entropy = (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(-1)
        return logp, entropy.expand(logp.shape)

    def kl(self, dist_a, dist_b):
        ma, la = dist_a[0], dist_a[1]
        mb, lb = dist_b[0], dist_b[1]
        va, vb = torch.exp(2 * la), torch.exp(2 * lb)
        return (lb - la
                + (va + torch.square(ma - mb)) / (2 * vb) - 0.5).sum(-1)


def module_for_env(env, hidden: int) -> RLModule:
    """The reference's behavior: infer the action distribution from the
    env's action space — ``num_actions`` -> categorical,
    ``action_dim`` -> diagonal gaussian."""
    if getattr(env, "action_dim", 0):
        return GaussianMLP(env.observation_dim, env.action_dim, hidden)
    return DiscreteMLP(env.observation_dim, env.num_actions, hidden)


# ----------------------------------------------------------------------
# config + algorithm (reference: rllib/algorithms/algorithm.py)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class AlgorithmConfig:
    """Shared config root. Subclasses add algorithm-specific fields and
    set ``algo_class``; ``build()`` is the one construction path."""

    env_maker: Any = None            # seed -> env (default CartPole)
    num_env_runners: int = 2
    num_envs_per_runner: int = 4
    rollout_len: int = 128
    hidden: int = 32
    lr: float = 3e-3
    gamma: float = 0.99
    max_grad_norm: float = 0.5
    # env-to-module connector pipeline (reference: ConnectorV2):
    # observation transforms applied in every runner, with exact
    # parallel-Welford state merging for stateful connectors
    obs_connectors: Any = None
    # module-to-env connector pipeline: action transforms (clip,
    # rescale, squash) applied between the policy sample and env.step
    action_connectors: Any = None
    seed: int = 0
    # the learner's device: None means the card (raises without one);
    # "cpu" runs the learner on the host. Runners always run on the host
    device: Optional[str] = None

    algo_class: Any = dataclasses.field(default=None, repr=False)

    def build(self) -> "Algorithm":
        cls = type(self).algo_class
        if cls is None:
            raise TypeError(
                f"{type(self).__name__} has no algo_class; use a "
                "concrete algorithm config (PPOConfig, DQNConfig, ...)")
        return cls(self)


class Algorithm:
    """Base: env probe, module selection, runner group, checkpoints.

    Subclasses implement ``setup()`` (build the learner state: update
    fn, optimizer, buffers) and ``train()`` (one iteration returning
    the reference's result-dict shape), and may override
    ``_runner_args()`` when their runner actor signature differs.
    """

    #: runner actor class; subclasses override (ppo._EnvRunner etc.)
    runner_cls: Any = None
    #: runners buffer+ship behavior dist inputs only when the learner
    #: reads them (APPO's KL term)
    needs_dist_inputs: bool = False

    def __init__(self, config: AlgorithmConfig):
        from ray_tpu_torch.models.transformer import resolve_device

        self.config = config
        self.device = resolve_device(config.device,
                                     f"{type(self).__name__}'s learner")
        self._env_maker = (config.env_maker
                           if config.env_maker is not None
                           else self._default_env_maker())
        probe = self._env_maker(0)
        self._probe = probe  # reused by setup() overrides
        # multi-agent envs expose per-agent dict variants instead
        self._obs_dim = getattr(probe, "observation_dim", None)
        self._num_actions = getattr(probe, "num_actions", 0)
        self._action_dim = getattr(probe, "action_dim", 0)
        self.module = self._make_module(probe)
        if self.module is not None:
            self.params = self.module.init(
                torch.Generator().manual_seed(config.seed), self.device)
        self.iteration = 0
        self._pipeline = None
        self._connector_state = None
        if getattr(config, "obs_connectors", None):
            from ray_tpu_torch.rllib.connectors import ConnectorPipeline

            self._pipeline = ConnectorPipeline(
                list(config.obs_connectors))
            self._connector_state = self._pipeline.init_state()
        self._action_pipeline = None
        if getattr(config, "action_connectors", None):
            from ray_tpu_torch.rllib.connectors import ActionPipeline

            self._action_pipeline = ActionPipeline(
                list(config.action_connectors))
        # setup() builds learner state BEFORE the runner group exists
        # (multi-policy algorithms derive the runner args there);
        # after_runners() is the post-group hook (async algorithms arm
        # their sampling pipeline there)
        self.setup()
        self._group = None
        if self.runner_cls is not None and config.num_env_runners > 0:
            from ray_tpu_torch.rllib.runner_group import RunnerGroup

            self._group = RunnerGroup(
                self.runner_cls, self._runner_args,
                config.num_env_runners, config.seed)
        self.after_runners()

    # -- hooks ----------------------------------------------------------
    def _default_env_maker(self) -> Callable[[int], Any]:
        from ray_tpu_torch.rllib.env import CartPoleEnv

        return lambda seed: CartPoleEnv(seed)

    def _make_module(self, probe_env) -> Optional[RLModule]:
        return module_for_env(probe_env, self.config.hidden)

    def _runner_args(self, seed: int) -> tuple:
        """Constructor args for one runner actor (reference:
        EnvRunnerGroup's per-worker config)."""
        cfg = self.config
        return (self._env_maker, cfg.num_envs_per_runner,
                cfg.rollout_len, seed, self._pipeline, self.module,
                self._action_pipeline, self.needs_dist_inputs)

    def setup(self) -> None:
        """Build learner state (update fn, optimizer, buffers)."""

    def after_runners(self) -> None:
        """Runs once the runner group exists (async pipelines arm
        their first samples here)."""

    def train(self) -> Dict[str, Any]:
        raise NotImplementedError

    # -- shared plumbing ------------------------------------------------
    @property
    def _runners(self):
        return self._group.runners if self._group is not None else []

    def _input(self, x, dtype=torch.float32) -> torch.Tensor:
        """A host batch as a tensor on the learner's device."""
        return as_input(x, self.device, dtype)

    def _merge_connector_deltas(self, batches: List[Dict]) -> None:
        if self._pipeline is None:
            return
        deltas = [b["connector_state"] for b in batches
                  if "connector_state" in b]
        if deltas:
            # prior + disjoint per-runner deltas: exact parallel-
            # Welford combine, identical to one single stream
            self._connector_state = self._pipeline.merge(
                [self._connector_state] + deltas)

    def stop(self) -> None:
        if self._group is not None:
            self._group.stop()

    # -- checkpointing (reference: Algorithm.save/restore) --------------
    def checkpoint_state(self) -> Dict[str, Any]:
        state = {"iteration": self.iteration,
                 "connector_state": self._connector_state}
        for attr in ("params", "opt_state", "target_params",
                     "kl_coef", "env_steps", "grad_steps"):
            if hasattr(self, attr):
                state[attr] = getattr(self, attr)
        return state

    def restore_state(self, state: Dict[str, Any]) -> None:
        for key, value in state.items():
            if key == "connector_state":
                self._connector_state = value
            else:
                setattr(self, key, to_device(value, self.device))

    def save_checkpoint(self, path: str) -> str:
        # tensors -> host; plain Python scalars (iteration, kl_coef, ...)
        # stay scalars so restored metrics dicts remain JSON-serializable
        with open(path, "wb") as f:
            pickle.dump(host_copy(self.checkpoint_state()), f)
        return path

    def restore_checkpoint(self, path: str) -> None:
        with open(path, "rb") as f:
            self.restore_state(pickle.load(f))
