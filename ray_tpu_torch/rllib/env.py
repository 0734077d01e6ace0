"""Built-in environments (no gym dependency).

The port's own copy of ``ray_tpu/rllib/env.py`` (numpy only): the same
seed gives the same rollout as the reference's, bit for bit.

CartPole uses the standard published dynamics (Barto, Sutton & Anderson
1983; the classic control formulation): pole on a cart, +1 reward per
step, terminate at |x| > 2.4 or |theta| > 12 degrees or 500 steps.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class CartPoleEnv:
    """Vector-friendly single env; reset() -> obs[4], step(a) ->
    (obs, reward, done)."""

    GRAVITY = 9.8
    MASSCART = 1.0
    MASSPOLE = 0.1
    LENGTH = 0.5          # half pole length
    FORCE_MAG = 10.0
    TAU = 0.02
    X_LIMIT = 2.4
    THETA_LIMIT = 12 * np.pi / 180
    MAX_STEPS = 500

    observation_dim = 4
    num_actions = 2

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._state = None
        self._t = 0

    def reset(self) -> np.ndarray:
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._t = 0
        return self._state.astype(np.float32)

    def step(self, action: int) -> Tuple[np.ndarray, float, bool]:
        x, x_dot, theta, theta_dot = self._state
        force = self.FORCE_MAG if action == 1 else -self.FORCE_MAG
        costh, sinth = np.cos(theta), np.sin(theta)
        total_mass = self.MASSCART + self.MASSPOLE
        polemass_length = self.MASSPOLE * self.LENGTH

        temp = (force + polemass_length * theta_dot ** 2 * sinth) \
            / total_mass
        theta_acc = (self.GRAVITY * sinth - costh * temp) / (
            self.LENGTH * (4.0 / 3.0
                           - self.MASSPOLE * costh ** 2 / total_mass))
        x_acc = temp - polemass_length * theta_acc * costh / total_mass

        x += self.TAU * x_dot
        x_dot += self.TAU * x_acc
        theta += self.TAU * theta_dot
        theta_dot += self.TAU * theta_acc
        self._state = np.array([x, x_dot, theta, theta_dot])
        self._t += 1

        done = bool(abs(x) > self.X_LIMIT
                    or abs(theta) > self.THETA_LIMIT
                    or self._t >= self.MAX_STEPS)
        return self._state.astype(np.float32), 1.0, done


class PendulumEnv:
    """Continuous-control pendulum swing-up (the classic Pendulum-v1
    dynamics: state (theta, theta_dot), observation (cos, sin,
    theta_dot), torque in [-2, 2], reward
    -(theta^2 + 0.1*theta_dot^2 + 0.001*torque^2), 200-step episodes).

    Exposes ``action_dim``/``action_low``/``action_high`` instead of
    ``num_actions`` — the Algorithm frame infers a gaussian policy head
    from this, the way the reference infers the distribution from the
    env's action space."""

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0
    MAX_STEPS = 200

    observation_dim = 3
    action_dim = 1
    action_low = -2.0
    action_high = 2.0
    # every done is a TIME LIMIT, never a true terminal: off-policy
    # learners (SAC) should bootstrap through episode boundaries
    # instead of masking the value there
    dones_are_truncations = True

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._theta = 0.0
        self._theta_dot = 0.0
        self._t = 0

    def _obs(self) -> np.ndarray:
        return np.array([np.cos(self._theta), np.sin(self._theta),
                         self._theta_dot], np.float32)

    def reset(self) -> np.ndarray:
        self._theta = self._rng.uniform(-np.pi, np.pi)
        self._theta_dot = self._rng.uniform(-1.0, 1.0)
        self._t = 0
        return self._obs()

    def step(self, action) -> Tuple[np.ndarray, float, bool]:
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          -self.MAX_TORQUE, self.MAX_TORQUE))
        th, thdot = self._theta, self._theta_dot
        # normalize angle to [-pi, pi] for the cost
        angle = ((th + np.pi) % (2 * np.pi)) - np.pi
        cost = angle ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        thdot = thdot + (3 * self.G / (2 * self.L) * np.sin(th)
                         + 3.0 / (self.M * self.L ** 2) * u) * self.DT
        thdot = float(np.clip(thdot, -self.MAX_SPEED, self.MAX_SPEED))
        th = th + thdot * self.DT
        self._theta, self._theta_dot = th, thdot
        self._t += 1
        return self._obs(), -float(cost), self._t >= self.MAX_STEPS
