"""Connector pipelines: env-to-module observation transforms.

The port's own copy of ``ray_tpu/rllib/connectors.py`` (numpy only; the
port imports nothing of ``ray_tpu``).

Reference surface: rllib's ConnectorV2 stack (ray: rllib/connectors/ —
env-to-module pipelines transforming observations before the RLModule
forward, with state that synchronizes across env runners). Semantics
kept: a PIPELINE of connectors runs on every observation batch inside
the env runner; stateful connectors (running-stat normalizers)
accumulate per-runner deltas that the driver MERGES exactly after each
collect round and rebroadcasts — no runner drifts on its own
statistics.

Shape: connectors are vectorized numpy array->array transforms
(they run inside the runner's batched forward path, on [N, obs]
blocks), and normalizer merging is the associative parallel-Welford
combine, so merge order never changes the result.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class Connector:
    """One env-to-module transform. Stateless by default."""

    def init_state(self) -> Any:
        return None

    def transform(self, obs: "np.ndarray", state: Any) -> "np.ndarray":
        raise NotImplementedError

    def observe(self, obs: "np.ndarray", state: Any) -> Any:
        """Fold a RAW observation batch into this runner's local state
        delta (called before transform); return the updated state."""
        return state

    def merge(self, states: List[Any]) -> Any:
        """Combine runner-local states into the next global state."""
        return states[0] if states else None


class Lambda(Connector):
    """Stateless array transform (reference: the functional connector
    pieces, e.g. observation scaling/clipping)."""

    def __init__(self, fn):
        self._fn = fn

    def transform(self, obs, state):
        return self._fn(obs)


class ObsNormalizer(Connector):
    """Running-mean/variance observation normalization (reference:
    MeanStdObservationFilter). State is the Welford triple
    (count, mean, M2); per-runner deltas merge with the exact
    parallel combine, so statistics stay identical to a single-stream
    computation regardless of runner count."""

    def __init__(self, clip: float = 10.0, eps: float = 1e-8):
        self.clip = clip
        self.eps = eps

    def init_state(self):
        return (0.0, None, None)  # (count, mean[obs], M2[obs])

    def observe(self, obs, state):
        count, mean, m2 = state
        b = np.asarray(obs, np.float64)
        bn = float(len(b))
        if bn == 0:
            return state
        bmean = b.mean(axis=0)
        bm2 = ((b - bmean) ** 2).sum(axis=0)
        if mean is None:
            return (bn, bmean, bm2)
        delta = bmean - mean
        tot = count + bn
        mean = mean + delta * (bn / tot)
        m2 = m2 + bm2 + (delta ** 2) * count * bn / tot
        return (tot, mean, m2)

    def transform(self, obs, state):
        count, mean, m2 = state
        if mean is None or count < 2:
            return obs
        std = np.sqrt(m2 / count + self.eps)
        out = (np.asarray(obs, np.float32) - mean.astype(np.float32)) \
            / std.astype(np.float32)
        return np.clip(out, -self.clip, self.clip)

    def merge(self, states):
        out = self.init_state()
        for st in states:
            count, mean, m2 = st
            if mean is None:
                continue
            ocount, omean, om2 = out
            if omean is None:
                out = st
                continue
            delta = mean - omean
            tot = ocount + count
            out = (tot,
                   omean + delta * (count / tot),
                   om2 + m2 + (delta ** 2) * ocount * count / tot)
        return out


class ActionConnector:
    """One module-to-env transform (reference: ConnectorV2's
    module-to-env pieces — action clipping/rescaling between the policy
    sample and env.step). Stateless: applied batched [N, act] inside
    the runner; the RAW action (and its logp) goes into the sample
    batch, the TRANSFORMED action goes to the env."""

    def to_env(self, actions: "np.ndarray") -> "np.ndarray":
        raise NotImplementedError


class ActionClip(ActionConnector):
    """Clip actions to the env's bounds (the standard companion of an
    unsquashed gaussian head)."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def to_env(self, actions):
        return np.clip(actions, self.low, self.high)


class ActionRescale(ActionConnector):
    """Map policy-space [-1, 1] actions to env bounds [low, high]
    (tanh-squash companions; compose after a Lambda(np.tanh))."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def to_env(self, actions):
        return self.low + (np.asarray(actions) + 1.0) * 0.5 \
            * (self.high - self.low)


class ActionLambda(ActionConnector):
    """Stateless functional action transform (e.g. np.tanh squash)."""

    def __init__(self, fn):
        self._fn = fn

    def to_env(self, actions):
        return self._fn(actions)


class ActionPipeline:
    """Ordered module-to-env action transforms."""

    def __init__(self, connectors: List[ActionConnector]):
        self.connectors = list(connectors)

    def to_env(self, actions: "np.ndarray") -> "np.ndarray":
        out = actions
        for c in self.connectors:
            out = c.to_env(out)
        return out


class ConnectorPipeline:
    """Ordered connectors; runners apply it per observation batch and
    return their local state deltas for the driver to merge."""

    def __init__(self, connectors: List[Connector]):
        self.connectors = list(connectors)

    def init_state(self) -> List[Any]:
        return [c.init_state() for c in self.connectors]

    def observe_and_transform(self, obs, prior: List[Any],
                               delta: List[Any]
                               ) -> Tuple["np.ndarray", List[Any]]:
        """Fold obs into each connector's LOCAL DELTA (never into the
        broadcast prior — the driver merges prior + per-runner deltas,
        and folding into the prior would re-count it once per runner
        per round), transforming with the effective prior+delta
        view."""
        out = obs
        new_delta = []
        for c, p, dl in zip(self.connectors, prior, delta):
            dl = c.observe(out, dl)
            out = c.transform(out, c.merge([p, dl]))
            new_delta.append(dl)
        return out, new_delta

    def effective(self, prior: List[Any], delta: List[Any]) -> List[Any]:
        return [c.merge([p, dl]) for c, p, dl in
                zip(self.connectors, prior, delta)]

    def transform(self, obs, states: List[Any]) -> "np.ndarray":
        out = obs
        for c, st in zip(self.connectors, states):
            out = c.transform(out, st)
        return out

    def merge(self, state_lists: List[List[Any]]) -> List[Any]:
        if not state_lists:
            return self.init_state()
        return [c.merge([sl[i] for sl in state_lists])
                for i, c in enumerate(self.connectors)]
