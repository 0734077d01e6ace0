"""Model-based search: a NATIVE Tree-structured Parzen Estimator.

Counterpart of ``ray_tpu/tune/search.py``, copied (the same draws from the
same seeds, so suggestions equal the reference's).

Reference surface: Ray Tune's searcher tier (ray: python/ray/tune/
search/ — Searcher.suggest/on_trial_complete, and the hyperopt/optuna
integrations that provide TPE). The TPE itself is implemented here,
with no optimisation library (Bergstra et al. 2011, "Algorithms for
Hyper-Parameter Optimization"): completed trials split into a GOOD
quantile and the rest; each is modeled with a per-dimension Parzen
(kernel-density) estimator; candidates sample from the good model and
the one maximizing l(x)/g(x) — the expected-improvement surrogate —
is suggested next. Independent per-dimension factorization, like
hyperopt's default.

Composes with the existing schedulers (ASHA/HyperBand/median): the
searcher picks WHERE to sample, the scheduler decides WHEN to stop.
"""

from __future__ import annotations

import math
import random as _random
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.tune.tuner import (_Domain, choice, grid_search, loguniform,
                                uniform)


class Searcher:
    """The seam the Tuner drives (reference: tune.search.Searcher)."""

    def set_search_properties(self, space: Dict[str, Any], metric: str,
                              mode: str, seed: int = 0) -> None:
        raise NotImplementedError

    def suggest(self, trial_id: int) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: int,
                          result: Dict[str, Any]) -> None:
        raise NotImplementedError


class BasicVariantSearcher(Searcher):
    """Random sampling through the Searcher seam (the default path the
    Tuner takes without a searcher is equivalent; this exists so
    search_alg=None and search_alg=BasicVariantSearcher() agree)."""

    def set_search_properties(self, space, metric, mode, seed=0):
        for key, dom in space.items():
            if isinstance(dom, grid_search):
                raise ValueError(
                    "searchers sample sequentially and do not expand "
                    f"grid_search axes (got one at {key!r}); drop the "
                    "search_alg for grid experiments, or use choice()")
        self._space = space
        self._rng = _random.Random(seed)

    def suggest(self, trial_id):
        from ray_tpu_torch.tune.tuner import _sample

        return _sample(self._space, self._rng)

    def on_trial_complete(self, trial_id, result):
        pass


def _to_unit(domain, value) -> Optional[float]:
    """Map a sampled value into the reals for KDE modeling (uniform:
    identity; loguniform: log); None for categorical."""
    if isinstance(domain, uniform):
        return float(value)
    if isinstance(domain, loguniform):
        return math.log(float(value))
    return None


class TPESearcher(Searcher):
    """Native TPE over uniform/loguniform/choice dimensions.

    n_initial random trials seed the model; after that each suggestion
    draws n_candidates from the good-quantile KDE and keeps the
    arg-max of l(x)/g(x). gamma is the good-quantile fraction.
    """

    def __init__(self, n_initial: int = 10, gamma: float = 0.25,
                 n_candidates: int = 24, prior_weight: float = 0.25):
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        # probability of suggesting from the PRIOR (a fresh random
        # sample) instead of the model: without it the l/g argmax
        # collapses onto the first good cluster's mode and never
        # escapes (observed: 30 near-identical suggestions around a
        # suboptimal early point). Hyperopt gets the same effect from
        # its prior pseudo-count in the Parzen mixture.
        self.prior_weight = prior_weight
        self.novelty = 0.5
        self._trials: Dict[int, Dict[str, Any]] = {}
        self._scores: Dict[int, float] = {}

    def set_search_properties(self, space, metric, mode, seed=0):
        for key, dom in space.items():
            if isinstance(dom, grid_search):
                raise ValueError(
                    "TPESearcher does not compose with grid_search "
                    f"axes (got one at {key!r}); use choice(...)")
        self._space = space
        self._metric = metric
        self._mode = mode
        self._rng = np.random.default_rng(seed)
        self._pyrng = _random.Random(seed)

    # -- bookkeeping -----------------------------------------------------
    def on_trial_complete(self, trial_id, result):
        if self._metric not in (result or {}):
            return
        value = float(result[self._metric])
        if self._mode == "max":
            value = -value  # model minimizes
        config = self._trials.get(trial_id)
        if config is not None:
            self._scores[trial_id] = value

    def register(self, trial_id: int, config: Dict[str, Any]) -> None:
        self._trials[trial_id] = config

    # -- the estimator ---------------------------------------------------
    def _split(self):
        done = [(self._scores[t], self._trials[t])
                for t in self._scores]
        done.sort(key=lambda x: x[0])
        n_good = max(1, int(math.ceil(self.gamma * len(done))))
        return ([c for _, c in done[:n_good]],
                [c for _, c in done[n_good:]])

    def _kde_logpdf(self, xs: np.ndarray, obs: np.ndarray,
                    low: float, high: float) -> np.ndarray:
        """Parzen mixture: gaussians at the observations PLUS a
        uniform prior pseudo-component (weight 1/(n+1), hyperopt's
        prior count) — the prior keeps both densities bounded away
        from zero so the l/g ratio cannot blow up at the data's edge."""
        span = max(high - low, 1e-12)
        n = len(obs)
        w0 = 1.0 / (n + 1.0)
        if n == 0:
            return np.full(len(xs), -math.log(span))
        bw = max(np.std(obs) * (n ** -0.2), span / 10.0, 1e-12)
        z = (xs[:, None] - obs[None, :]) / bw
        comp = -0.5 * z * z - math.log(bw * math.sqrt(2 * math.pi))
        m = comp.max(axis=1)
        kde = np.exp(m) * np.exp(comp - m[:, None]).mean(axis=1)
        return np.log(w0 / span + (1.0 - w0) * kde)

    def _suggest_dim(self, key: str, domain, good: List[dict],
                     bad: List[dict]):
        if isinstance(domain, choice):
            values = list(domain.values)
            k = len(values)
            # smoothed categorical ratio l(c)/g(c)
            gcount = np.ones(k)
            bcount = np.ones(k)
            for c in good:
                gcount[values.index(c[key])] += 1
            for c in bad:
                bcount[values.index(c[key])] += 1
            score = np.log(gcount / gcount.sum()) \
                - np.log(bcount / bcount.sum())
            probs = np.exp(score - score.max())
            probs /= probs.sum()
            return values[int(self._rng.choice(k, p=probs))]
        low, high = ((math.log(domain.low), math.log(domain.high))
                     if isinstance(domain, loguniform)
                     else (domain.low, domain.high))
        gobs = np.array([_to_unit(domain, c[key]) for c in good])
        bobs = np.array([_to_unit(domain, c[key]) for c in bad])
        span = high - low
        bw = max((np.std(gobs) if len(gobs) else span) *
                 (max(len(gobs), 1) ** -0.2), span / 20.0, 1e-12)
        # candidates from the good model (plus a uniform tail so the
        # proposal never collapses), scored by l - g with a NOVELTY
        # term: subtracting the density of everything already
        # evaluated stops the argmax from re-suggesting the good
        # cluster's mode verbatim — a clone evaluation carries zero
        # information, and without this the search pinned itself to
        # the first decent point for dozens of trials
        centers = self._rng.choice(gobs, size=self.n_candidates) \
            if len(gobs) else self._rng.uniform(low, high,
                                                self.n_candidates)
        cands = centers + self._rng.normal(0, bw, self.n_candidates)
        cands = np.clip(cands, low, high)
        cands[0] = self._rng.uniform(low, high)  # exploration insurance
        all_obs = np.concatenate([gobs, bobs]) if len(bobs) else gobs
        score = self._kde_logpdf(cands, gobs, low, high) \
            - self._kde_logpdf(cands, bobs, low, high) \
            - self.novelty * self._kde_logpdf(cands, all_obs, low, high)
        best = float(cands[int(np.argmax(score))])
        return (math.exp(best) if isinstance(domain, loguniform)
                else best)

    def suggest(self, trial_id):
        from ray_tpu_torch.tune.tuner import _sample

        if len(self._scores) < self.n_initial \
                or self._rng.random() < self.prior_weight:
            config = _sample(self._space, self._pyrng)
            self.register(trial_id, config)
            return config
        good, bad = self._split()
        config = {}
        for key, dom in self._space.items():
            if isinstance(dom, _Domain):
                config[key] = self._suggest_dim(key, dom, good, bad)
            else:
                config[key] = dom
        self.register(trial_id, config)
        return config
