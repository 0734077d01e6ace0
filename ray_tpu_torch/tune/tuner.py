"""Tuner — trials as actors, random/grid search, ASHA early stopping.

Reference: ray: python/ray/tune/ — TuneController (trial FSM +
scheduling), search space API (tune/search/sample.py),
ASHAScheduler (tune/schedulers/async_hyperband.py: promote the top
1/reduction_factor of each rung, stop the rest).

Counterpart of ``ray_tpu/tune/tuner.py``, copied onto the port's runtime.
As in the reference, a trial actor runs one call at a time, so the
controller's ``poll`` of a running trial waits behind its ``run``: the
schedulers see a trial's reports once its trainable has returned, and a
"stopped" trial has already run its steps (ROADMAP.md, Queue C).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import random as _random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import ray_tpu_torch

# ----------------------------------------------------------------------
# search-space markers (reference: tune.grid_search / tune.uniform ...)
# ----------------------------------------------------------------------


class _Domain:
    pass


@dataclasses.dataclass
class grid_search(_Domain):  # noqa: N801 (reference API name)
    values: List[Any]


@dataclasses.dataclass
class choice(_Domain):  # noqa: N801
    values: List[Any]

    def sample(self, rng) -> Any:
        return rng.choice(self.values)


@dataclasses.dataclass
class uniform(_Domain):  # noqa: N801
    low: float
    high: float

    def sample(self, rng) -> float:
        return rng.uniform(self.low, self.high)


@dataclasses.dataclass
class loguniform(_Domain):  # noqa: N801
    low: float
    high: float

    def sample(self, rng) -> float:
        return float(math.exp(rng.uniform(math.log(self.low),
                                          math.log(self.high))))


def _expand_grid(space: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Cartesian product over grid_search axes (sampled axes stay)."""
    grid_keys = [k for k, v in space.items() if isinstance(v, grid_search)]
    if not grid_keys:
        return [dict(space)]
    combos = itertools.product(*[space[k].values for k in grid_keys])
    out = []
    for combo in combos:
        cfg = dict(space)
        for k, v in zip(grid_keys, combo):
            cfg[k] = v
        out.append(cfg)
    return out


def _sample(space: Dict[str, Any], rng) -> Dict[str, Any]:
    out = {}
    for k, v in space.items():
        out[k] = v.sample(rng) if isinstance(v, _Domain) else v
    return out


# ----------------------------------------------------------------------
# session: reuse the train report machinery (same semantics)
# ----------------------------------------------------------------------

from ray_tpu_torch.train.api import _Session  # noqa: E402


_sessions: Dict[int, _Session] = {}


def report(metrics: Dict[str, Any], checkpoint: Any = None) -> None:
    """Called from inside the trainable. ``checkpoint`` (any picklable
    state) is retained as the trial's LATEST checkpoint — PBT exploit
    clones it into a lagging trial (reference: tune.report(...,
    checkpoint=Checkpoint))."""
    session = _sessions.get(threading.get_ident())
    if session is None:
        raise RuntimeError("tune.report() called outside a trial")
    with session.lock:
        session.reports.append(dict(metrics))
        if checkpoint is not None:
            session.checkpoint = checkpoint


def get_checkpoint() -> Any:
    """Inside a trainable: the checkpoint this trial was (re)started
    from — None for a fresh start, a donor's state after a PBT exploit
    (reference: tune.get_checkpoint)."""
    session = _sessions.get(threading.get_ident())
    if session is None:
        raise RuntimeError("tune.get_checkpoint() called outside a trial")
    return getattr(session, "restored", None)


@ray_tpu_torch.remote
class _TrialActor:
    def __init__(self, index: int):
        self.index = index
        self._session: Optional[_Session] = None
        self._stop = threading.Event()

    def run(self, fn, config, restored=None):
        session = _Session(0, 1, None)
        session.checkpoint = None
        session.restored = restored
        self._session = session
        _sessions[threading.get_ident()] = session
        try:
            fn(config)
        finally:
            _sessions.pop(threading.get_ident(), None)
        with session.lock:
            return list(session.reports)

    def poll(self, since: int):
        """New reports after index `since` (incremental: polling the
        whole history every tick would be O(steps^2))."""
        s = self._session
        if s is None:
            return []
        with s.lock:
            return list(s.reports[since:])

    def get_checkpoint(self):
        """The trial's latest reported checkpoint (PBT donor read)."""
        s = self._session
        if s is None:
            return None
        with s.lock:
            return s.checkpoint


# ----------------------------------------------------------------------
# ASHA (reference: AsyncHyperBandScheduler)
# ----------------------------------------------------------------------

def _rung_cut(rung: List[float], signed_value: float,
              reduction_factor: int) -> str:
    """Async rung rule shared by ASHA and HyperBand: record the
    result, keep the top 1/reduction_factor, stop the rest."""
    rung.append(signed_value)
    rung.sort(reverse=True)
    k = max(1, len(rung) // reduction_factor)
    return "stop" if signed_value < rung[k - 1] else "continue"


@dataclasses.dataclass
class ASHAScheduler:
    metric: Optional[str] = None
    mode: str = "max"
    max_t: int = 100
    grace_period: int = 1
    reduction_factor: int = 3

    def __post_init__(self):
        self._rungs: Dict[int, List[float]] = {}
        r = self.grace_period
        self._milestones = []
        while r < self.max_t:
            self._milestones.append(r)
            r *= self.reduction_factor

    def on_result(self, trial_id: int, iteration: int,
                  value: float) -> str:
        """'continue' or 'stop' (reference: rung quantile cut)."""
        sign = 1.0 if self.mode == "max" else -1.0
        for m in self._milestones:
            if iteration == m:
                rung = self._rungs.setdefault(m, [])
                if _rung_cut(rung, sign * value,
                             self.reduction_factor) == "stop":
                    return "stop"
        return "continue"


# ----------------------------------------------------------------------
# Median stopping (reference: tune/schedulers/median_stopping_rule.py)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class MedianStoppingRule:
    """Stop a trial whose RUNNING MEAN falls below the median of the
    other trials' running means at the same step (after a grace
    period, once enough trials report) — the Google Vizier rule the
    reference implements."""

    metric: Optional[str] = None
    mode: str = "max"
    grace_period: int = 4
    min_samples_required: int = 3

    def __post_init__(self):
        self._histories: Dict[int, List[float]] = {}

    def on_result(self, trial_id: int, iteration: int,
                  value: float) -> str:
        sign = 1.0 if self.mode == "max" else -1.0
        hist = self._histories.setdefault(trial_id, [])
        hist.append(sign * value)
        if iteration < self.grace_period:
            return "continue"
        others = [sum(h[:iteration]) / min(len(h), iteration)
                  for tid, h in self._histories.items()
                  if tid != trial_id and h]
        if len(others) < self.min_samples_required:
            return "continue"
        import statistics

        median = statistics.median(others)
        mine = sum(hist) / len(hist)
        return "stop" if mine < median else "continue"


# ----------------------------------------------------------------------
# HyperBand (reference: tune/schedulers/hyperband.py)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class HyperBandScheduler:
    """Bracketed successive halving: trials round-robin into brackets
    whose FIRST cut comes at different budgets (bracket s starts
    culling at max_t / eta^s), trading exploration breadth against
    per-trial budget; within a bracket, each rung keeps the top 1/eta
    by reported score and stops the rest (the async promotion rule, as
    in the reference's time-multiplexed brackets)."""

    metric: Optional[str] = None
    mode: str = "max"
    max_t: int = 81
    eta: int = 3

    def __post_init__(self):
        # integer bracket count: log() float error drops the most
        # aggressive bracket for exact powers (e.g. max_t=243, eta=3)
        self.num_brackets = 1
        while self.eta ** self.num_brackets <= self.max_t:
            self.num_brackets += 1
        # bracket s: milestones r0*eta^k with r0 = max_t / eta^s
        self._milestones: Dict[int, List[int]] = {}
        for s in range(self.num_brackets):
            r = max(1, self.max_t // (self.eta ** s))
            ms = []
            while r < self.max_t:
                ms.append(r)
                r *= self.eta
            self._milestones[s] = ms
        self._bracket_of: Dict[int, int] = {}
        self._rungs: Dict[Tuple[int, int], List[float]] = {}
        self._next = 0

    def bracket_of(self, trial_id: int) -> int:
        s = self._bracket_of.get(trial_id)
        if s is None:
            s = self._next % self.num_brackets
            self._next += 1
            self._bracket_of[trial_id] = s
        return s

    def on_result(self, trial_id: int, iteration: int,
                  value: float) -> str:
        sign = 1.0 if self.mode == "max" else -1.0
        s = self.bracket_of(trial_id)
        for m in self._milestones[s]:
            if iteration == m:
                rung = self._rungs.setdefault((s, m), [])
                if _rung_cut(rung, sign * value, self.eta) == "stop":
                    return "stop"
        return "continue"


# ----------------------------------------------------------------------
# PBT (reference: tune/schedulers/pbt.py PopulationBasedTraining)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class PopulationBasedTraining:
    """Exploit-and-explore over a live population: at every
    ``perturbation_interval`` reports, a bottom-quantile trial copies a
    top-quantile trial's CHECKPOINT and hyperparameters, then perturbs
    the mutable hyperparameters (x1.2 / x0.8 for numeric domains,
    resample for choices). Trainables must report(...,
    checkpoint=state) and start from tune.get_checkpoint()."""

    metric: Optional[str] = None
    mode: str = "max"
    perturbation_interval: int = 4
    hyperparam_mutations: Dict[str, Any] = dataclasses.field(
        default_factory=dict)
    quantile_fraction: float = 0.25
    resample_probability: float = 0.25
    seed: int = 0

    def __post_init__(self):
        if not 0.0 < self.quantile_fraction <= 0.5:
            raise ValueError(
                "quantile_fraction must be in (0, 0.5]: top and bottom "
                "quantiles must not overlap")
        self._scores: Dict[int, float] = {}   # trial -> latest score
        self._rng = _random.Random(self.seed)
        self.num_perturbations = 0

    def on_result(self, trial_id: int, iteration: int, value: float):
        """'continue' or ('exploit', donor_trial_id)."""
        sign = 1.0 if self.mode == "max" else -1.0
        self._scores[trial_id] = sign * value
        if iteration % self.perturbation_interval != 0 \
                or len(self._scores) < 2:
            return "continue"
        ranked = sorted(self._scores, key=self._scores.__getitem__)
        k = max(1, int(len(ranked) * self.quantile_fraction))
        bottom, top = ranked[:k], ranked[-k:]
        if trial_id in bottom:
            donors = [t for t in top if t != trial_id]
            if donors:
                return ("exploit", self._rng.choice(donors))
        return "continue"

    def perturb(self, config: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(config)
        for key, domain in self.hyperparam_mutations.items():
            cur = out.get(key)
            resample = (self._rng.random() < self.resample_probability
                        or not isinstance(cur, (int, float)))
            if resample:
                if isinstance(domain, _Domain):
                    out[key] = domain.sample(self._rng)
                elif isinstance(domain, list):
                    out[key] = self._rng.choice(domain)
                elif callable(domain):
                    out[key] = domain()
            else:
                factor = self._rng.choice([0.8, 1.2])
                out[key] = type(cur)(cur * factor) \
                    if isinstance(cur, float) else max(1, int(cur * factor))
        self.num_perturbations += 1
        return out

    def forget(self, trial_id: int) -> None:
        self._scores.pop(trial_id, None)


# ----------------------------------------------------------------------
# tuner / controller
# ----------------------------------------------------------------------

@dataclasses.dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int = 4
    scheduler: Optional[ASHAScheduler] = None
    # model-based searcher (reference: tune.search_alg — hyperopt/
    # optuna integrations; here the native TPESearcher in search.py).
    # With a searcher, configs are suggested SEQUENTIALLY — each new
    # trial conditions on every completed result — so num_samples is
    # the trial budget and grid_search axes are rejected.
    search_alg: Optional[Any] = None
    seed: int = 0


@dataclasses.dataclass
class TrialResult:
    trial_id: int
    config: Dict[str, Any]
    metrics: Dict[str, Any]
    metrics_history: List[Dict[str, Any]]
    terminated_early: bool


class ResultGrid:
    def __init__(self, results: List[TrialResult]):
        self._results = results

    def __len__(self) -> int:
        return len(self._results)

    def __iter__(self):
        return iter(self._results)

    def __getitem__(self, i: int) -> TrialResult:
        return self._results[i]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: str = "max") -> TrialResult:
        def key(r: TrialResult):
            v = r.metrics.get(metric, float("-inf") if mode == "max"
                              else float("inf"))
            return v

        return (max if mode == "max" else min)(self._results, key=key)

    def get_dataframe(self) -> List[Dict[str, Any]]:
        """Rows of config+final metrics (no pandas dependency)."""
        return [dict(r.config, **r.metrics, trial_id=r.trial_id)
                for r in self._results]


class Tuner:
    def __init__(self, trainable: Callable[[dict], None], *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 storage_path: Optional[str] = None):
        self._fn = trainable
        self._space = dict(param_space or {})
        self._cfg = tune_config or TuneConfig()
        self._storage = storage_path

    @classmethod
    def restore(cls, storage_path: str,
                trainable: Callable[[dict], None]) -> "Tuner":
        """Resume an interrupted experiment from its storage directory
        (reference: Tuner.restore): the search space and tune config
        reload from the experiment spec; completed trials load from
        their result files and do NOT re-run; the remainder execute."""
        import os
        import pickle

        spec_path = os.path.join(storage_path, "experiment.pkl")
        if not os.path.exists(spec_path):
            raise FileNotFoundError(
                f"no experiment spec at {spec_path}; was this experiment "
                "run with storage_path?")
        with open(spec_path, "rb") as f:
            spec = pickle.load(f)
        return cls(trainable, param_space=spec["space"],
                   tune_config=spec["cfg"], storage_path=storage_path)

    def _make_configs(self) -> List[Dict[str, Any]]:
        rng = _random.Random(self._cfg.seed)
        grids = _expand_grid(self._space)
        configs = []
        for _ in range(self._cfg.num_samples):
            for g in grids:
                configs.append(_sample(g, rng))
        return configs

    def _storage_setup(self, configs) -> Dict[int, TrialResult]:
        """Create/load the experiment directory; returns completed
        trials keyed by id (reference: experiment checkpointing)."""
        import os
        import pickle

        if self._storage is None:
            return {}
        os.makedirs(self._storage, exist_ok=True)
        spec_path = os.path.join(self._storage, "experiment.pkl")
        if not os.path.exists(spec_path):
            with open(spec_path, "wb") as f:
                pickle.dump({"space": self._space, "cfg": self._cfg}, f)
        else:
            # trial_<id>.pkl files are keyed by index: silently reusing
            # another experiment's storage would return ITS results as
            # this one's
            with open(spec_path, "rb") as f:
                stored = pickle.load(f)
            if repr(stored.get("space")) != repr(self._space):
                raise ValueError(
                    f"storage_path {self._storage!r} belongs to a "
                    "different experiment (param_space mismatch); use "
                    "Tuner.restore() or a fresh directory")
        done: Dict[int, TrialResult] = {}
        for tid in range(len(configs)):
            p = os.path.join(self._storage, f"trial_{tid}.pkl")
            if os.path.exists(p):
                try:
                    with open(p, "rb") as f:
                        done[tid] = pickle.load(f)
                except Exception:
                    pass  # torn write from the crash: re-run the trial
        return done

    def _storage_save(self, result: TrialResult) -> None:
        if self._storage is None:
            return
        import os
        import pickle

        p = os.path.join(self._storage, f"trial_{result.trial_id}.pkl")
        tmp = f"{p}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, p)

    def fit(self) -> ResultGrid:
        cfg = self._cfg
        sched = cfg.scheduler
        metric = cfg.metric or (sched.metric if sched else None)
        mode = cfg.mode
        is_pbt = isinstance(sched, PopulationBasedTraining)
        searcher = cfg.search_alg
        if searcher is not None:
            if metric is None:
                raise ValueError("search_alg needs TuneConfig.metric")
            searcher.set_search_properties(self._space, metric, mode,
                                           cfg.seed)
            # configs materialize lazily at launch time: each suggest()
            # conditions on every completed trial so far
            configs: List[Optional[Dict[str, Any]]] = \
                [None] * cfg.num_samples
        else:
            configs = self._make_configs()

        completed = self._storage_setup(configs)
        if searcher is not None:
            # resumed experiments replay finished trials into the model
            for tid, res in sorted(completed.items()):
                searcher.register(tid, res.config) \
                    if hasattr(searcher, "register") else None
                searcher.on_trial_complete(tid, res.metrics)
        queue = [(tid, conf) for tid, conf in enumerate(configs)
                 if tid not in completed]
        running: Dict[int, Dict[str, Any]] = {}  # trial_id -> state
        results: List[Optional[TrialResult]] = [None] * len(configs)
        for tid, res in completed.items():
            results[tid] = res

        def launch(tid: int, conf: Dict[str, Any],
                   restored: Any = None) -> None:
            actor = _TrialActor.remote(tid)
            ref = actor.run.remote(self._fn, conf, restored)
            prev = running.get(tid)
            # a RESTARTED actor's report log begins empty: the poll
            # cursor must reset with it (carrying the old counter would
            # skip the fresh run's first reports and starve the
            # scheduler); accumulated history is kept
            running[tid] = {"actor": actor, "ref": ref, "config": conf,
                            "seen": 0,
                            "history": prev["history"] if prev else [],
                            "stopped": False}

        def exploit(tid: int, donor_tid: int) -> None:
            """PBT: clone the donor's checkpoint + config, perturb the
            mutations, restart the lagging trial in place."""
            st = running[tid]
            donor = running.get(donor_tid)
            if donor is None:
                return
            try:
                ckpt = ray_tpu_torch.get(
                    donor["actor"].get_checkpoint.remote(), timeout=30)
            except Exception:
                return
            new_conf = sched.perturb(dict(donor["config"]))
            try:
                ray_tpu_torch.kill(st["actor"])
            except Exception:
                pass
            launch(tid, new_conf, restored=ckpt)

        while queue or running:
            while queue and len(running) < cfg.max_concurrent_trials:
                tid, conf = queue.pop(0)
                if conf is None:  # searcher path: suggest at launch
                    conf = searcher.suggest(tid)
                    configs[tid] = conf
                launch(tid, conf)

            refs = [st["ref"] for st in running.values()]
            done, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=0.1)
            done_ids = {r.object_id() for r in done}

            for tid in list(running):
                st = running[tid]
                # incremental report polling drives the scheduler
                try:
                    new = ray_tpu_torch.get(
                        st["actor"].poll.remote(st["seen"]), timeout=10)
                except Exception:
                    new = []
                restarted = False
                for rep in new:
                    st["seen"] += 1
                    st["history"].append(rep)
                    if sched is not None and metric is not None \
                            and metric in rep and not st["stopped"]:
                        verdict = sched.on_result(tid, st["seen"],
                                                  float(rep[metric]))
                        if verdict == "stop":
                            st["stopped"] = True
                            ray_tpu_torch.kill(st["actor"])
                            final = st["history"][-1] if st["history"] \
                                else {}
                            result = TrialResult(
                                tid, st["config"], dict(final),
                                list(st["history"]), True)
                            results[tid] = result
                            self._storage_save(result)
                            if searcher is not None:
                                searcher.on_trial_complete(
                                    tid, result.metrics)
                            if is_pbt:
                                sched.forget(tid)
                            running.pop(tid)
                            break
                        if isinstance(verdict, tuple) \
                                and verdict[0] == "exploit":
                            exploit(tid, verdict[1])
                            restarted = True
                            break
                if tid not in running or restarted:
                    continue
                if st["ref"].object_id() in done_ids:
                    try:
                        fresh = ray_tpu_torch.get(st["ref"])
                        # st["history"] accumulates ACROSS restarts
                        # (PBT exploit); the run() return covers only
                        # the final run — append just its unpolled tail
                        history = st["history"] + fresh[st["seen"]:]
                    except Exception:
                        history = st["history"]  # killed or crashed
                    final = history[-1] if history else {}
                    result = TrialResult(
                        tid, st["config"], dict(final), list(history),
                        False)
                    results[tid] = result
                    self._storage_save(result)
                    if searcher is not None:
                        searcher.on_trial_complete(tid, result.metrics)
                    if is_pbt:
                        sched.forget(tid)
                    try:
                        ray_tpu_torch.kill(st["actor"])
                    except Exception:
                        pass
                    running.pop(tid)

        return ResultGrid([r for r in results if r is not None])
