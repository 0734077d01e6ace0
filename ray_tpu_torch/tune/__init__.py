"""ray_tpu_torch.tune — hyperparameter optimization.

Counterpart of ``ray_tpu/tune/``, copied onto the port's actors and Train's
``_Session``: a trial's tensors, and the checkpoints it reports, stay where
its trainable puts them (on the card for a model trained there). Reference
surface: Ray Tune (ray: python/ray/tune/ — Tuner.fit() runs N
trials as actors under a TuneController; search spaces
tune.grid_search/uniform/loguniform/choice; schedulers like ASHA stop
unpromising trials early; results come back as a ResultGrid with
get_best_result). Semantics kept at minimum-viable scale; trials run as
framework actors, reporting through the same train.report session API.
"""

from ray_tpu_torch.tune.tuner import (ASHAScheduler,  # noqa: F401
                                HyperBandScheduler, MedianStoppingRule,
                                PopulationBasedTraining, ResultGrid,
                                TrialResult, TuneConfig, Tuner, choice,
                                get_checkpoint, grid_search, loguniform,
                                report, uniform)
from ray_tpu_torch.tune.search import (BasicVariantSearcher,  # noqa: F401
                                 Searcher, TPESearcher)

__all__ = [
    "Tuner", "TuneConfig", "ASHAScheduler", "HyperBandScheduler",
    "MedianStoppingRule", "PopulationBasedTraining",
    "ResultGrid", "TrialResult", "grid_search", "choice", "uniform",
    "loguniform", "report", "get_checkpoint",
    "Searcher", "BasicVariantSearcher", "TPESearcher",
]
