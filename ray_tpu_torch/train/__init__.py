"""ray_tpu_torch.train — distributed training orchestration.

Counterpart of ``ray_tpu/train/`` on the port's runtime.

Reference surface: Ray Train (ray: python/ray/train/ —
DataParallelTrainer/BackendExecutor/WorkerGroup, ScalingConfig/
RunConfig/FailureConfig, Checkpoint, ray.train.report). Semantics kept:
a controller spawns a worker group of actors, each running the user's
train loop; workers report metrics + checkpoints; worker death triggers
a group restart from the latest checkpoint under FailureConfig.

The compute path is the user's loop, e.g. the port's train step
(models/train_step.py) on the card; checkpoints are ``torch.save`` files
(save_torch_checkpoint / load_torch_checkpoint, the reference's Orbax
pair renamed). Train workers are threaded actors (max_concurrency=2),
so in either worker mode they run in the driver's process.
"""

from ray_tpu_torch.train.api import (  # noqa: F401
    Checkpoint, DataIterator, FailureConfig, Result, RunConfig, ScalingConfig,
    Trainer, get_checkpoint, get_context, get_dataset_shard,
    load_torch_checkpoint, report, save_torch_checkpoint)

__all__ = [
    "Trainer", "ScalingConfig", "RunConfig", "FailureConfig",
    "Checkpoint", "Result", "report", "get_checkpoint", "get_context",
    "get_dataset_shard", "DataIterator",
    "save_torch_checkpoint", "load_torch_checkpoint",
]
