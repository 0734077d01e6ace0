"""The environment builder for the worker processes the runtime spawns.

The reference strips its TPU plugin's bootstrap variables here, so a
worker's ``import jax`` cannot grab the chip. The port's counterpart is
the card's visibility: a worker process starts with
``CUDA_VISIBLE_DEVICES=""`` unless it is meant to use the card
(``worker_gpu_access``). Each process that touches the card makes a CUDA
context of its own, hundreds of MB of device memory, and the driver
already holds one for the scheduler's device path. Workers are fresh
interpreters started by ``subprocess.Popen``, never forked, so none
inherits the driver's context.

Reference analog: upstream ray sets ``CUDA_VISIBLE_DEVICES`` for each
worker process from the GPUs its lease holds (ray:
python/ray/_private/utils.py set_cuda_visible_devices).
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Mapping, Optional


def child_env(*, use_accelerator: bool = False,
              extra: Optional[Mapping[str, str]] = None) -> Dict[str, str]:
    """The environment for a worker process: the parent's, with its
    ``sys.path`` prepended to PYTHONPATH (workers import the driver's
    modules), the card hidden unless ``use_accelerator`` (the worker is
    meant to use it), and ``extra`` applied last so callers win."""
    env = dict(os.environ)
    if not use_accelerator:
        env["CUDA_VISIBLE_DEVICES"] = ""
    paths = [p for p in sys.path if p]
    if paths:
        prev = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = os.pathsep.join(paths) + (
            os.pathsep + prev if prev else "")
    for key, value in (extra or {}).items():
        env[key] = str(value)
    return env
