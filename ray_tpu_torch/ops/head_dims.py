"""The head widths the port's attention kernels are built for.

One table for the three wrappers (``paged_attention``, ``block_attention``,
the ``flash`` kernels), ``perf.serving_ab`` and the tests. The reference's
kernels take any head_dim (kernels 1 and 2) or any multiple of 128 (the
flash rule); the port builds each kernel for the widths the JAX package's
configurations use: 16 (``tiny``, the smoke decode model, the serving A/B
model), 32 (the smoke model), 64 (the default ``TransformerConfig``), 128
(the flagship) and 256 (the widest the flash rule picks in practice).
Any other width raises ``ValueError`` naming the kernel's set (ROADMAP.md,
Queue C).

Each width is a library of its own: ``ops/_build.py`` compiles
``csrc/<source>.cu`` once a width of ``SOURCES`` with ``defines``, so the
widths compile in parallel ``nvcc`` processes.

Routes in bf16, decided here alone and compiled into each width's library
(``RAY_TPU_SM90_FORWARD``, ``RAY_TPU_SM90_BACKWARD``): the forwards
(kernel 2, kernel 3a) run the wgmma + TMA kernels of
``csrc/attention_fwd_sm90.cuh`` at ``SM90_FORWARD``, every width each
takes: 3a the 128-query template; kernel 2 the template or the split
kernel, whose boxes take the 32- and 64-byte rows of 16 and 32 under the
swizzle of their width, as ``ring_attention.block_plan`` picks. The flash
backward (3b, 3c) runs the wgmma + TMA kernels of
``csrc/attention_bwd_sm90.cuh`` at ``SM90_BACKWARD``, every width flash
takes: one design at 128 and one for 256's register and shared-memory
budgets. f32 runs the FMA tiles of ``csrc/mma_tiles.cuh`` at every width
(wgmma has no f32).
"""

from __future__ import annotations

from typing import Tuple

PAGED_ATTENTION: Tuple[int, ...] = (16, 32, 64, 128, 256)   # kernel 1
BLOCK_ATTENTION: Tuple[int, ...] = (16, 32, 64, 128, 256)   # kernel 2
FLASH: Tuple[int, ...] = (128, 256)                         # kernels 3a-3c

KERNEL_HEAD_DIMS = {"paged_attention": PAGED_ATTENTION,
                    "block_attention": BLOCK_ATTENTION,
                    "flash": FLASH}
# {csrc source: the widths it is built for}
SOURCES = {"paged_attention": PAGED_ATTENTION,
           "ring_attention": BLOCK_ATTENTION,
           "flash_attention": FLASH}

# bf16 widths on the wgmma + TMA kernels (every width each kernel takes)
SM90_FORWARD: Tuple[int, ...] = (16, 32, 64, 128, 256)
SM90_BACKWARD: Tuple[int, ...] = (128, 256)

# the width whose library takes the source's own name
DEFAULT_HEAD_DIM = 128


def check(kernel: str, head_dim: int, who: str = "") -> None:
    """Raises ValueError unless ``kernel`` (a key of KERNEL_HEAD_DIMS) is
    built for ``head_dim``. ``who`` names the caller in the message."""
    widths = KERNEL_HEAD_DIMS[kernel]
    if head_dim not in widths:
        raise ValueError(f"{who or kernel}: head_dim {head_dim} has no "
                         f"{kernel} kernel; it is built for head_dim in "
                         f"{widths} (ROADMAP.md, Queue C)")


def library(source: str, head_dim: int) -> str:
    """The library name of ``csrc/<source>.cu`` built for ``head_dim``."""
    if head_dim == DEFAULT_HEAD_DIM:
        return source
    return f"{source}_d{head_dim}"


def defines(head_dim: int) -> Tuple[str, ...]:
    """nvcc's -D flags for a library of ``head_dim``: the width and its
    bf16 routes (1: the wgmma template, 0: the FMA tiles)."""
    return (f"-DRAY_TPU_HEAD_DIM={head_dim}",
            f"-DRAY_TPU_SM90_FORWARD={int(head_dim in SM90_FORWARD)}",
            f"-DRAY_TPU_SM90_BACKWARD={int(head_dim in SM90_BACKWARD)}")
