"""The head widths the port's attention kernels take and are built for.

One table for the three wrappers (``paged_attention``, ``block_attention``,
the ``flash`` kernels), ``perf.serving_ab`` and the tests. The reference's
kernels take any head_dim (kernels 1 and 2) or any multiple of 128 (the
flash rule). The port builds each kernel at the widths of its *classes*:
16 (``tiny``, the smoke decode model, the serving A/B model), 32 (the
smoke model), 64 (the default ``TransformerConfig``), 128 (the flagship)
and 256 (the widest the flash rule picks in practice).

Kernels 1 and 2 take every head_dim from 1 to 256: a width runs on the
library of its class (``width_class``: the smallest built width at or
above it), which gets the true head_dim at run time, masks the columns
past it and takes its softmax scale from it; where the width equals its
class the library runs the code it always ran. The flash kernels take
128 and 256 alone. A wider head raises ``ValueError`` naming the queue of
ROADMAP.md that holds it (B4: flash at 384, 512, ...; B5: kernels 1 and 2
above 256).

Each class is a library of its own: ``ops/_build.py`` compiles
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

# the widths each kernel's libraries are built for (its classes)
PAGED_ATTENTION: Tuple[int, ...] = (16, 32, 64, 128, 256)   # kernel 1
BLOCK_ATTENTION: Tuple[int, ...] = (16, 32, 64, 128, 256)   # kernel 2
FLASH: Tuple[int, ...] = (128, 256)                         # kernels 3a-3c
# kernels 1 and 2 take every head_dim up to the widest class; the flash
# kernels their built widths alone
ANY_WIDTH = ("paged_attention", "block_attention")
# the queue of ROADMAP.md that holds a wider head
WIDER = {"paged_attention": "B5", "block_attention": "B5", "flash": "B4"}

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
    """Raises ValueError unless ``kernel`` (a key of KERNEL_HEAD_DIMS)
    takes ``head_dim``. ``who`` names the caller in the message."""
    widths = KERNEL_HEAD_DIMS[kernel]
    if kernel in ANY_WIDTH:
        ok, takes = 1 <= head_dim <= widths[-1], f"1 to {widths[-1]}"
    else:
        ok, takes = head_dim in widths, f"in {widths}"
    if not ok:
        raise ValueError(f"{who or kernel}: head_dim {head_dim} has no "
                         f"{kernel} kernel; it takes head_dim {takes} "
                         f"(ROADMAP.md, Queue B, {WIDER[kernel]})")


def width_class(head_dim: int, kernel: str = "paged_attention") -> int:
    """The built width whose library runs ``head_dim`` for ``kernel``:
    the smallest of its widths at or above it. Raises as ``check``."""
    check(kernel, head_dim)
    return next(w for w in KERNEL_HEAD_DIMS[kernel] if w >= head_dim)


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
