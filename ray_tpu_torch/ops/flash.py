"""Flash attention — the train step's fused causal attention, on Hopper.

Counterpart of ``ray_tpu/ops/flash.py``, which wraps the library Pallas TPU
flash attention: a forward ``pallas_call`` and the two backward kernels of
its custom VJP. Here the three are hand-written CUDA C++
(``csrc/flash_attention.cu``), bound as one ``torch.autograd.Function``:

  - ``flash_fwd``: ``o = softmax(q kᵀ / √D) v`` and ``lse``, the row
    log-sum-exp of the scaled, masked scores (f32 [B, H, S]);
  - ``flash_bwd_dq``: dq from q, k, v, do, lse and ``di = rowsum(o * do)``;
  - ``flash_bwd_dkv``: dk and dv from the same.

``di`` is computed in PyTorch between forward and backward, as the library
computes it outside its kernels. In bf16 the three take byte strides
(``flash_attention_*_bf16``) and run where the width's library was built
to (``head_dims.SM90_FORWARD``, ``head_dims.SM90_BACKWARD``): the forward
on Hopper's wgmma with TMA-fed tiles, on the kernel shared with ring
attention's block; the backward on the wgmma kernels of
``csrc/attention_bwd_sm90.cuh``, at 128 and 256 each. In f32 all three
run on FMA kernels (wgmma has no f32). Each of the three wrappers
takes its plain PyTorch version (``_flash_fwd_reference``,
``_flash_bwd_dq_reference``, ``_flash_bwd_dkv_reference``) for a CPU
tensor, and for a CUDA tensor launches its kernel or raises: there is no
fallback. Each counts its kernel
launches in ``.launches``. ``flash_attention_reference`` is the whole
function in plain ops, its gradient autograd's: the tests' oracle.

The kernels take any strides over batch, heads and sequence (shared by q,
k, v and do) and unit stride over head_dim, so the model's [B, S, H, D]
layout goes in as a transposed view, without a copy. They mask a ragged
sequence length inside the kernel: nothing is padded, so the reference's
padding, and its error for a padded non-causal call, have no counterpart.
head_dim must be 128 (the flagship's) or 256 (``head_dims.FLASH``: the
multiples of 128 the reference's flash rule picks, up to 256), one library
a width; query and KV heads must be equal (the model repeats KV heads
before the call, as the reference does).
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from ray_tpu_torch.ops import _build, head_dims

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TMA_MAX_STRIDE = 2 ** 40   # bytes
# the device type the kernels run on (tests point it at "meta" to reach
# the launch with a recording library)
_KERNEL_DEVICE = "cuda"


# ----------------------------------------------------------------------
# plain versions (CPU path and on-card oracle)
# ----------------------------------------------------------------------

def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """Scaled f32 scores [B, H, S, S]; masked entries are -1e30."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        1.0 / math.sqrt(q.shape[-1]))
    if causal:
        n = q.shape[2]
        keep = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def _flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 3a's function: (o in q's dtype, lse f32 [B, H, S])."""
    s = _scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.exp(s - lse[..., None]), v.float())
    return o.to(q.dtype), lse


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              causal: bool = True) -> torch.Tensor:
    """[B, H, S, D] attention in plain ops (f32 scores and softmax), in q's
    dtype; differentiable by autograd."""
    return _flash_fwd_reference(q, k, v, causal)[0]


def _probs_and_ds(q, k, v, do, lse, di, causal):
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - di[..., None])


def _flash_bwd_dq_reference(q, k, v, do, lse, di,
                            causal: bool = True) -> torch.Tensor:
    """Kernel 3c's function: dq = (p * (do vᵀ - di)) k / √D."""
    _p, ds = _probs_and_ds(q, k, v, do, lse, di, causal)
    dq = torch.matmul(ds, k.float()) * (1.0 / math.sqrt(q.shape[-1]))
    return dq.to(q.dtype)


def _flash_bwd_dkv_reference(q, k, v, do, lse, di, causal: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 3b's function: dk = dsᵀ q / √D, dv = pᵀ do."""
    p, ds = _probs_and_ds(q, k, v, do, lse, di, causal)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * (
        1.0 / math.sqrt(q.shape[-1]))
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------------
# the kernel wrappers: plain version on the CPU, CUDA kernel on the card
# ----------------------------------------------------------------------

def _check(name: str, tensors, rows) -> None:
    """What the kernels take: one CUDA device and dtype, [B, H, S, D]
    (D in ``head_dims.FLASH``) with shared strides and unit head_dim
    stride, 16-byte aligned rows, and contiguous f32 [B, H, S] row
    vectors. The bf16 entries take what TMA takes, where they read through
    it or not: every (batch, head, sequence) stride must also be positive
    and below 2^40 bytes."""
    q = tensors[0]
    if q.device.type != _KERNEL_DEVICE:
        raise ValueError(f"{name}: no kernel for {q.device}")
    if any(t.device != q.device for t in (*tensors, *rows)):
        raise ValueError(f"{name}: all tensors must be on {q.device}")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype
                                          for t in tensors):
        raise TypeError(f"{name}: q, k, v (and do) must share one dtype "
                        f"of {list(_DTYPE_CODES)}, got "
                        f"{[t.dtype for t in tensors]}")
    if q.dim() != 4 or any(t.shape != q.shape for t in tensors):
        raise ValueError(f"{name}: q, k, v (and do) must be [B, H, S, D] "
                         f"of one shape (equal query and KV heads), got "
                         f"{[tuple(t.shape) for t in tensors]}")
    head_dims.check("flash", q.shape[-1], name)
    vec = 16 // q.element_size()
    if (q.stride(-1) != 1 or any(t.stride() != q.stride() for t in tensors)
            or any(s % vec for s in q.stride()[:3])
            or any(t.data_ptr() % 16 for t in tensors)):
        raise ValueError(f"{name}: q, k, v (and do) must share strides "
                         "with unit head_dim stride and 16-byte aligned "
                         "rows")
    if q.dtype == torch.bfloat16 and not all(
            0 < s * q.element_size() < _TMA_MAX_STRIDE
            for s in q.stride()[:3]):
        raise ValueError(f"{name}: the bf16 kernels take what TMA takes, "
                         f"(batch, head, sequence) strides "
                         f"of 16 to 2^40 bytes, got {q.stride()[:3]} "
                         f"elements")
    if torch.empty_like(q).stride() != q.stride():
        raise ValueError(f"{name}: q, k, v (and do) must not overlap "
                         f"(strides {q.stride()}): the outputs take q's "
                         f"strides, and an overlapping q's cannot be "
                         f"allocated")
    B, H, S, _D = q.shape
    if any(r.dtype != torch.float32 or r.shape != (B, H, S)
           or not r.is_contiguous() for r in rows):
        raise ValueError(f"{name}: lse and di must be contiguous f32 "
                         f"[{B}, {H}, {S}]")


def _launch(kernel: str, tensors, rows, outs, causal: bool) -> None:
    """One launch of ``flash_attention_<kernel>``: in bf16 its ``_bf16``
    entry, which takes byte strides and no dtype code; in f32 its FMA
    entry, element strides and the dtype code."""
    q = tensors[0]
    B, H, S, D = q.shape
    lib = _build.library(head_dims.library("flash_attention", D),
                         _SIGNATURES)
    ptrs = [t.data_ptr() for t in (*tensors, *rows, *outs)]
    fn_name = f"flash_attention_{kernel}"
    if q.dtype == torch.bfloat16:
        fn_name += "_bf16"
        tail = (*(s * q.element_size() for s in q.stride()[:3]), int(causal))
    else:
        tail = (*q.stride()[:3], int(causal), _DTYPE_CODES[q.dtype])
    rc = getattr(lib, fn_name)(*ptrs, B, H, S, D, *tail, q.device.index or 0,
                               _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: "
                           + _build.error_string(lib, rc))


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 3a: (o, lse). o has q's dtype and strides. bf16 runs the
    Hopper kernel, f32 the FMA kernel."""
    if q.device.type == "cpu":
        return _flash_fwd_reference(q, k, v, causal)
    _check("flash_fwd", (q, k, v), ())
    o = torch.empty_like(q)
    B, H, S, _D = q.shape
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _launch("fwd", (q, k, v), (), (o, lse), causal)
    _build.count_launch(flash_fwd)
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, di, causal: bool = True) -> torch.Tensor:
    """Kernel 3c: dq, in q's dtype and strides. bf16 runs the Hopper
    kernel, f32 the FMA kernel."""
    if q.device.type == "cpu":
        return _flash_bwd_dq_reference(q, k, v, do, lse, di, causal)
    _check("flash_bwd_dq", (q, k, v, do), (lse, di))
    dq = torch.empty_like(q)
    _launch("bwd_dq", (q, k, v, do), (lse, di), (dq,), causal)
    _build.count_launch(flash_bwd_dq)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, di, causal: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 3b: (dk, dv), in q's dtype and strides. bf16 runs the
    Hopper kernel, f32 the FMA kernel."""
    if q.device.type == "cpu":
        return _flash_bwd_dkv_reference(q, k, v, do, lse, di, causal)
    _check("flash_bwd_dkv", (q, k, v, do), (lse, di))
    dk = torch.empty_like(q)
    dv = torch.empty_like(q)
    _launch("bwd_dkv", (q, k, v, do), (lse, di), (dk, dv), causal)
    _build.count_launch(flash_bwd_dkv)
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0

# C signatures of csrc/flash_attention.cu's entry points: the tensor
# pointers; B, H, S, D; the (batch, head, seq) strides in elements; causal,
# dtype code, device index; stream. The bf16 entries (_bf16): strides in
# bytes and no dtype code. Each returns the launch's cudaError_t (the
# _bf16 entries also 1000 + a CUresult for a refused TMA map).
_TAIL = ([ctypes.c_int] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3
         + [ctypes.c_void_p])
_TAIL_BF16 = ([ctypes.c_int] * 4 + [ctypes.c_longlong] * 3
              + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_SIGNATURES = {
    "flash_attention_fwd": (ctypes.c_int, [ctypes.c_void_p] * 5 + _TAIL),
    "flash_attention_fwd_bf16": (ctypes.c_int,
                                 [ctypes.c_void_p] * 5 + _TAIL_BF16),
    "flash_attention_bwd_dq": (ctypes.c_int, [ctypes.c_void_p] * 7 + _TAIL),
    "flash_attention_bwd_dq_bf16": (ctypes.c_int,
                                    [ctypes.c_void_p] * 7 + _TAIL_BF16),
    "flash_attention_bwd_dkv": (ctypes.c_int,
                                [ctypes.c_void_p] * 8 + _TAIL),
    "flash_attention_bwd_dkv_bf16": (ctypes.c_int,
                                     [ctypes.c_void_p] * 8 + _TAIL_BF16),
}


# ----------------------------------------------------------------------
# the differentiable function
# ----------------------------------------------------------------------

def _strided_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """x with ref's strides (the kernels take one stride set)."""
    if x.stride() == ref.stride():
        return x
    return torch.empty_like(ref).copy_(x)


class _FlashAttention(torch.autograd.Function):
    """Forward: kernel 3a, saving (q, k, v, o, lse). Backward: di in
    PyTorch, then kernels 3c (dq) and 3b (dk, dv). The kernels launch
    through ctypes, outside PyTorch's dispatcher, so everything backward
    needs is in ``save_for_backward``; under activation checkpointing the
    forward runs again and, with no atomics in the kernel, gives the same
    bits."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.stride(-1) != 1:
            q = q.contiguous()
        k = _strided_like(k, q)
        v = _strided_like(v, q)
        o, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = _strided_like(do, q)
        di = (o.float() * do.float()).sum(-1).contiguous()
        dq = flash_bwd_dq(q, k, v, do, lse, di, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, ctx.causal)
        return dq, dk, dv, None


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """[B, H, S, D] fused attention, differentiable, scale 1/√D. On the
    CPU the same Function runs each kernel's plain version."""
    return _FlashAttention.apply(q, k, v, causal)


def flash_attention_bshk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """[B, S, H, D] layout (the model's native layout); same kernels, read
    through transposed views."""
    out = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal)
    return out.transpose(1, 2)
