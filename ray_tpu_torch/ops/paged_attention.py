"""Paged attention — the decode-time kernel for LLM serving, on Hopper.

Counterpart of ``ray_tpu/ops/paged_attention.py``. The KV cache lives in
fixed-size PAGES; each sequence owns a page list (its row of the page
table), so ragged batches share one cache and memory fragments at page
granularity.

  - ``paged_attention_reference``: the plain PyTorch version (gather over
    the page table, f32 softmax). The CPU path and the oracle the CUDA
    kernel is held against.
  - ``paged_attention_splits`` and ``merge_splits``: the CUDA kernel's two
    steps in plain PyTorch (partials per split of the logical pages, then
    their merge in a fixed order). The tests hold them against the JAX
    kernel; nothing on the main path calls them.
  - ``paged_attention``: the wrapper. A CPU tensor goes to the plain
    version; a CUDA tensor launches the hand-written kernels
    (``csrc/paged_attention.cu``) or raises. There is no silent fallback
    and no length-based path choice: on the card the kernel always runs,
    split over pages by ``split_plan``, which reads shapes only, at every
    head_dim from 1 to 256: a width runs on the library of its class
    (``head_dims.width_class``), which masks the columns past it and reads
    the cache where it lies, never a padded copy.
    ``paged_attention.launches`` counts wrapper calls that launched; one
    call launches the split kernel and, when there is more than one
    split, the merge kernel.

Layout (as the reference): K/V pages [n_pages, n_kv_heads, page_size,
head_dim]; queries are single decode tokens [B, n_heads, head_dim] with
n_heads = G * n_kv_heads, query head j reading KV head j // G. The output
is f32 [B, n_heads, head_dim]; a sequence of length 0 gives zeros (the
kernel's ``acc / max(l, 1e-30)`` with l = 0).

The page-cache writers update the pages IN PLACE (the JAX versions are
functional and rely on buffer donation for the same effect).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ray_tpu_torch.ops import head_dims

NEG_INF = -1e30

LOG2E = 1.4426950408889634

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = head_dims.PAGED_ATTENTION   # one library a width class
_MAX_GROUP = 8
_MAX_PAGES_PER_SPLIT = 32   # one lane of the kernel's first warp per page
MAX_SMEM = 232448     # shared memory one block may take on an H100
# split_plan's rule: the fewest pages per split that keep the launch under
# this many blocks, the threads of 16 blocks of 128 on each of 132 SMs.
# At the serving shape it gives 2 pages per split (2048 blocks), the
# fastest of 1, 2, 4, 8 and 16 on the card (PERF.md)
_TARGET_BLOCKS = 16 * 132
_KERNEL_DEVICE = "cuda"


# ----------------------------------------------------------------------
# plain version (PyTorch gather; CPU path and oracle)
# ----------------------------------------------------------------------

def paged_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              page_table: torch.Tensor,
                              seq_lens: torch.Tensor) -> torch.Tensor:
    """q [B,H,D]; k_pages/v_pages [P,KV,page,D]; page_table [B,MP]
    (physical page per logical page); seq_lens [B] = valid cache tokens
    per sequence. Returns [B,H,D] f32."""
    B, H, D = q.shape
    _P, KV, page, _D = k_pages.shape
    MP = page_table.shape[1]
    G = H // KV
    table = page_table.long()
    # gather each sequence's pages: [B, KV, MP*page, D]
    k = k_pages[table].permute(0, 2, 1, 3, 4).reshape(B, KV, MP * page, D)
    v = v_pages[table].permute(0, 2, 1, 3, 4).reshape(B, KV, MP * page, D)
    qg = q.reshape(B, KV, G, D).to(torch.float32)
    scores = torch.einsum("bkgd,bktd->bkgt", qg,
                          k.to(torch.float32)) / math.sqrt(D)
    pos = torch.arange(MP * page, device=q.device)
    valid = pos[None, :] < seq_lens[:, None].to(pos.dtype)      # [B,T]
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", probs, v.to(torch.float32))
    # length 0: no valid token, output 0 (as the kernel's l = 0 case)
    out = out * (seq_lens > 0).to(out.dtype)[:, None, None, None]
    return out.reshape(B, H, D)


def paged_attention_splits(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           seq_lens: torch.Tensor, pages_per_split: int):
    """The split kernel's arithmetic: split s attends over the logical
    pages [s * pps, (s + 1) * pps) of each sequence, with q scaled by
    log2(e) / sqrt(D) so that the softmax is in base 2. Returns the
    unnormalised partial o [B, H, S, D] and m, l [B, H, S] (f32; a split
    with no valid token has m = -1e30, l = 0, o = 0)."""
    B, H, D = q.shape
    _P, KV, page, _D = k_pages.shape
    MP = page_table.shape[1]
    G, pps = H // KV, pages_per_split
    S = -(-MP // pps)
    T = pps * page
    # pad the table to S * pps pages; padded positions are masked
    table = torch.zeros((B, S * pps), dtype=torch.long, device=q.device)
    table[:, :MP] = page_table.long()
    k, v = (x[table].permute(0, 2, 1, 3, 4).reshape(B, KV, S, T, D)
            .to(torch.float32) for x in (k_pages, v_pages))
    qg = q.reshape(B, KV, G, D).to(torch.float32) * (LOG2E / math.sqrt(D))
    scores = torch.einsum("bkgd,bkstd->bksgt", qg, k)
    pos = torch.arange(S * T, device=q.device).reshape(S, T)
    end = seq_lens.long().clamp(max=MP * page)
    valid = (pos[None] < end[:, None, None])[:, None, :, None, :]
    scores = scores.masked_fill(~valid, NEG_INF)
    m = scores.amax(-1)                                     # [B,KV,S,G]
    p = torch.exp2(scores - m[..., None]) * valid
    l = p.sum(-1)
    o = torch.einsum("bksgt,bkstd->bksgd", p, v)

    def heads(x):          # [B, KV, S, G, ...] -> [B, H, S, ...]
        x = x.transpose(2, 3)
        return x.reshape(B, H, S, *x.shape[4:])

    return heads(o), heads(m), heads(l)


def merge_splits(o: torch.Tensor, m: torch.Tensor,
                 l: torch.Tensor) -> torch.Tensor:
    """The merge kernel's arithmetic: each (b, head)'s splits combined in
    the fixed order s = 0 .. S - 1 with a running max (each step rescales
    the sum by exp2(m - m_new) and the split by exp2(m_s - m_new)); an
    empty split (m = -1e30, l = 0, o = 0) adds nothing. o [B, H, S, D], m
    and l [B, H, S] -> [B, H, D] f32."""
    m_run = torch.full_like(m[..., 0], NEG_INF)
    l_run = torch.zeros_like(l[..., 0])
    acc = torch.zeros_like(o[..., 0, :])
    for s in range(o.shape[2]):
        m_new = torch.maximum(m_run, m[..., s])
        alpha = torch.exp2(m_run - m_new)
        w = torch.exp2(m[..., s] - m_new)
        acc = acc * alpha[..., None] + w[..., None] * o[..., s, :]
        l_run = l_run * alpha + w * l[..., s]
        m_run = m_new
    return acc / l_run.clamp(min=1e-30)[..., None]


# ----------------------------------------------------------------------
# the wrapper: plain version on the CPU, CUDA kernel on the card
# ----------------------------------------------------------------------

def split_smem_bytes(pps: int, page: int, group: int, elt: int,
                     D: int = 128) -> int:
    """Shared memory of one split block (``split_layout`` in
    csrc/paged_attention.cu) at the true head_dim D: K and V tiles [pps,
    page, D] padded to 16 bytes (only a width that is not a multiple of 8
    pads), f32 probabilities [group, pps * page] padded to 8 bytes, 2 *
    pps mbarriers, the group's f32 m and l, the length."""
    tiles = (2 * pps * page * D * elt + 15) // 16 * 16
    probs = (group * pps * page * 4 + 7) // 8 * 8
    return tiles + probs + 2 * pps * 8 + (2 * group + 1) * 4


def split_plan(B: int, H: int, KV: int, MP: int, page: int,
               elt: int, D: int = 128) -> tuple:
    """(pages per split, splits) for a launch, from the shapes alone: the
    fewest pages per split (a power of two, or MP; at most 32) that keep
    B x KV x splits under _TARGET_BLOCKS, halved while a block would take
    more than 48 KiB of shared memory at head_dim D and this dtype (a K
    and a V tile of page x D each per page: the wider the head, the fewer
    pages a split). Never reads the lengths, which live on the device: a
    launch at given shapes is the same for every length, so it can be
    captured in a CUDA graph."""
    pps = 1
    while pps < MP and B * KV * -(-MP // pps) > _TARGET_BLOCKS:
        pps *= 2
    pps = min(pps, MP, _MAX_PAGES_PER_SPLIT)
    while pps > 1 and split_smem_bytes(pps, page, H // KV, elt,
                                       D) > 48 * 1024:
        pps //= 2
    return pps, -(-MP // pps)


def _check_kernel_args(q, k_pages, v_pages, page_table, seq_lens,
                       pages_per_split):
    """Raises on anything the kernels do not take; returns the pages per
    split (``pages_per_split``, else split_plan's)."""
    tensors = (q, k_pages, v_pages, page_table, seq_lens)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention: all tensors must be on "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged_attention: dtype {q.dtype} not supported "
                        f"(takes {list(_DTYPE_CODES)})")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_attention: q, k_pages and v_pages must "
                        "share one dtype")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged_attention: page_table and seq_lens must be "
                        "int32")
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError("paged_attention: q [B,H,D], pages [P,KV,page,D]")
    B, H, D = q.shape
    _P, KV, page, Dk = k_pages.shape
    MP = page_table.shape[1] if page_table.dim() == 2 else 0
    if Dk != D or page_table.dim() != 2 or page_table.shape[0] != B \
            or seq_lens.shape != (B,) or MP == 0 or page == 0:
        raise ValueError("paged_attention: shape mismatch: q "
                         f"{tuple(q.shape)}, pages {tuple(k_pages.shape)}, "
                         f"table {tuple(page_table.shape)}, lens "
                         f"{tuple(seq_lens.shape)}")
    head_dims.check("paged_attention", D)
    if KV == 0 or H % KV or H // KV > _MAX_GROUP:
        raise ValueError(f"paged_attention: {H} query heads over {KV} KV "
                         f"heads (group <= {_MAX_GROUP})")
    if B > 65535 or KV > 65535:
        raise ValueError(f"paged_attention: grid of {KV} KV heads x {B} "
                         "sequences (each <= 65535)")
    pps = pages_per_split
    if pps is None:
        pps = split_plan(B, H, KV, MP, page, q.element_size(), D)[0]
    if not 1 <= pps <= min(MP, _MAX_PAGES_PER_SPLIT):
        raise ValueError(f"paged_attention: {pps} pages per split (1 to "
                         f"{min(MP, _MAX_PAGES_PER_SPLIT)})")
    smem = split_smem_bytes(pps, page, H // KV, q.element_size(), D)
    if smem > MAX_SMEM:
        raise ValueError(f"paged_attention: {pps} pages per split of page "
                         f"{page} x head_dim {D} need {smem} B of shared "
                         f"memory (max {MAX_SMEM})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: tensors must be contiguous")
    # a K/V tile or q row of whole 16-byte units is one bulk copy or
    # 16-byte loads
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("paged_attention: q and the pages must be 16-byte "
                         "aligned")
    return pps


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    seq_lens: torch.Tensor,
                    pages_per_split: Optional[int] = None) -> torch.Tensor:
    """Decode attention over a paged KV cache (see module docstring).

    CPU tensors: the plain version. CUDA tensors: the hand-written
    kernels, launched on the current stream: the split kernel over
    ``split_plan``'s splits (or ``pages_per_split`` logical pages each,
    when given), then, when there is more than one split, the merge
    kernel over a workspace allocated here. Raises on anything the
    kernels do not take, before any launch, and on a failed launch."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         seq_lens)
    if q.device.type != _KERNEL_DEVICE:
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    pps = _check_kernel_args(q, k_pages, v_pages, page_table, seq_lens,
                             pages_per_split)
    from ray_tpu_torch.ops import _build

    B, H, D = q.shape
    _P, KV, page, _D = k_pages.shape
    MP = page_table.shape[1]
    S = -(-MP // pps)
    out = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    work = None if S == 1 else torch.empty(
        B * H * S * (D + 2), dtype=torch.float32, device=q.device)
    lib = _build.library(head_dims.library(
        "paged_attention", head_dims.width_class(D)), _SIGNATURES)
    rc = lib.paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(),
        B, H, KV, D, page, MP, pps, _DTYPE_CODES[q.dtype],
        q.device.index or 0, _stream(q.device))
    if rc != 0:
        raise RuntimeError("paged_attention kernel launch failed: "
                           + _build.error_string(lib, rc))
    _build.count_launch(paged_attention)
    return out


paged_attention.launches = 0


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# C signature of csrc/paged_attention.cu's entry point: q, k_pages,
# v_pages, page_table, seq_lens, out, workspace; B, H, KV, D, page, MP,
# pages per split, dtype code, device index; stream. Returns the
# cudaError_t of the first failed launch, else 0.
_SIGNATURES = {"paged_decode_attention": (
    ctypes.c_int, [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
    + [ctypes.c_void_p])}


# ----------------------------------------------------------------------
# page-cache writers (in place)
# ----------------------------------------------------------------------

def append_token_kv(k_pages: torch.Tensor, v_pages: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    page_table: torch.Tensor,
                    seq_lens: torch.Tensor) -> None:
    """Write one decode token's K/V [B,KV,D] into each sequence's tail
    slot (page_table[b, seq_len // page], seq_len % page), IN PLACE.

    An indexed store (the reference's one-hot einsum avoided scatters,
    which serialise on the TPU). A row whose logical page lies past the
    table (a budget overrun) writes nothing, as the reference drops it;
    the store keeps the old value there instead of branching on the host.
    Idle slots all share the parking page, so several rows may target
    the same (page, slot): which one lands is unspecified, and the
    parking page is don't-care, never read for a live sequence."""
    page = k_pages.shape[2]
    MP = page_table.shape[1]
    lens = seq_lens.long()
    logical = lens // page
    slot = lens % page
    inside = logical < MP
    phys = page_table.long().gather(
        1, logical.clamp(max=MP - 1)[:, None])[:, 0]
    keep = inside[:, None, None]
    k_pages[phys, :, slot] = torch.where(keep, k_new.to(k_pages.dtype),
                                         k_pages[phys, :, slot])
    v_pages[phys, :, slot] = torch.where(keep, v_new.to(v_pages.dtype),
                                         v_pages[phys, :, slot])


def write_prefill_kv(k_pages: torch.Tensor, v_pages: torch.Tensor,
                     k_seq: torch.Tensor, v_seq: torch.Tensor,
                     pages: torch.Tensor) -> None:
    """Write a prefilled sequence's K/V [S,KV,D] into its pages ([n]
    physical ids; S <= n*page_size), IN PLACE: a page-indexed copy. The
    tail page may be partly filled; its trailing slots are don't-care.
    Only the parking page may repeat in ``pages``, and what lands there
    is don't-care."""
    page = k_pages.shape[2]
    n = pages.shape[0]
    S, KV, D = k_seq.shape
    idx = pages.long()
    for src, dst in ((k_seq, k_pages), (v_seq, v_pages)):
        fill = torch.zeros((n * page, KV, D), dtype=dst.dtype,
                           device=dst.device)
        fill[:S] = src
        dst[idx] = fill.view(n, page, KV, D).transpose(1, 2)
