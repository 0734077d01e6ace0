"""Paged attention — the decode-time kernel for LLM serving, on Hopper.

Counterpart of ``ray_tpu/ops/paged_attention.py``. The KV cache lives in
fixed-size PAGES; each sequence owns a page list (its row of the page
table), so ragged batches share one cache and memory fragments at page
granularity.

  - ``paged_attention_reference``: the plain PyTorch version (gather over
    the page table, f32 softmax). The CPU path and the oracle the CUDA
    kernel is held against.
  - ``paged_attention``: the wrapper. A CPU tensor goes to the plain
    version; a CUDA tensor launches the hand-written kernel
    (``csrc/paged_attention.cu``) or raises. There is no silent fallback
    and no length-based path choice: on the card the kernel always runs.
    ``paged_attention.launches`` counts kernel launches.

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

import torch

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (128,)   # the serving model's; the kernel is built for it
_MAX_GROUP = 8
_STATIC_SMEM = 48 * 1024


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


# ----------------------------------------------------------------------
# the wrapper: plain version on the CPU, CUDA kernel on the card
# ----------------------------------------------------------------------

def _check_kernel_args(q, k_pages, v_pages, page_table, seq_lens):
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
    if Dk != D or page_table.dim() != 2 or page_table.shape[0] != B \
            or seq_lens.shape != (B,):
        raise ValueError("paged_attention: shape mismatch: q "
                         f"{tuple(q.shape)}, pages {tuple(k_pages.shape)}, "
                         f"table {tuple(page_table.shape)}, lens "
                         f"{tuple(seq_lens.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged_attention: head_dim {D} not in "
                         f"{_HEAD_DIMS}")
    if H % KV or H // KV > _MAX_GROUP:
        raise ValueError(f"paged_attention: {H} query heads over {KV} KV "
                         f"heads (group <= {_MAX_GROUP})")
    smem = 2 * page * D * q.element_size() + (H // KV) * page * 4
    if smem > _STATIC_SMEM:
        raise ValueError(f"paged_attention: page {page} x head_dim {D} "
                         f"needs {smem} B of shared memory (max "
                         f"{_STATIC_SMEM})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: tensors must be contiguous")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    seq_lens: torch.Tensor) -> torch.Tensor:
    """Decode attention over a paged KV cache (see module docstring).

    CPU tensors: the plain version. CUDA tensors: the hand-written kernel,
    launched on the current stream; raises on anything the kernel does
    not take, and on a failed launch."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         seq_lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    _check_kernel_args(q, k_pages, v_pages, page_table, seq_lens)
    from ray_tpu_torch.ops import _build

    B, H, D = q.shape
    _P, KV, page, _D = k_pages.shape
    MP = page_table.shape[1]
    out = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    lib = _build.library("paged_attention", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        B, H, KV, D, page, MP, _DTYPE_CODES[q.dtype], q.device.index or 0,
        stream)
    if rc != 0:
        raise RuntimeError("paged_attention kernel launch failed: "
                           + _build.error_string(lib, rc))
    paged_attention.launches += 1
    return out


paged_attention.launches = 0

# C signature of csrc/paged_attention.cu's entry point: q, k_pages,
# v_pages, page_table, seq_lens, out; B, H, KV, D, page, MP, dtype code,
# device index; stream. Returns the cudaError_t of the launch.
_SIGNATURES = {"paged_decode_attention": (
    ctypes.c_int, [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
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
