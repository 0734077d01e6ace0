"""Ring attention — sequence parallelism over a mesh's ``seq`` axis.

Counterpart of ``ray_tpu/ops/ring_attention.py`` (Liu et al., Ring
Attention with Blockwise Transformers, arXiv:2310.01889): the sequence is
split into n shards, shard i holds its queries Q_i and sees each KV block
(K_j, V_j) once as the blocks rotate around the ring, and an online-softmax
merge of the per-block results gives exact attention. Causality uses the
GLOBAL offsets of each block, so a block whose keys all follow its queries
contributes exact zeros.

The block step, ``block_attention``, is kernel 2: hand-written CUDA C++
(``csrc/ring_attention.cu``) in place of the reference's Pallas
``_block_kernel``. For a CPU tensor it takes its plain PyTorch version
(``_block_attention_reference``); for a CUDA tensor it launches the kernel
or raises, and counts its launches in ``block_attention.launches``. It
takes every head_dim from 1 to 256 (``ops/head_dims.py``): a width runs
on the library of its class (16, 32, 64, 128 or 256, the smallest at or
above it), which masks the columns past it. Where a row is not whole
16-byte units (a width not a multiple of 8 in bf16, of 4 in f32: TMA's
strides and the f32 loads need them) the call first copies q, k and v
zero-padded to a multiple of 8 columns, and counts it in
``block_attention.padded_calls``; no configuration of the repo makes
such a call. bf16 goes to ``ring_block_attention_bf16`` (byte
strides), the Hopper kernels (wgmma, TMA-fed tiles) at every width, with
the launch ``block_plan`` picks from the shapes: the 128-query template
where its blocks fill the card, else the split kernel (64-query blocks,
each query tile's key tiles split over a cluster of blocks and merged in
a fixed order); f32 goes to the FMA kernel (``ring_block_attention``).
The kernel has no backward, as
``pallas_call`` has no VJP in the reference: on the card the ring is
forward only, and a call that autograd would have to differentiate
raises. On the CPU the plain version is differentiable.

The reference runs the ring under ``shard_map`` on one controller that
holds every device, with ``ppermute`` moving each KV shard to the next
device. The port has both forms of mesh (parallel/mesh.py). Under a
``RankMesh`` each rank runs the reference's body, ``ring_attention``, on
its own batch, head and sequence shard, and ``send_recv`` over the seq
axis's process group moves the KV block (parallel/collectives.py). Under a
local-device ``Mesh`` one process drives every shard in lockstep: the
rotation is a move of each shard to its neighbour's device, a no-op where
the devices repeat (a ``seq=4`` mesh on one card), so one call launches the
block kernel n² times, n per device. Either way every step runs its block,
fully masked ones included, as the reference does. K and V travel
unrepeated (grouped-query attention is resolved inside the block). Layouts
follow the reference: the global entry and the body take [B, S, H, D]; a
block takes [B, H, T, D] views.
"""

from __future__ import annotations

import ctypes
import itertools
import math
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import head_dims
from ray_tpu_torch.parallel.collectives import (CollectiveGroup, send_recv,
                                                spec_axes, to_global,
                                                to_local)
from ray_tpu_torch.parallel.mesh import (AXIS_SEQ, Mesh,
                                         default_logical_rules, use_mesh)

NEG_INF = -1e30

_DTYPES = (torch.float32, torch.bfloat16)
# the bf16 launch plan (block_plan): the H100's SMs; 128-query blocks of
# the template that fill them (one resident an SM: 384 threads of up to 240
# registers); the keys x head_dim a split of the split kernel must keep to
# pay for its merge (two cluster barriers and reads of every split's share:
# on the card a 512-token shard gains from 2 splits at 256 and loses from
# any at 16-64, PERF.md section 6); its largest cluster (the portable size)
SMS = 132
FILL_BLOCKS = SMS
SPLIT_WORK = 32768
MAX_SPLITS = 8
_INT32_MAX = 2 ** 31 - 1
_TMA_MAX_STRIDE = 2 ** 40   # bytes
# the device type the kernel runs on (tests point it at "meta" to reach
# the launch with a recording library)
_KERNEL_DEVICE = "cuda"


# ----------------------------------------------------------------------
# single-block attention: (o_unnorm f32, m, l) given global offsets
# ----------------------------------------------------------------------

def _block_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, q_offset: int, k_offset: int,
                               causal: bool
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Kernel 2's function in plain ops, in f32 (the reference's
    ``_block_attention_xla``). q [B, H, Tq, D], k/v [B, Hkv, Tk, D] with
    Hkv dividing H (query head j reads KV head j // (H / Hkv)) ->
    (o [B, H, Tq, D] unnormalised, m [B, H, Tq], l [B, H, Tq]). A row with
    no visible key has o = 0, m = -1e30, l = 0."""
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        1.0 / math.sqrt(q.shape[-1]))
    if causal:
        rows = q_offset + torch.arange(q.shape[2], device=q.device)[:, None]
        cols = k_offset + torch.arange(k.shape[2], device=q.device)[None, :]
        s = s.masked_fill(rows < cols, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    # fully-masked rows: m == NEG_INF -> p would be exp(0)=1 per col; zero
    p = torch.where((m > NEG_INF / 2)[..., None], p, 0.0)
    l = p.sum(-1)
    o = torch.matmul(p, v.float())
    return o, m, l


def split_keys(head_dim: int) -> int:
    """Keys a tile of the split kernel: 128, or 64 at head_dim 256 (its
    128-register O)."""
    return 64 if head_dim > 128 else 128


def block_plan(B: int, H: int, Tq: int, Tk: int, head_dim: int) -> int:
    """The bf16 launch of kernel 2 for a block of these shapes (shapes
    only, so a ring's steps all launch alike): 0, the 128-query template,
    where head_dim is a multiple of 64 and its B * H * ceil(Tq / 128)
    blocks fill the card (FILL_BLOCKS; the 32k ring's 1024 at 128); else
    n >= 1, the split kernel with each 64-query tile's key tiles split n
    ways: as many as keep the B * H * ceil(Tq / 64) * n blocks within one
    an SM and Tk * head_dim / n at SPLIT_WORK or more, at most
    MAX_SPLITS."""
    if head_dim % 64 == 0 and B * H * -(-Tq // 128) >= FILL_BLOCKS:
        return 0
    tiles = B * H * -(-Tq // 64)
    return max(1, min(MAX_SPLITS, SMS // tiles, Tk * head_dim // SPLIT_WORK))


def split_key_tiles(q0: int, Tq: int, Tk: int, head_dim: int,
                    q_offset: int, k_offset: int, causal: bool,
                    splits: int):
    """The split kernel's key tiles for the 64-query tile at row q0, as it
    computes them: the tiles up to the last one holding a key the tile's
    last row sees, [0, kt_end), and block s of the cluster's even share,
    [s * kt_end // splits, (s + 1) * kt_end // splits). Returns [(kt0,
    kt1)] a split."""
    keys = split_keys(head_dim)
    kt_end = -(-Tk // keys)
    if causal:
        last_key = q_offset + min(q0 + 64, Tq) - 1 - k_offset
        kt_end = 0 if last_key < 0 else min(kt_end, last_key // keys + 1)
    return [(s * kt_end // splits, (s + 1) * kt_end // splits)
            for s in range(splits)]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offset: int, k_offset: int) -> None:
    """What kernel 2 takes: one CUDA device and dtype, q [B, H, Tq, D]
    and k, v [B, Hkv, Tk, D] with D from 1 to 256 and Hkv dividing H,
    and offsets that keep every position in int32 (the rows' layout:
    ``_check_rows``)."""
    if q.device.type != _KERNEL_DEVICE:
        raise ValueError(f"block_attention: no kernel for {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"block_attention: all tensors must be on "
                         f"{q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"block_attention: q, k, v must share one dtype of "
                        f"{list(_DTYPES)}, got "
                        f"{[q.dtype, k.dtype, v.dtype]}")
    if (q.dim() != 4 or k.dim() != 4 or k.shape != v.shape
            or k.shape[0] != q.shape[0] or k.shape[-1] != q.shape[-1]
            or q.shape[1] % k.shape[1]):
        raise ValueError(f"block_attention: need q [B, H, Tq, D] and k, v "
                         f"[B, Hkv, Tk, D] with Hkv dividing H, got "
                         f"{[tuple(t.shape) for t in (q, k, v)]}")
    head_dims.check("block_attention", q.shape[-1])
    if any(abs(off) + t > _INT32_MAX
           for off, t in ((q_offset, q.shape[2]), (k_offset, k.shape[2]))):
        raise ValueError("block_attention: offsets out of int32 range")


def _check_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Unit head_dim stride and 16-byte aligned rows. The bf16 entry takes
    what TMA takes at every width, where it reads through it or not: every
    (batch, head, sequence) stride must also be positive and below 2^40
    bytes."""
    vec = 16 // q.element_size()
    for t in (q, k, v):
        if (t.stride(-1) != 1 or any(s % vec for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError("block_attention: q, k and v need unit head_dim "
                             "stride and 16-byte aligned rows")
        if q.dtype == torch.bfloat16 and not all(
                0 < s * t.element_size() < _TMA_MAX_STRIDE
                for s in t.stride()[:3]):
            raise ValueError(f"block_attention: the bf16 kernel takes what "
                             f"TMA takes, (batch, head, sequence) strides "
                             f"of 16 to 2^40 bytes, got "
                             f"{t.stride()[:3]} elements")


def block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: int = 0, k_offset: int = 0,
                    causal: bool = True, splits: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One blockwise attention step (kernel 2). q [B, H, Tq, D], k/v
    [B, Hkv, Tk, D]; offsets are the GLOBAL sequence positions of the first
    row and column (host ints). Returns (o unnormalised, m, l), all f32.
    CPU tensor: the plain version (differentiable). CUDA tensor: the kernel,
    forward only; in bf16 with ``block_plan``'s launch, or ``splits`` (0 or
    1 to MAX_SPLITS, as block_plan returns) in its place, both at the
    width class's tiles."""
    if q.device.type == "cpu":
        return _block_attention_reference(q, k, v, q_offset, k_offset, causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "block_attention: kernel 2 has no backward, so the ring is "
            "forward only on the card, as the reference's Pallas block is "
            "on its chip (ROADMAP.md, Queue C); call it under "
            "torch.no_grad()")
    q_offset, k_offset = int(q_offset), int(k_offset)
    _check(q, k, v, q_offset, k_offset)
    from ray_tpu_torch.ops import _build

    B, H, Tq, D = q.shape
    width = head_dims.width_class(D, "block_attention")
    if D % (16 // q.element_size()):
        # rows of whole 16-byte units: the kernel reads the padded copies'
        # zeros past D and still takes D as the width
        q, k, v = (torch.nn.functional.pad(t, (0, -D % 8))
                   for t in (q, k, v))
        _build.count_launch(block_attention, "padded_calls")
    _check_rows(q, k, v)
    Hkv, Tk = k.shape[1], k.shape[2]
    o = torch.empty((B, H, Tq, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    lib = _build.library(head_dims.library("ring_attention", width),
                         _SIGNATURES)
    if q.dtype == torch.bfloat16:
        # byte strides (the unit of the Hopper kernel's TMA maps), then
        # the launch plan
        fn = lib.ring_block_attention_bf16
        strides = [s * t.element_size() for t in (q, k, v)
                   for s in t.stride()[:3]]
        if splits is None:
            splits = block_plan(B, H, Tq, Tk, width)
        elif not (0 <= splits <= MAX_SPLITS and (splits or width % 64 == 0)):
            raise ValueError(f"block_attention: splits {splits} is not a "
                             f"launch of head_dim {D} (0 at a width class "
                             f"that is a multiple of 64, or 1 to "
                             f"{MAX_SPLITS})")
        tail = (int(causal), splits)
    else:
        fn = lib.ring_block_attention
        strides = [s for t in (q, k, v) for s in t.stride()[:3]]
        tail = (int(causal),)
    rc = fn(*(t.data_ptr() for t in (q, k, v, o, m, l)), B, H, Hkv, Tq, Tk,
            D, q_offset, k_offset, *strides, *tail,
            q.device.index or 0, _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: "
                           + _build.error_string(lib, rc))
    _build.count_launch(block_attention)
    return o, m, l


block_attention.launches = 0
block_attention.padded_calls = 0


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# C signatures of csrc/ring_attention.cu's entry points: q, k, v, o, m, l;
# B, H, Hkv, Tq, Tk, D, q_offset, k_offset; the (batch, head, seq) strides
# of q, k and v (elements for f32, bytes for bf16); causal, and for bf16
# the launch plan's splits; device index; stream.
_BLOCK_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
               + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2
               + [ctypes.c_void_p])
_SIGNATURES = {
    "ring_block_attention": (ctypes.c_int, _BLOCK_ARGS),
    "ring_block_attention_bf16": (ctypes.c_int, _BLOCK_ARGS[:-2]
                                  + [ctypes.c_int] + _BLOCK_ARGS[-2:]),
}


# ----------------------------------------------------------------------
# the ring
# ----------------------------------------------------------------------

def _merge(acc, m, l, o_b, m_b, l_b):
    m_new = torch.maximum(m, m_b)
    # guard exp(-inf - -inf): fully-masked contributions scale to zero
    a1 = torch.where(m > NEG_INF / 2, torch.exp(m - m_new), 0.0)
    a2 = torch.where(m_b > NEG_INF / 2, torch.exp(m_b - m_new), 0.0)
    acc = acc * a1[..., None] + o_b * a2[..., None]
    l = l * a1 + l_b * a2
    return acc, m_new, l


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str = AXIS_SEQ, causal: bool = True
                   ) -> torch.Tensor:
    """The reference's per-rank body, which every rank of ``axis_name``'s
    group of the current mesh (a ``RankMesh``) runs on its own shard:
    q [B, S_local, H, D], k/v [B, S_local, Hkv, D], shard i holding the
    global positions [i * S_local, (i + 1) * S_local). At step t the rank
    holds the KV block of rank (i - t) mod n, runs ``block_attention`` on it
    (kernel 2 on the card), merges, and passes the block on to the next
    rank with ``send_recv``; K and V travel unrepeated. Returns [B, S_local,
    H, D] in q's dtype."""
    group = CollectiveGroup(axis_name)
    n, idx = group.world_size(), group.rank()
    B, s_loc, H, D = q.shape
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    acc = torch.zeros((B, H, s_loc, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, s_loc), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, s_loc), dtype=torch.float32, device=q.device)
    for t in range(n):
        o_b, m_b, l_b = block_attention(
            qt, kt, vt, q_offset=idx * s_loc,
            k_offset=(idx - t) % n * s_loc, causal=causal)
        acc, m, l = _merge(acc, m, l, o_b, m_b, l_b)
        if t + 1 < n:
            # receive the next block from the left neighbour
            kt = send_recv(kt, axis_name, 1)
            vt = send_recv(vt, axis_name, 1)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _specs(rules) -> Tuple[tuple, tuple]:
    """q's and k/v's mesh-axis specs from the logical rules, as the
    reference derives them (``batch``, ``act_seq``, ``heads`` /
    ``kv_heads``, ``head_dim``)."""
    table = dict(rules if rules is not None else default_logical_rules())
    return (tuple(table.get(ax) for ax in
                  ("batch", "act_seq", "heads", "head_dim")),
            tuple(table.get(ax) for ax in
                  ("batch", "act_seq", "kv_heads", "head_dim")))


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mesh, axis_name: str = AXIS_SEQ,
                           causal: bool = True, rules=None) -> torch.Tensor:
    """Global entry: q [B, S, H, D], k/v [B, S, Hkv, D] -> [B, S, H, D] in
    q's dtype. The shards follow the logical rules (default
    ``default_logical_rules``): batch over (data, fsdp), the sequence over
    ``axis_name``, heads and KV heads over tensor.

    Under a ``RankMesh`` every rank calls it with the same global tensors,
    runs ``ring_attention`` on its batch, head and sequence shard, and gets
    the global result (differentiable on the CPU; on the card kernel 2 has
    no backward). Under a local-device ``Mesh`` one process drives every
    ring in lockstep: shard i of a ring on the i-th device along the axis,
    the rotation a move to the neighbour's device (a no-op where the
    devices repeat), so one call launches the block kernel n² times a
    ring."""
    q_spec, kv_spec = _specs(rules)
    if mesh.spans_ranks:
        with use_mesh(mesh):
            out = ring_attention(to_local(q, q_spec, mesh),
                                 to_local(k, kv_spec, mesh),
                                 to_local(v, kv_spec, mesh),
                                 axis_name, causal)
            return to_global(out, q_spec, mesh)
    return _ring_local(q, k, v, mesh, axis_name, causal, q_spec, kv_spec)


def _ring_local(q, k, v, mesh: Mesh, axis_name, causal, q_spec, kv_spec):
    """The in-process ring over a local-device mesh: one ring for each
    block of the batch and head axes the specs split."""
    sizes = mesh.shape
    if q_spec[1] != axis_name or kv_spec[1] != axis_name:
        raise ValueError(f"ring_attention_sharded: the rules put the "
                         f"sequence on {q_spec[1]!r}, the ring runs over "
                         f"{axis_name!r}")
    n = sizes[axis_name]
    S = q.shape[1]
    if S % n:
        raise ValueError(f"ring_attention_sharded: sequence {S} does not "
                         f"split into {n} seq shards")
    devices = list(mesh.devices.reshape(-1))
    # a CUDA tensor under a CPU mesh would run its blocks on the host's
    # plain version: the ring's devices must be of the tensors' kind
    kinds = {t.device.type for t in (q, k, v)} | {d.type for d in devices}
    if len(kinds) > 1:
        raise ValueError(
            f"ring_attention_sharded: q, k, v on {q.device}, {k.device}, "
            f"{v.device} under a mesh of {sorted({str(d) for d in devices})}; "
            "the mesh's devices must be of the tensors' kind")
    def blocks(dim):
        """The blocks of tensor dimension ``dim``, major axis first: each
        block's coordinates on the axes that split it, its index and the
        number of blocks."""
        axes = spec_axes(q_spec[dim])
        if axes != spec_axes(kv_spec[dim]):
            raise ValueError(f"ring_attention_sharded: q and k/v split "
                             f"dimension {dim} differently")
        grid = list(itertools.product(*(range(sizes[a]) for a in axes)))
        return [(dict(zip(axes, c)), i, len(grid)) for i, c in enumerate(grid)]

    def cut(x, dim, i, parts):
        if x.shape[dim] % parts:
            raise ValueError(f"ring_attention_sharded: dimension {dim} of "
                             f"{tuple(x.shape)} does not split into {parts}")
        size = x.shape[dim] // parts
        return x.narrow(dim, i * size, size)

    rows = []
    for b_coords, bi, bparts in blocks(0):
        heads = []
        for h_coords, hi, hparts in blocks(2):
            coords = {**b_coords, **h_coords}
            ring = list(mesh.devices[tuple(
                slice(None) if a == axis_name else coords.get(a, 0)
                for a in mesh.axis_names)])
            qb, kb, vb = (cut(cut(x, 0, bi, bparts), 2, hi, hparts)
                          for x in (q, k, v))
            heads.append(_ring_over(qb, kb, vb, ring, causal, q))
        rows.append(torch.cat(heads, dim=2))
    return torch.cat(rows, dim=0)


def _ring_over(q, k, v, devices, causal, like) -> torch.Tensor:
    """One in-process ring: shard i of the sequence on ``devices[i]``."""
    n = len(devices)
    B, S, H, D = q.shape
    s_loc = S // n

    def shard(x, i):
        """Shard i as a [B, heads, s_loc, D] view on its device."""
        x = x[:, i * s_loc:(i + 1) * s_loc]
        if x.stride(-1) != 1:
            x = x.contiguous()
        return x.transpose(1, 2).to(devices[i])

    qs = [shard(q, i) for i in range(n)]
    ks = [shard(k, i) for i in range(n)]
    vs = [shard(v, i) for i in range(n)]
    acc = [torch.zeros((B, H, s_loc, D), dtype=torch.float32, device=d)
           for d in devices]
    m = [torch.full((B, H, s_loc), NEG_INF, dtype=torch.float32, device=d)
         for d in devices]
    l = [torch.zeros((B, H, s_loc), dtype=torch.float32, device=d)
         for d in devices]
    for t in range(n):
        for i in range(n):
            o_b, m_b, l_b = block_attention(
                qs[i], ks[i], vs[i], q_offset=i * s_loc,
                k_offset=(i - t) % n * s_loc, causal=causal)
            acc[i], m[i], l[i] = _merge(acc[i], m[i], l[i], o_b, m_b, l_b)
        if t + 1 < n:
            # rotate: shard i receives the block its left neighbour held
            ks = [ks[i - 1].to(devices[i]) for i in range(n)]
            vs = [vs[i - 1].to(devices[i]) for i in range(n)]
    out = [(acc[i] / torch.clamp(l[i], min=1e-30)[..., None])
           .transpose(1, 2).to(like.device, like.dtype) for i in range(n)]
    return torch.cat(out, dim=1)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Plain single-device attention (the parity oracle). [B, S, H, D],
    equal query and KV heads; f32 scores and softmax, in q's dtype."""
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * (
        1.0 / math.sqrt(q.shape[-1]))
    if causal:
        sq = q.shape[1]
        keep = torch.ones((sq, sq), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhst,bthd->bshd", p, v.float())
    return o.to(q.dtype)
