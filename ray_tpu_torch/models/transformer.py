"""Flagship model: decoder-only transformer (LLaMA-family shape), in PyTorch.

Counterpart of ``ray_tpu/models/transformer.py``: GQA attention with
RoPE over interleaved pairs, RMSNorm in f32, SwiGLU MLP, LM head tied to
the embedding. Parameters are kept in ``param_dtype`` (f32) and cast to
the compute ``dtype`` where they are used, as the flax module does.

Parameters travel as a flat ``dict[str, Tensor]`` whose keys are the flax
tree's paths joined by "/" (``layer_0/Attention_0/wq``) and whose layouts
are flax's (``wq [d_model, heads, head_dim]``, ``wo [heads, head_dim,
d_model]``), so a JAX checkpoint loads through numpy unchanged
(``params_from_jax``) and the functional serving forward
(models/inference.py) reads the same keys.

Attention takes the fused flash kernels (ops/flash.py, hand-written CUDA,
forward and backward) for a causal call on a CUDA tensor with head_dim a
multiple of 128 and no mesh with an axis larger than 1 (the reference's
rule), and the einsum path otherwise (always on the CPU, as the reference
takes it off the TPU). With ``ring_attention`` and a current mesh
(parallel/mesh.py) whose ``seq`` axis is larger than 1, attention takes the
ring instead (ops/ring_attention.py, kernel 2 on the card, forward only
there), over a local-device mesh in one process or across ranks; every
rank of a rank mesh holds the whole sequence outside attention, so
positions stay the global ``arange(S)``. ``remat`` checkpoints each block,
fully or saving only matrix-product outputs ("dots"). With ``moe`` each
block's MLP is the Switch-routed expert layer ``MoEMLP_0`` (ops/moe.py;
expert-parallel under a mesh whose ``expert`` axis is larger than 1); its
load-balancing aux term comes back through the block's outputs, so a block
recomputed under remat gives it once. ``param_axes`` gives each
parameter's logical axes, as the reference's ``param_with_axes`` does, for
the sharded layouts of models/train_step.py. Parameters are trainable; the
serving engine reads them under ``torch.no_grad()`` (dense models only).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch.ops.flash import flash_attention_bshk
from ray_tpu_torch.ops.moe import moe_ffn_reference, moe_ffn_sharded
from ray_tpu_torch.ops.ring_attention import ring_attention_sharded
from ray_tpu_torch.parallel.mesh import (AXIS_EXPERT, AXIS_SEQ, Mesh,
                                         current_mesh, data_local,
                                         data_local_axes, use_mesh)


def resolve_device(device, who: str) -> torch.device:
    """``None`` means the current CUDA device, and raises without one: the
    port's entry points run on the card unless the caller names a device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who} runs on a CUDA device and none is available; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    d_ff: int = 1408
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    remat_policy: str = "full"   # "full" | "dots"
    ring_attention: bool = False
    moe: bool = False
    moe_num_experts: int = 8
    moe_capacity_factor: float = 1.25
    flash_attention: str = "auto"   # "auto" | "off"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def tiny() -> "TransformerConfig":
        return TransformerConfig(vocab_size=256, d_model=64, n_layers=2,
                                 n_heads=4, n_kv_heads=2, d_ff=128,
                                 max_seq_len=128)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """Rotary embedding over the last dim of [..., seq, heads, head_dim].

    Rotates INTERLEAVED pairs (x[..., 0::2], x[..., 1::2]) as the
    reference does, not the half-split layout; computes in f32 and casts
    back to x's dtype."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    angles = positions[..., None].to(torch.float32) * freqs  # [.., S, hd/2]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    out = torch.stack([rx1, rx2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def _rms_norm(x: torch.Tensor, scale: torch.Tensor,
              eps: float) -> torch.Tensor:
    """RMSNorm in f32, cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _flash_supported(x: torch.Tensor, head_dim: int) -> bool:
    """The fused kernels cover the SINGLE-DEVICE causal path on the card:
    a CUDA tensor, a lane-aligned head_dim, and no mesh with an axis larger
    than 1 active, as the reference's TPU rule
    (``ray_tpu/models/transformer.py:80-94``): under such a mesh attention
    takes the einsum path, or the ring (decided first). The kernels are
    built for the multiples of 128 up to 256 (``ops.head_dims.FLASH``:
    every width the repo's configurations reach through this rule); a
    wider one raises in the kernel's wrapper."""
    if x.device.type != "cuda" or head_dim % 128 != 0:
        return False
    mesh = current_mesh()
    return mesh is None or all(v <= 1 for v in mesh.shape.values())


def _ring_mesh(cfg: TransformerConfig, mask) -> Optional[Mesh]:
    """The current mesh when attention takes the ring: ``ring_attention``
    on, no explicit mask (the ring is causal only, so a mask takes the
    standard path rather than being ignored) and a seq axis larger than 1,
    as the reference decides (``ray_tpu/models/transformer.py:157-166``)."""
    if not cfg.ring_attention or mask is not None:
        return None
    mesh = current_mesh()
    if mesh is None or mesh.shape.get(AXIS_SEQ, 1) <= 1:
        return None
    return mesh


def _param(shape, cfg: TransformerConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype,
                                    device=device))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=param_dtype,
                                             device=device))

    def forward(self, x):
        return _rms_norm(x, self.scale, self.eps)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.wq = _param((cfg.d_model, cfg.n_heads, hd), cfg, device)
        self.wk = _param((cfg.d_model, cfg.n_kv_heads, hd), cfg, device)
        self.wv = _param((cfg.d_model, cfg.n_kv_heads, hd), cfg, device)
        self.wo = _param((cfg.n_heads, hd, cfg.d_model), cfg, device)

    def forward(self, x, positions, mask=None):
        cfg = self.cfg
        hd = cfg.head_dim
        q = torch.einsum("bsd,dhk->bshk", x, self.wq.to(cfg.dtype))
        k = torch.einsum("bsd,dhk->bshk", x, self.wk.to(cfg.dtype))
        v = torch.einsum("bsd,dhk->bshk", x, self.wv.to(cfg.dtype))
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        ring_mesh = _ring_mesh(cfg, mask)
        if ring_mesh is not None:
            # sequence parallelism: blockwise ring attention with the KV
            # heads UNREPEATED on the ring (the block resolves GQA)
            return self._project_out(ring_attention_sharded(
                q, k, v, ring_mesh, causal=True))
        # GQA: repeat kv heads up to query heads (jnp.repeat order: head j
        # reads KV head j // rep); autograd sums dk/dv over each group
        rep = cfg.n_heads // cfg.n_kv_heads
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
        if (mask is None and cfg.flash_attention != "off"
                and _flash_supported(x, hd)):
            out = flash_attention_bshk(q, k, v, causal=True)
        else:
            if mask is None:
                s = x.shape[1]
                mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                             device=x.device))[None, None]
            scores = torch.einsum("bshk,bthk->bhst", q, k) / math.sqrt(hd)
            scores = scores.to(torch.float32).masked_fill(~mask, -1e30)
            probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
            out = torch.einsum("bhst,bthk->bshk", probs, v)
        return self._project_out(out)

    def _project_out(self, out):
        return torch.einsum("bshk,hkd->bsd", out, self.wo.to(self.cfg.dtype))


class MLP(nn.Module):
    """SwiGLU."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.w_gate = _param((cfg.d_model, cfg.d_ff), cfg, device)
        self.w_up = _param((cfg.d_model, cfg.d_ff), cfg, device)
        self.w_down = _param((cfg.d_ff, cfg.d_model), cfg, device)

    def forward(self, x):
        dt = self.cfg.dtype
        h = F.silu(x @ self.w_gate.to(dt)) * (x @ self.w_up.to(dt))
        return h @ self.w_down.to(dt)


class MoEMLP(nn.Module):
    """Switch-routed expert MLP (reference ``MoEMLP``): top-1 capacity
    routing and the expert FFNs through ``moe_ffn_reference``, or, under a
    mesh whose ``expert`` axis is larger than 1, through ``moe_ffn_sharded``
    (token rows padded to a multiple of the axis; the padding routes and is
    sliced off). Returns (y in the compute dtype, the aux load-balancing
    term, f32)."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        E, D, Fd = cfg.moe_num_experts, cfg.d_model, cfg.d_ff
        self.router = _param((D, E), cfg, device)
        self.w_in = _param((E, D, Fd), cfg, device)
        self.w_out = _param((E, Fd, D), cfg, device)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        b, s, d = x.shape
        dt = cfg.dtype
        tokens = x.reshape(b * s, d).to(dt)
        weights = (self.router.to(dt), self.w_in.to(dt), self.w_out.to(dt))
        mesh = current_mesh()
        if mesh is not None and mesh.shape.get(AXIS_EXPERT, 1) > 1:
            t = tokens.shape[0]
            pad = (-t) % mesh.shape[AXIS_EXPERT]
            if pad:
                tokens = torch.cat([tokens, tokens.new_zeros((pad, d))])
            y, aux = moe_ffn_sharded(tokens, *weights, mesh,
                                     cfg.moe_capacity_factor)
            y = y[:t]
        else:
            y, aux = moe_ffn_reference(tokens, *weights,
                                       cfg.moe_capacity_factor)
        return y.reshape(b, s, d).to(dt), aux


class Block(nn.Module):
    """Returns (x, aux): aux is the MoE layer's load-balancing term, None
    for a dense block."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.RMSNorm_0 = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.param_dtype,
                                 device)
        self.Attention_0 = Attention(cfg, device)
        self.RMSNorm_1 = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.param_dtype,
                                 device)
        if cfg.moe:
            self.MoEMLP_0 = MoEMLP(cfg, device)
        else:
            self.MLP_0 = MLP(cfg, device)

    def forward(self, x, positions, mask=None):
        x = x + self.Attention_0(self.RMSNorm_0(x), positions, mask)
        h = self.RMSNorm_1(x)
        if hasattr(self, "MoEMLP_0"):
            y, aux = self.MoEMLP_0(h)
            return x + y, aux
        return x + self.MLP_0(h), None


class Transformer(nn.Module):
    """Causal LM: tokens [B, S] int -> logits [B, S, V] in the compute dtype.

    Submodule names mirror the flax tree (``layer_{i}.Attention_0.wq``),
    so ``load_params`` takes the flat "/"-keyed dict directly. The
    parameters are allocated uninitialised on ``device`` (default: the
    current CUDA device; raises without one): load them."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        device = resolve_device(device, "Transformer")
        self.cfg = cfg
        self.embedding = _param((cfg.vocab_size, cfg.d_model), cfg, device)
        for i in range(cfg.n_layers):
            setattr(self, f"layer_{i}", Block(cfg, device))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps,
                                  cfg.param_dtype, device)

    def load_params(self, params: Mapping[str, torch.Tensor]) -> "Transformer":
        state = {k.replace("/", "."): v for k, v in params.items()}
        self.load_state_dict(state, strict=True)
        return self

    def forward(self, tokens: torch.Tensor, return_aux: bool = False):
        """logits; with ``return_aux``, (logits, the MoE layers' aux terms
        in layer order, empty for a dense model), what the reference's
        ``mutable=["intermediates"]`` gives its loss."""
        cfg = self.cfg
        embed = self.embedding.to(cfg.dtype)
        x = embed[tokens]
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        remat = cfg.remat and torch.is_grad_enabled()
        if remat:
            remat_kwargs = _remat_kwargs(cfg.remat_policy)
        aux_terms: List[torch.Tensor] = []
        for i in range(cfg.n_layers):
            block = getattr(self, f"layer_{i}")
            if remat:
                # aux is one of the checkpoint's outputs: the recompute in
                # backward rebuilds it without adding a second term
                x, aux = checkpoint(block, x, positions, use_reentrant=False,
                                    **remat_kwargs)
            else:
                x, aux = block(x, positions)
            if aux is not None:
                aux_terms.append(aux)
        x = self.final_norm(x)
        # logits stay in the compute dtype; the loss casts inside its
        # reductions (cross_entropy_loss)
        logits = torch.einsum("bsd,vd->bsv", x, embed)
        return (logits, aux_terms) if return_aux else logits


# "dots" saves the outputs of matrix products and recomputes the rest, as
# jax.checkpoint_policies.dots_with_no_batch_dims_saveable does for the
# reference; "full" recomputes the whole block
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_kwargs(policy: str) -> dict:
    """checkpoint's arguments for ``policy``. The recompute runs in
    backward, on autograd's thread for a card, which does not see this
    context's mesh: its context re-enters the forward's mesh and
    data-local axes, so a block recomputes the path it ran."""
    mesh, local = current_mesh(), data_local_axes()

    @contextlib.contextmanager
    def under_forward_mesh(recompute):
        with contextlib.ExitStack() as stack:
            if mesh is not None:
                stack.enter_context(use_mesh(mesh))
            stack.enter_context(data_local(local))
            stack.enter_context(recompute)
            yield

    def context_fn():
        if policy == "dots":
            fwd, recompute = create_selective_checkpoint_contexts(
                _dots_policy)
        else:
            fwd, recompute = contextlib.nullcontext(), contextlib.nullcontext()
        return fwd, under_forward_mesh(recompute)

    if policy not in ("full", "dots"):
        raise ValueError(f"remat_policy {policy!r}: 'full' or 'dots'")
    return {"context_fn": context_fn}


class _TokenNLL(torch.autograd.Function):
    """Per-token ``logsumexp(logits) - logits[target]`` in f32, without an
    f32 copy of the [B, S, V] logits: the cast happens inside row chunks of
    the reduction, forward and backward, which keeps only the logits (in
    their own dtype) and the f32 lse."""

    @staticmethod
    def forward(ctx, logits, targets):
        flat = logits.reshape(-1, logits.shape[-1])
        lse = torch.empty(flat.shape[0], dtype=torch.float32,
                          device=logits.device)
        step = _chunk_rows(flat)
        for i in range(0, flat.shape[0], step):
            lse[i:i + step] = torch.logsumexp(flat[i:i + step].float(),
                                              dim=-1)
        lse = lse.view(targets.shape)
        picked = logits.gather(-1, targets[..., None])[..., 0].float()
        ctx.save_for_backward(logits, targets, lse)
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        logits, targets, lse = ctx.saved_tensors
        flat = logits.reshape(-1, logits.shape[-1])
        lse, g = lse.reshape(-1), g.reshape(-1).float()
        tgt = targets.reshape(-1, 1)
        grad = torch.empty_like(flat)
        step = _chunk_rows(flat)
        for i in range(0, flat.shape[0], step):
            j = i + step
            p = torch.exp(flat[i:j].float() - lse[i:j, None])
            p.scatter_add_(1, tgt[i:j], torch.full_like(
                tgt[i:j], -1, dtype=p.dtype))
            grad[i:j] = (p * g[i:j, None]).to(grad.dtype)
        return grad.view_as(logits), None


def _chunk_rows(flat: torch.Tensor) -> int:
    """Rows per chunk: about 256 MiB of f32."""
    return max(1, (64 << 20) // flat.shape[-1])


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy. logits [B, S, V] (any float dtype),
    targets [B, S] int. logsumexp formulation, nll = lse(logits) -
    logits[target], reduced in f32 (reference ``transformer.py:318-333``);
    with ``mask``, the mean over the masked tokens."""
    nll = _TokenNLL.apply(logits, targets.long())
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


# ----------------------------------------------------------------------
# parameters: from a flax tree, or a seeded random init
# ----------------------------------------------------------------------

def params_from_jax(tree: Mapping[str, Any],
                    device=None) -> Dict[str, torch.Tensor]:
    """Flax param tree (nested dicts of numpy arrays, optionally under a
    ``{"params": ...}`` wrapper) -> flat ``{"a/b/c": Tensor}`` on
    ``device`` (default CPU). Keys and layouts are flax's; values are
    f32, like the tree's ``param_dtype``."""
    if "params" in tree and "embedding" not in tree:
        tree = tree["params"]
    flat: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, val in node.items():
            path = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(val, Mapping):
                walk(val, path)
            else:
                arr = np.asarray(val, dtype=np.float32)
                flat[path] = torch.from_numpy(arr.copy()).to(device or "cpu")

    walk(tree, "")
    return flat


def _truncated_normal(shape, std: float, generator: torch.Generator,
                      device) -> torch.Tensor:
    """flax's ``lecun_normal``/``variance_scaling`` draw: a standard normal
    truncated to [-2, 2], scaled so the TRUNCATED std is ``std``
    (inverse-CDF sampling, as ``jax.random.truncated_normal``)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    u = lo + (1.0 - 2.0 * lo) * u
    z = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    z = z.clamp_(-2.0, 2.0)
    # std of a unit normal truncated to [-2, 2]
    return (z * (std / 0.87962566103423978)).to(device)


def _lecun_fan_in(shape) -> int:
    """fan_in of flax's variance_scaling (in_axis=-2, out_axis=-1)."""
    receptive = int(np.prod(shape)) // (shape[-2] * shape[-1])
    return shape[-2] * receptive


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Dict[str, torch.Tensor]:
    """Random parameters at the flax initialisers' scales: embedding
    normal(0.02), weights lecun_normal (an expert stack [E, D, F] takes
    fan-in D·E, as flax's variance_scaling does), norm scales ones. Drawn
    from ``generator`` on its own device, returned in f32 on ``device``
    (default: the generator's device). Not bit-equal to flax's draw;
    parity tests load flax's params through ``params_from_jax``."""
    return dict(draw_params(cfg, generator, device))


def draw_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Iterator[Tuple[str, torch.Tensor]]:
    """``init_params``'s draws one parameter at a time, (name, tensor), in
    its order: a sharded init keeps its shard of each and drops the rest
    before the next."""
    device = device or generator.device
    hd = cfg.head_dim
    D, H, KV, Fd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

    def lecun(shape):
        return _truncated_normal(shape, 1.0 / math.sqrt(_lecun_fan_in(shape)),
                                 generator, device)

    emb = torch.randn((cfg.vocab_size, D), generator=generator,
                      device=generator.device, dtype=torch.float32) * 0.02
    yield "embedding", emb.to(device)
    for i in range(cfg.n_layers):
        pre = f"layer_{i}"
        yield f"{pre}/RMSNorm_0/scale", torch.ones(D, device=device)
        yield f"{pre}/Attention_0/wq", lecun((D, H, hd))
        yield f"{pre}/Attention_0/wk", lecun((D, KV, hd))
        yield f"{pre}/Attention_0/wv", lecun((D, KV, hd))
        yield f"{pre}/Attention_0/wo", lecun((H, hd, D))
        yield f"{pre}/RMSNorm_1/scale", torch.ones(D, device=device)
        if cfg.moe:
            E = cfg.moe_num_experts
            yield f"{pre}/MoEMLP_0/router", lecun((D, E))
            yield f"{pre}/MoEMLP_0/w_in", lecun((E, D, Fd))
            yield f"{pre}/MoEMLP_0/w_out", lecun((E, Fd, D))
        else:
            yield f"{pre}/MLP_0/w_gate", lecun((D, Fd))
            yield f"{pre}/MLP_0/w_up", lecun((D, Fd))
            yield f"{pre}/MLP_0/w_down", lecun((Fd, D))
    yield "final_norm/scale", torch.ones(D, device=device)


def param_axes(cfg: TransformerConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """Each parameter's LOGICAL axes, by its flat name, as the reference's
    ``param_with_axes`` calls give them (``ray_tpu/models/transformer.py:
    118-293``); parallel/mesh.py's rules map them onto mesh axes."""
    axes: Dict[str, Tuple[Optional[str], ...]] = {
        "embedding": ("vocab", "embed")}
    for i in range(cfg.n_layers):
        pre = f"layer_{i}"
        axes[f"{pre}/RMSNorm_0/scale"] = ("act_embed",)
        axes[f"{pre}/Attention_0/wq"] = ("embed", "heads", "head_dim")
        axes[f"{pre}/Attention_0/wk"] = ("embed", "kv_heads", "head_dim")
        axes[f"{pre}/Attention_0/wv"] = ("embed", "kv_heads", "head_dim")
        axes[f"{pre}/Attention_0/wo"] = ("heads", "head_dim", "embed")
        axes[f"{pre}/RMSNorm_1/scale"] = ("act_embed",)
        if cfg.moe:
            axes[f"{pre}/MoEMLP_0/router"] = ("embed", "experts")
            axes[f"{pre}/MoEMLP_0/w_in"] = ("experts", "embed", "mlp")
            axes[f"{pre}/MoEMLP_0/w_out"] = ("experts", "mlp", "embed")
        else:
            axes[f"{pre}/MLP_0/w_gate"] = ("embed", "mlp")
            axes[f"{pre}/MLP_0/w_up"] = ("embed", "mlp")
            axes[f"{pre}/MLP_0/w_down"] = ("mlp", "embed")
    axes["final_norm/scale"] = ("act_embed",)
    return axes


def param_count(params: Mapping[str, torch.Tensor]) -> int:
    return int(sum(t.numel() for t in params.values()))


def model_from_params(cfg: TransformerConfig,
                      params: Mapping[str, torch.Tensor],
                      device: Optional[torch.device] = None) -> Transformer:
    """A ``Transformer`` on ``device`` holding a copy of ``params``.
    ``None`` means the current CUDA device, as for ``Transformer(cfg)``,
    wherever ``params`` lie (``params_from_jax`` returns CPU tensors)."""
    device = resolve_device(device, "model_from_params")
    return Transformer(cfg, device=device).load_params(params)
