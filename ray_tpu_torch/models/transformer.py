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

Only the einsum attention branch of the reference is ported: its flash
branch runs only on a TPU, and ring attention and MoE are later slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


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

    def __post_init__(self):
        if self.moe:
            raise NotImplementedError(
                "moe=True is not ported yet (ROADMAP.md, Queue A: MoE and "
                "pipeline)")
        if self.ring_attention:
            raise NotImplementedError(
                "ring_attention=True is not ported yet (ROADMAP.md, Queue "
                "A: ring attention with kernel 2)")

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


def _param(shape, cfg: TransformerConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype,
                                    device=device), requires_grad=False)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=param_dtype,
                                             device=device),
                                  requires_grad=False)

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
        # GQA: repeat kv heads up to query heads (jnp.repeat order)
        rep = cfg.n_heads // cfg.n_kv_heads
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
        if mask is None:
            s = x.shape[1]
            mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                         device=x.device))[None, None]
        scores = torch.einsum("bshk,bthk->bhst", q, k) / math.sqrt(hd)
        scores = scores.to(torch.float32).masked_fill(~mask, -1e30)
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        out = torch.einsum("bhst,bthk->bshk", probs, v)
        return torch.einsum("bshk,hkd->bsd", out, self.wo.to(cfg.dtype))


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


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.RMSNorm_0 = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.param_dtype,
                                 device)
        self.Attention_0 = Attention(cfg, device)
        self.RMSNorm_1 = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.param_dtype,
                                 device)
        self.MLP_0 = MLP(cfg, device)

    def forward(self, x, positions, mask=None):
        x = x + self.Attention_0(self.RMSNorm_0(x), positions, mask)
        return x + self.MLP_0(self.RMSNorm_1(x))


class Transformer(nn.Module):
    """Causal LM: tokens [B, S] int -> logits [B, S, V] in the compute dtype.

    Submodule names mirror the flax tree (``layer_{i}.Attention_0.wq``),
    so ``load_params`` takes the flat "/"-keyed dict directly. The
    parameters are allocated uninitialised: load them."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
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

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        embed = self.embedding.to(cfg.dtype)
        x = embed[tokens]
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        for i in range(cfg.n_layers):
            x = getattr(self, f"layer_{i}")(x, positions)
        x = self.final_norm(x)
        return torch.einsum("bsd,vd->bsv", x, embed)


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
    normal(0.02), weights lecun_normal, norm scales ones. Drawn from
    ``generator`` on its own device, returned in f32 on ``device``
    (default: the generator's device). Not bit-equal to flax's draw;
    parity tests load flax's params through ``params_from_jax``."""
    device = device or generator.device
    hd = cfg.head_dim
    D, H, KV, Fd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

    def lecun(shape):
        return _truncated_normal(shape, 1.0 / math.sqrt(_lecun_fan_in(shape)),
                                 generator, device)

    emb = torch.randn((cfg.vocab_size, D), generator=generator,
                      device=generator.device, dtype=torch.float32) * 0.02
    params = {"embedding": emb.to(device)}
    for i in range(cfg.n_layers):
        pre = f"layer_{i}"
        params[f"{pre}/RMSNorm_0/scale"] = torch.ones(D, device=device)
        params[f"{pre}/Attention_0/wq"] = lecun((D, H, hd))
        params[f"{pre}/Attention_0/wk"] = lecun((D, KV, hd))
        params[f"{pre}/Attention_0/wv"] = lecun((D, KV, hd))
        params[f"{pre}/Attention_0/wo"] = lecun((H, hd, D))
        params[f"{pre}/RMSNorm_1/scale"] = torch.ones(D, device=device)
        params[f"{pre}/MLP_0/w_gate"] = lecun((D, Fd))
        params[f"{pre}/MLP_0/w_up"] = lecun((D, Fd))
        params[f"{pre}/MLP_0/w_down"] = lecun((Fd, D))
    params["final_norm/scale"] = torch.ones(D, device=device)
    return params


def param_count(params: Mapping[str, torch.Tensor]) -> int:
    return int(sum(t.numel() for t in params.values()))


def model_from_params(cfg: TransformerConfig,
                      params: Mapping[str, torch.Tensor],
                      device: Optional[torch.device] = None) -> Transformer:
    """A ``Transformer`` on ``device`` holding a copy of ``params``."""
    device = device or next(iter(params.values())).device
    return Transformer(cfg, device=device).load_params(params)
