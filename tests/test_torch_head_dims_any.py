"""Kernels 1 and 2 at head widths between the built ones, against the JAX
package, on the CPU.

``ray_tpu_torch/ops/head_dims.py``: kernels 1 and 2 take every head_dim
from 1 to 256, each on the library of its class (the smallest of 16, 32,
64, 128, 256 at or above it). Here, at widths of the repo's own classes'
gaps (8 through 200, with Phi-3-mini's and GPT-NeoX-20B's 96, Phi-2's 80,
Zamba2-7B's 112): the port's plain versions (what each CUDA kernel is held
against on the card) against the reference's Pallas kernels in interpret
mode; the ring forward at 96 against the JAX ring (the engine at 80, 96
and 100 and the routes of each width: tests/test_torch_head_dims.py).
Inputs are seeded numpy arrays (or flax-initialised
params through ``params_from_jax``) handed to both.

Tolerances, f32 throughout, as the head_dim-128 tests state them: ATOL
1e-5 for a kernel's outputs (the same sums in another order), RING_ATOL
2e-5 for the ring (tests/test_torch_ring_attention.py), MODEL_ATOL 3e-4 for
a ring model's logits (tests/test_torch_transformer.py's ring test).
"""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import transformer as jtt  # noqa: E402
from ray_tpu.ops import paged_attention as jpa  # noqa: E402
from ray_tpu.parallel import mesh as jmesh  # noqa: E402
from ray_tpu_torch.models import transformer as tt  # noqa: E402
from ray_tpu_torch.ops import head_dims  # noqa: E402
from ray_tpu_torch.ops import paged_attention as tpa  # noqa: E402
from ray_tpu_torch.ops import ring_attention as tra  # noqa: E402
from ray_tpu_torch.parallel import mesh as tmesh  # noqa: E402

# the module (ray_tpu.ops re-exports a function of the same name)
jra = importlib.import_module("ray_tpu.ops.ring_attention")

ATOL = 1e-5
RING_ATOL = 2e-5
MODEL_ATOL = 3e-4
# the widths chip_smoke.py's phases kernel and ring_kernel hold the
# kernels at, each below its class
WIDTHS = (8, 24, 40, 48, 72, 80, 96, 100, 112, 160, 192, 200)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("D, cls", [(1, 16), (8, 16), (16, 16), (17, 32),
                                    (33, 64), (96, 128), (100, 128),
                                    (129, 256), (200, 256), (256, 256)])
def test_width_class_is_the_smallest_built_width_at_or_above(D, cls):
    for kernel in ("paged_attention", "block_attention"):
        assert head_dims.width_class(D, kernel) == cls
        head_dims.check(kernel, D)
    assert cls in head_dims.PAGED_ATTENTION


# ----------------------------------------------------------------------
# kernel 1: paged decode attention
# ----------------------------------------------------------------------

@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("D", WIDTHS)
def test_paged_attention_matches_jax_kernel(D, page):
    """GQA (8 query heads over 2 KV heads), ragged lengths with an empty
    sequence, one past a page and a full table: the wrapper's CPU path and
    the plain mirror of the CUDA kernel's split and merge against the
    reference's Pallas kernel in interpret mode."""
    B, H, KV, MP = 4, 8, 2, 3
    P = B * MP
    rng = np.random.default_rng(D * 100 + page)
    q = _normal(rng, B, H, D)
    kp, vp = _normal(rng, P, KV, page, D), _normal(rng, P, KV, page, D)
    table = rng.permutation(P).reshape(B, MP).astype(np.int32)
    lens = np.asarray([0, 1, page + 1, MP * page], np.int32)
    want = np.asarray(jpa.paged_attention(
        *map(jnp.asarray, (q, kp, vp, table, lens)), interpret=True))
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, lens)]
    got = tpa.paged_attention(*args)
    assert got.shape == (B, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(got.numpy()[0], 0.0)
    for pps in (1, 2):
        merged = tpa.merge_splits(*tpa.paged_attention_splits(*args, pps))
        np.testing.assert_allclose(merged.numpy(), want, atol=ATOL,
                                   err_msg=f"{pps} pages per split")


@pytest.mark.parametrize("D", [3, 36, 99, 100, 200])
@pytest.mark.parametrize("elt", [2, 4])
def test_split_smem_bytes_at_any_width(D, elt):
    """The wrapper's count mirrors split_layout at a padded width: K and V
    tiles of page x D values each, rounded up to 16 bytes where a width
    that is not a multiple of 8 leaves them short of it; at the serving
    shape a split stays under 48 KiB."""
    for pps, page, G in ((1, 1, 1), (2, 4, 2), (3, 16, 8)):
        tiles = 2 * pps * page * D * elt
        probs = (G * pps * page * 4 + 7) // 8 * 8
        assert tpa.split_smem_bytes(pps, page, G, elt, D) == (
            -(-tiles // 16) * 16 + probs + 2 * pps * 8 + (2 * G + 1) * 4)
    pps, splits = tpa.split_plan(64, 8, 4, 16, 16, elt, D)
    assert pps * splits >= 16
    assert tpa.split_smem_bytes(pps, 16, 2, elt, D) <= 48 * 1024


# ----------------------------------------------------------------------
# kernel 2: ring attention's block
# ----------------------------------------------------------------------

# a ring path's three kinds of block over 48-token shards, as (q_offset,
# k_offset): a shard against its own keys, one whose keys all precede it
# and one whose keys all follow it; 4 query heads over 2 KV heads
RING_T = 48
RING_BLOCKS = {"diagonal": (RING_T, RING_T), "full": (2 * RING_T, 0),
               "masked": (0, 3 * RING_T)}


@pytest.mark.parametrize("block", list(RING_BLOCKS))
@pytest.mark.parametrize("D", WIDTHS)
def test_block_attention_matches_jax_pallas(D, block):
    q_off, k_off = RING_BLOCKS[block]
    rng = np.random.default_rng(D + 1)
    q = _normal(rng, 2, 4, RING_T, D, scale=0.3)
    k, v = (_normal(rng, 2, 2, RING_T, D, scale=0.3) for _ in range(2))
    got = tra.block_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), q_off, k_off, True)
    want = jra.block_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), q_off, k_off, True,
                               impl="pallas", interpret=True)
    for out, g, w in zip(("o", "m", "l"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=ATOL, err_msg=out)
    if block == "masked":
        assert float(got[0].abs().max()) == 0.0
        assert bool((got[1] == tra.NEG_INF).all())


@pytest.fixture(scope="module")
def jax_ring_mesh():
    return jmesh.make_mesh(jmesh.MeshConfig(fsdp=2, seq=4),
                           jax.devices()[:8])


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_ring_at_96_matches_jax_ring(jax_ring_mesh, kv_heads):
    """The in-process ring over a seq=4 CPU mesh at head_dim 96 (Phi-3-mini's
    width), MHA and GQA, against JAX's shard_map ring on fsdp=2 x seq=4."""
    B, S, H, D = 2, 64, 4, 96
    rng = np.random.default_rng(96 + kv_heads)
    q = _normal(rng, B, S, H, D, scale=0.3)
    k, v = (_normal(rng, B, S, kv_heads, D, scale=0.3) for _ in range(2))
    mesh = tmesh.make_mesh(tmesh.MeshConfig(seq=4), ["cpu"] * 4)
    got = tra.ring_attention_sharded(*(torch.from_numpy(a) for a in (q, k, v)),
                                     mesh)
    with jax_ring_mesh:
        want = np.asarray(jax.jit(lambda a, b, c: jra.ring_attention_sharded(
            a, b, c, jax_ring_mesh))(q, k, v))
    assert got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.numpy(), want, atol=RING_ATOL,
                               rtol=RING_ATOL)


def test_ring_model_at_96_matches_jax_ring_model(jax_ring_mesh):
    """A narrow model of Phi-3-mini's head width (2 layers, 2 x 96, group
    1) with ring attention on seq=4, the port's over four CPU devices and
    JAX's over fsdp=2 x seq=4, from the same flax params: logits against
    each other and against the port's forward without the ring, at the
    ring model test's 3e-4."""
    base = dict(vocab_size=128, d_model=192, n_layers=2, n_heads=2,
                n_kv_heads=2, d_ff=256, max_seq_len=64)
    tokens = np.random.default_rng(0).integers(0, 128, (2, 64)).astype(
        np.int32)
    jparams = jtt.Transformer(jtt.TransformerConfig(
        dtype=jnp.float32, **base)).init(jax.random.PRNGKey(1),
                                         jnp.asarray(tokens))["params"]
    jring = jtt.Transformer(jtt.TransformerConfig(
        dtype=jnp.float32, ring_attention=True, **base))
    with jmesh.use_mesh(jax_ring_mesh):
        want = np.asarray(jax.jit(lambda p, t: jring.apply({"params": p}, t))(
            jparams, jnp.asarray(tokens)))
    params = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    cfg = tt.TransformerConfig(dtype=torch.float32, ring_attention=True,
                               **base)
    assert cfg.head_dim == 96
    net = tt.model_from_params(cfg, params, device="cpu")
    mesh = tmesh.make_mesh(tmesh.MeshConfig(seq=4), ["cpu"] * 4)
    with torch.no_grad():
        with tmesh.use_mesh(mesh):
            got = net(torch.from_numpy(tokens)).numpy()
        plain = net(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL, rtol=MODEL_ATOL)
    np.testing.assert_allclose(got, plain, atol=MODEL_ATOL, rtol=MODEL_ATOL)


# ----------------------------------------------------------------------
# Phi-3-mini's widths
# ----------------------------------------------------------------------

def test_phi3_mini_widths():
    """chip_smoke.py's Phi-3-mini-4k configuration (its config.json's
    widths through the repo's TransformerConfig): head_dim 96, group 1,
    3,722,578,944 parameters counted on the meta device (the published
    3.82B less its untied output head of 32064 x 3072: the repo's model
    reads its logits off the embedding), a width class of 128 for kernels
    1 and 2, and no flash branch (96 is no multiple of 128)."""
    import types

    import chip_smoke

    cfg = tt.TransformerConfig(**chip_smoke.PHI3_MINI)
    assert (cfg.head_dim, cfg.n_heads // cfg.n_kv_heads) == (96, 1)
    assert (cfg.vocab_size, cfg.d_model, cfg.n_layers, cfg.d_ff,
            cfg.max_seq_len) == (32064, 3072, 32, 8192, 4096)
    n = sum(p.numel() for p in tt.Transformer(cfg, device="meta")
            .parameters())
    layer = 2 * 3072 + 4 * 3072 * 3072 + 3 * 3072 * 8192
    assert n == 32064 * 3072 + 32 * layer + 3072 == 3_722_578_944
    assert head_dims.width_class(96) == 128
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    assert not tt._flash_supported(on_card, cfg.head_dim)
