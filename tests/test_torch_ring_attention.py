"""ray_tpu_torch.ops.ring_attention against ray_tpu.ops.ring_attention, on
the CPU.

The block: the port's plain version (what kernel 2 is held against on the
card) against the reference's XLA path and its Pallas kernel in interpret
mode, f32, 1e-5 (the same sums in another order). The ring: the port's
in-process ring over ``["cpu"] * n`` against JAX's ``shard_map`` ring on the
8-device virtual CPU mesh (tests/conftest.py), seq 2 and 4, at the JAX
test's tolerance 2e-5; its gradient against ``jax.grad`` through JAX's
ring. Inputs are seeded numpy arrays handed to both.
"""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.parallel import mesh as jmesh  # noqa: E402
from ray_tpu_torch.ops import ring_attention as tra  # noqa: E402
from ray_tpu_torch.parallel import mesh as tmesh  # noqa: E402

# the module (ray_tpu.ops re-exports a function of the same name)
jra = importlib.import_module("ray_tpu.ops.ring_attention")

BLOCK_ATOL = 1e-5
RING_ATOL = 2e-5
B, S, H, D = 2, 64, 4, 32

# JAX mesh for each seq size: the JAX tests' fsdp=2, seq=2, tensor=2, and
# fsdp=2, seq=4 (batch and heads sharded there too; the math is the same)
JAX_MESHES = {2: dict(fsdp=2, seq=2, tensor=2), 4: dict(fsdp=2, seq=4)}


def _normal(rng, *shape):
    return (rng.normal(size=shape) * 0.3).astype(np.float32)


def _qkv(seed, kv_heads=H, s=S):
    rng = np.random.default_rng(seed)
    return (_normal(rng, B, s, H, D), _normal(rng, B, s, kv_heads, D),
            _normal(rng, B, s, kv_heads, D))


@pytest.fixture(scope="module")
def jax_meshes():
    return {n: jmesh.make_mesh(jmesh.MeshConfig(**cfg),
                               jax.devices()[:8])
            for n, cfg in JAX_MESHES.items()}


def _port_mesh(n):
    return tmesh.make_mesh(tmesh.MeshConfig(seq=n), ["cpu"] * n)


def _jax_ring(mesh, q, k, v, causal):
    with mesh:
        return np.asarray(jax.jit(lambda a, b, c: jra.ring_attention_sharded(
            a, b, c, mesh, causal=causal))(q, k, v))


# (q_offset, k_offset, Tq, Tk, kv_heads, causal)
BLOCKS = {
    "diagonal": (0, 0, 64, 64, H, True),
    "below": (128, 0, 64, 64, H, True),
    "ragged_gqa": (40, 8, 48, 80, H // 2, True),
    "fully_masked": (0, 1000, 16, 16, H, True),
    "non_causal": (0, 0, 64, 48, H // 2, False),
}


@pytest.mark.parametrize("case", list(BLOCKS))
def test_block_matches_xla_and_pallas(case):
    q_off, k_off, tq, tk, kv, causal = BLOCKS[case]
    rng = np.random.default_rng(3)
    q = _normal(rng, B, H, tq, D)
    k, v = _normal(rng, B, kv, tk, D), _normal(rng, B, kv, tk, D)
    got = tra.block_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), q_off, k_off, causal)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_off, k_off,
             causal)
    for name, want in (
            ("xla", jra._block_attention_xla(*jargs)),
            ("pallas", jra._block_attention_pallas(*jargs, interpret=True))):
        for out, g, w in zip(("o", "m", "l"), got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=BLOCK_ATOL, rtol=BLOCK_ATOL,
                                       err_msg=f"{out} vs {name}")


def test_fully_masked_block_is_exactly_empty():
    q_off, k_off, tq, tk, kv, causal = BLOCKS["fully_masked"]
    q, k, v = (torch.from_numpy(a).transpose(1, 2)
               for a in _qkv(4, s=16))
    o, m, l = tra.block_attention(q, k, v, q_off, k_off, causal)
    assert float(o.abs().max()) == 0.0 and float(l.abs().max()) == 0.0
    assert bool((m == tra.NEG_INF).all())


# (seed, kv_heads, causal)
RINGS = {"causal": (0, H, True), "non_causal": (3, H, False),
         "gqa_unrepeated": (7, H // 2, True)}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", list(RINGS))
def test_ring_matches_jax_ring(jax_meshes, n, case):
    seed, kv, causal = RINGS[case]
    q, k, v = _qkv(seed, kv_heads=kv)
    got = tra.ring_attention_sharded(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), _port_mesh(n),
                                     causal=causal)
    want = _jax_ring(jax_meshes[n], q, k, v, causal)
    assert got.shape == (B, S, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=RING_ATOL,
                               rtol=RING_ATOL)
    # and both against plain attention on repeated heads
    rep = H // kv
    ref = tra.attention_reference(
        *(torch.from_numpy(a) for a in (q, np.repeat(k, rep, 2),
                                        np.repeat(v, rep, 2))), causal)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=RING_ATOL,
                               rtol=RING_ATOL)


def test_causality_holds_across_the_ring():
    """Perturbing the last shard's keys and values leaves the first three
    shards' outputs bit-identical: their blocks against it are fully masked
    and contribute exact zeros."""
    q, k, v = _qkv(5)
    k2, v2 = k.copy(), v.copy()
    k2[:, 48:] = np.random.default_rng(9).normal(size=k2[:, 48:].shape)
    v2[:, 48:] = 0.0
    mesh = _port_mesh(4)
    o1, o2 = (tra.ring_attention_sharded(*(torch.from_numpy(a) for a in xs),
                                         mesh, causal=True)
              for xs in ((q, k, v), (q, k2, v2)))
    np.testing.assert_array_equal(o1[:, :48].numpy(), o2[:, :48].numpy())
    assert not np.allclose(o1[:, 48:].numpy(), o2[:, 48:].numpy())


@pytest.mark.parametrize("n", [2, 4])
def test_ring_gradient_matches_jax_grad(jax_meshes, n):
    """On the CPU the ring is differentiable (the block's plain version and
    the merge are plain ops): dq, dk, dv against jax.grad through JAX's
    ring, GQA unrepeated."""
    q, k, v = _qkv(11, kv_heads=H // 2)
    w = np.random.default_rng(12).normal(size=(B, S, H, D)).astype(np.float32)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tra.ring_attention_sharded(*ts, _port_mesh(n), causal=True)
    (out * torch.from_numpy(w)).sum().backward()

    mesh = jax_meshes[n]
    with mesh:
        grads = jax.jit(jax.grad(
            lambda a, b, c: jnp.sum(jra.ring_attention_sharded(
                a, b, c, mesh, causal=True) * w), argnums=(0, 1, 2)))(
            q, k, v)
    for name, t, g in zip("qkv", ts, grads):
        assert t.grad.shape == g.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=RING_ATOL, rtol=RING_ATOL,
                                   err_msg=f"d{name}")


def test_cpu_path_launches_no_kernel():
    before = tra.block_attention.launches
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, kv_heads=H // 2))
    tra.ring_attention_sharded(q, k, v, _port_mesh(4))
    tra.block_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2))
    assert tra.block_attention.launches == before


def test_block_raises_off_cpu_without_a_kernel():
    """No fallback: a tensor that is not on the CPU gets the kernel or an
    error, never the plain version; and the kernel has no backward, so a
    call autograd would differentiate raises first."""
    q = torch.empty((1, 4, 16, 128), device="meta")
    kv = torch.empty((1, 2, 16, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tra.block_attention(q, kv, kv)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tra.block_attention(q.requires_grad_(), kv, kv)
    with torch.no_grad():
        with pytest.raises(ValueError, match="no kernel"):
            tra.block_attention(q, kv, kv)


def test_ring_rejects_a_mesh_of_another_device_kind():
    """No host detour: tensors off the CPU under a CPU mesh (and CPU tensors
    under a mesh of other devices) raise instead of moving each shard to
    the mesh's devices and running the plain version there."""
    shape_q, shape_kv = (1, 32, 4, 128), (1, 32, 2, 128)
    q = torch.empty(shape_q, device="meta")
    kv = torch.empty(shape_kv, device="meta")
    before = tra.block_attention.launches
    with pytest.raises(ValueError, match="kind"):
        tra.ring_attention_sharded(q, kv, kv, _port_mesh(2))
    meta_mesh = tmesh.make_mesh(tmesh.MeshConfig(seq=2), ["meta"] * 2)
    with pytest.raises(ValueError, match="kind"):
        tra.ring_attention_sharded(torch.zeros(shape_q), torch.zeros(shape_kv),
                                   torch.zeros(shape_kv), meta_mesh)
    with pytest.raises(ValueError, match="kind"):
        tra.ring_attention_sharded(torch.zeros(shape_q), kv, kv,
                                   _port_mesh(2))
    assert tra.block_attention.launches == before


def test_ring_rejects_axes_other_than_seq():
    """Batch and head axes split the in-process ring into one ring a block
    (equal to JAX's ring on the same mesh); what does not split into the
    mesh's shards is rejected."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, kv_heads=H // 2))
    mesh = tmesh.make_mesh(tmesh.MeshConfig(fsdp=2, seq=2, tensor=2),
                           ["cpu"] * 8)
    got = tra.ring_attention_sharded(q, k, v, mesh)
    jmesh_ = jmesh.make_mesh(jmesh.MeshConfig(fsdp=2, seq=2, tensor=2),
                             jax.devices()[:8])
    want = _jax_ring(jmesh_, q.numpy(), k.numpy(), v.numpy(), True)
    np.testing.assert_allclose(got.numpy(), want, atol=RING_ATOL,
                               rtol=RING_ATOL)
    with pytest.raises(ValueError, match="split"):
        tra.ring_attention_sharded(q[:1], k[:1], v[:1], mesh)
    with pytest.raises(ValueError, match="split"):
        tra.ring_attention_sharded(q[:, :63], k[:, :63], v[:, :63],
                                   _port_mesh(2))


class _RecordingLibrary:
    """Stands in for a kernel library: records each entry point's name and
    arguments and returns 0 (success)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0

        entry.__name__ = name
        return entry


@pytest.fixture
def recorded(monkeypatch):
    """block_attention on meta tensors reaches its launch, which goes to a
    recording library instead of the card."""
    from ray_tpu_torch.ops import _build

    lib = _RecordingLibrary()
    monkeypatch.setattr(_build, "library", lambda name, signatures: lib)
    monkeypatch.setattr(tra, "_KERNEL_DEVICE", "meta")
    monkeypatch.setattr(tra, "_stream", lambda device: 0)
    return lib


def _ring_shard(dtype, heads, i=1, n=2, s=64, batch=2):
    """Shard i of n of a [B, S, heads, 128] tensor, as the ring passes it:
    a [B, heads, S / n, 128] view."""
    x = torch.empty((batch, s, heads, 128), dtype=dtype, device="meta")
    return x[:, i * s // n:(i + 1) * s // n].transpose(1, 2)


def test_bf16_block_reaches_the_sm90_entry_with_byte_strides(recorded):
    """A bf16 GQA ring shard goes to the Hopper kernel: dims, offsets,
    H and Hkv (query head h reads KV head h / (H / Hkv)), and the view's
    strides in bytes."""
    q = _ring_shard(torch.bfloat16, 4)
    k, v = _ring_shard(torch.bfloat16, 2), _ring_shard(torch.bfloat16, 2)
    before = tra.block_attention.launches
    o, m, l = tra.block_attention(q, k, v, 32, 0, True)
    assert tra.block_attention.launches == before + 1
    (name, args), = recorded.calls
    assert name == "ring_block_attention_bf16"
    assert args[6:14] == (2, 4, 2, 32, 32, 128, 32, 0)
    # [B, S, H, D] bf16: batch 64*H*128*2 bytes, head 256, sequence H*256
    assert args[14:23] == (65536, 256, 1024, 32768, 256, 512,
                           32768, 256, 512)
    # causal, the launch plan's splits (one: 8 blocks of the template
    # would not fill the card, and there is one key tile), device, stream
    assert args[23:] == (1, 1, 0, 0)
    assert o.shape == (2, 4, 32, 128) and m.shape == l.shape == (2, 4, 32)
    assert {t.dtype for t in (o, m, l)} == {torch.float32}


def test_f32_block_reaches_the_fma_entry_with_element_strides(recorded):
    q = _ring_shard(torch.float32, 4, i=0)
    k, v = (_ring_shard(torch.float32, 4, i=1) for _ in range(2))
    tra.block_attention(q, k, v, 0, 32, False)
    (name, args), = recorded.calls
    assert name == "ring_block_attention"
    assert args[6:14] == (2, 4, 4, 32, 32, 128, 0, 32)
    assert args[14:23] == (32768, 128, 512) * 3
    assert args[23:] == (0, 0, 0)


@pytest.mark.parametrize("case", ["row_not_16_bytes", "zero_head_stride"])
def test_bf16_block_rejects_strides_tma_cannot_take(recorded, case):
    """Strides TMA cannot take raise ValueError before any launch, and
    nothing else runs in the kernel's place."""
    kv = _ring_shard(torch.bfloat16, 2)
    if case == "row_not_16_bytes":
        q = torch.empty((1, 4, 16, 132), dtype=torch.bfloat16,
                        device="meta")[..., :128]
        kv = kv[:1, :, :16]
    else:
        q = torch.empty((2, 1, 32, 128), dtype=torch.bfloat16,
                        device="meta").expand(2, 4, 32, 128)
    before = tra.block_attention.launches
    with pytest.raises(ValueError, match="16"):
        tra.block_attention(q, kv, kv)
    assert not recorded.calls and tra.block_attention.launches == before


# ----------------------------------------------------------------------
# the bf16 launch plan (block_plan) and the split kernel's key ranges
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shape, splits", [
    # the 32k ring at head_dim 128 (16 / 8 heads, 8192-token shards):
    # 1024 blocks of the 128-query template, today's launch
    ((1, 16, 8192, 8192, 128), 0),
    # the ring paths of the smaller models: 512-token shards of 4 or 8
    # heads at 16, 32 and 256, 2048-token shards of 8 heads at 64. Only
    # 256 keeps work enough a split (512 x 256 / 2 keys x head_dim) in
    # one block an SM (8 x 8 tiles x 2)
    ((1, 4, 512, 512, 16), 1),
    ((1, 8, 512, 512, 32), 1),
    ((1, 8, 512, 512, 256), 2),
    ((1, 8, 2048, 2048, 64), 1),
    # long shards fill the card: the template where the width takes it,
    # else the split kernel unsplit
    ((1, 16, 8192, 8192, 64), 0),
    ((2, 8, 8192, 8192, 16), 1),
    # few tiles and long keys: up to MAX_SPLITS
    ((1, 1, 64, 8192, 32), 8),
    ((1, 4, 100, 2048, 128), 8),
    ((1, 4, 100, 1024, 64), 2),
])
def test_block_plan_cases(shape, splits):
    assert tra.block_plan(*shape) == splits


@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
def test_block_plan_keeps_one_split_where_the_grid_fills_the_card(D):
    """Wherever the 64-query tiles alone fill the card (an SM each) the
    plan splits nothing, and wherever the 128-query template fills it at
    a width it takes, the plan is the template; otherwise at most
    MAX_SPLITS and the key tiles there are, within one block an SM."""
    rng = np.random.default_rng(D)
    for _ in range(400):
        B, H = (int(x) for x in rng.integers(1, 17, 2))
        Tq, Tk = (int(x) for x in rng.integers(1, 20000, 2))
        plan = tra.block_plan(B, H, Tq, Tk, D)
        tiles = B * H * -(-Tq // 64)
        if D % 64 == 0 and B * H * -(-Tq // 128) >= tra.FILL_BLOCKS:
            assert plan == 0
        else:
            assert 1 <= plan <= min(tra.MAX_SPLITS,
                                    max(1, -(-Tk // tra.split_keys(D))))
            assert plan == 1 or tiles * plan <= tra.SMS
            if tiles >= tra.SMS:
                assert plan == 1


@pytest.mark.parametrize("D", [16, 256])
@pytest.mark.parametrize("q_offset, k_offset, Tq, Tk, causal", [
    (512, 512, 512, 512, True),     # the diagonal block
    (1024, 0, 512, 512, True),      # every key visible
    (0, 1536, 512, 512, True),      # none visible
    (101, 37, 333, 200, True),      # ragged, offset
    (3, 11, 257, 190, False),
    (0, 64, 200, 700, True),        # the first rows see no key
])
def test_split_key_tiles_cover_each_visible_key_once(D, q_offset, k_offset,
                                                     Tq, Tk, causal):
    """Oracle of the split kernel's key ranges: for each 64-query tile and
    each split count, the splits' tiles are disjoint, each holds a key some
    row of the tile sees, and together they hold every such key."""
    keys = tra.split_keys(D)
    for splits in range(1, tra.MAX_SPLITS + 1):
        for q0 in range(0, Tq, 64):
            rows = q_offset + np.arange(q0, min(q0 + 64, Tq))
            cols = k_offset + np.arange(Tk)
            seen = ((rows[:, None] >= cols[None, :]) if causal
                    else np.ones((len(rows), Tk), bool)).any(0)
            ranges = tra.split_key_tiles(q0, Tq, Tk, D, q_offset, k_offset,
                                         causal, splits)
            assert len(ranges) == splits
            tiles = [kt for kt0, kt1 in ranges for kt in range(kt0, kt1)]
            assert len(tiles) == len(set(tiles))
            covered = np.zeros(Tk, bool)
            for kt in tiles:
                block = slice(kt * keys, min((kt + 1) * keys, Tk))
                assert seen[block].any(), (splits, q0, kt)
                covered[block] = True
            assert covered[seen].all()


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("case", ["diagonal", "ragged_gqa", "fully_masked",
                                  "non_causal"])
def test_split_merge_matches_xla(case, splits):
    """The split kernel's function in plain ops: each split's share of a
    64-query tile's key tiles through the plain block, merged as the kernel
    merges (m the largest, w_j = exp(m_j - m) or 0 for a split that saw no
    key, o and l the w-weighted sums in split order), against the
    reference's XLA block on all keys, f32, 1e-5."""
    q_off, k_off, tq, tk, kv, causal = BLOCKS[case]
    rng = np.random.default_rng(11)
    Dh = 16
    q = _normal(rng, 2, H, tq, Dh)
    k, v = (_normal(rng, 2, kv, tk, Dh) for _ in range(2))
    keys = tra.split_keys(Dh)
    qt, kt_, vt = (torch.from_numpy(x) for x in (q, k, v))
    o = torch.zeros((2, H, tq, Dh))
    m = torch.full((2, H, tq), tra.NEG_INF)
    l = torch.zeros((2, H, tq))
    for q0 in range(0, tq, 64):
        rows = slice(q0, min(q0 + 64, tq))
        parts = []
        for kt0, kt1 in tra.split_key_tiles(q0, tq, tk, Dh, q_off, k_off,
                                            causal, splits):
            n = min(kt1 * keys, tk) - kt0 * keys
            if n <= 0:
                shape = qt[:, :, rows].shape
                parts.append((torch.zeros(shape),
                              torch.full(shape[:-1], tra.NEG_INF),
                              torch.zeros(shape[:-1])))
                continue
            cut = slice(kt0 * keys, kt0 * keys + n)
            parts.append(tra._block_attention_reference(
                qt[:, :, rows], kt_[:, :, cut], vt[:, :, cut],
                q_off + q0, k_off + kt0 * keys, causal))
        m_t = torch.stack([p[1] for p in parts]).amax(0)
        for o_j, m_j, l_j in parts:
            w = torch.where(m_j > tra.NEG_INF / 2, torch.exp(m_j - m_t), 0.0)
            o[:, :, rows] += w[..., None] * o_j
            l[:, :, rows] += w * l_j
        m[:, :, rows] = m_t
    want = jra._block_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), q_off, k_off, causal)
    for out, g, w in zip(("o", "m", "l"), (o, m, l), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BLOCK_ATOL,
                                   rtol=BLOCK_ATOL, err_msg=out)


@pytest.mark.parametrize("splits", [None, 0, 3])
def test_bf16_block_passes_its_launch_plan(recorded, splits):
    """The bf16 entry takes the plan's splits after causal (block_plan's,
    or the caller's): B=2, H=4, Tq=32 at 128 is 8 blocks of the template,
    so the plan is the split kernel, one split (one key tile)."""
    q = _ring_shard(torch.bfloat16, 4)
    kv = _ring_shard(torch.bfloat16, 2)
    tra.block_attention(q, kv, kv, 32, 0, True, splits)
    (name, args), = recorded.calls
    assert tra.block_plan(2, 4, 32, 32, 128) == 1
    assert args[23:] == (1, 1 if splits is None else splits, 0, 0)


@pytest.mark.parametrize("D, splits", [(16, 0), (128, 9), (32, -1)])
def test_bf16_block_refuses_a_launch_its_width_has_not(recorded, D, splits):
    q = torch.empty((1, 2, 64, D), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="splits"):
        tra.block_attention(q, q, q, 0, 0, True, splits)
    assert not recorded.calls
