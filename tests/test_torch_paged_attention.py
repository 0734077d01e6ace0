"""ray_tpu_torch.ops.paged_attention against the JAX reference package.

The port's plain paged attention (the CPU path of its wrapper, and the
oracle its CUDA kernel is held against on the card by chip_smoke.py) must
match JAX's Pallas kernel in interpret mode and JAX's XLA reference; so
must the plain mirror of the CUDA kernel's two steps (partials per split
of the pages, then their merge), at every split size. The page-cache
writers must match JAX's exactly. Inputs come from numpy with a seed and go
to both sides. The wrapper's launch path (split plan, checks, arguments)
is driven on meta tensors against a recording library.
"""

import functools
import inspect

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.ops import paged_attention as jpa  # noqa: E402
from ray_tpu_torch.ops import paged_attention as tpa  # noqa: E402


def _case(seed, B, H, KV, D, page, P, MP, lens):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, D)).astype(np.float32),
            rng.normal(size=(P, KV, page, D)).astype(np.float32),
            rng.normal(size=(P, KV, page, D)).astype(np.float32),
            rng.integers(0, P, size=(B, MP)).astype(np.int32),
            np.asarray(lens, np.int32))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_jax_kernel_and_reference(seed):
    # shapes of tests/test_inference.py::TestPagedAttention
    args = _case(seed, 3, 8, 4, 32, 8, 16, 4, [5, 17, 32])
    got = tpa.paged_attention_reference(*_torch(*args)).numpy()
    ker = np.asarray(jpa.paged_attention(*map(jnp.asarray, args),
                                         interpret=True))
    ref = np.asarray(jpa.paged_attention_reference(*map(jnp.asarray, args)))
    assert got.dtype == np.float32 and got.shape == (3, 8, 32)
    np.testing.assert_allclose(got, ker, atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_zero_length_sequence_matches_jax_kernel():
    B, H, KV, D, page, P, MP = 2, 4, 2, 16, 4, 8, 2
    q = np.ones((B, H, D), np.float32)
    kp = np.ones((P, KV, page, D), np.float32)
    table = np.zeros((B, MP), np.int32)
    lens = np.asarray([0, 3], np.int32)
    got = tpa.paged_attention_reference(
        *_torch(q, kp, kp, table, lens)).numpy()
    ker = np.asarray(jpa.paged_attention(
        *map(jnp.asarray, (q, kp, kp, table, lens)), interpret=True))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[0], 0.0)
    np.testing.assert_allclose(got[1], 1.0, atol=1e-5)
    np.testing.assert_allclose(got, ker, atol=1e-5)


def test_wrapper_takes_plain_path_on_cpu_without_launch():
    args = _torch(*_case(3, 2, 4, 2, 64, 4, 8, 3, [0, 9]))
    before = tpa.paged_attention.launches
    out = tpa.paged_attention(*args)
    assert tpa.paged_attention.launches == before
    np.testing.assert_array_equal(
        out.numpy(), tpa.paged_attention_reference(*args).numpy())


def test_wrapper_rejects_other_devices():
    args = [t.to("meta") for t in _torch(*_case(4, 2, 4, 2, 64, 4, 8, 3,
                                                [1, 2]))]
    with pytest.raises(ValueError, match="no kernel"):
        tpa.paged_attention(*args)


@pytest.mark.parametrize("lens", [[5, 0], [11, 3], [12, 7]])
def test_append_token_kv_matches_jax(lens):
    rng = np.random.default_rng(sum(lens))
    B, KV, D, page, P, MP = 2, 2, 8, 4, 6, 3
    kp = rng.normal(size=(P, KV, page, D)).astype(np.float32)
    vp = rng.normal(size=(P, KV, page, D)).astype(np.float32)
    table = np.asarray([[1, 2, 0], [3, 4, 5]], np.int32)
    lens = np.asarray(lens, np.int32)
    kn = rng.normal(size=(B, KV, D)).astype(np.float32)
    vn = rng.normal(size=(B, KV, D)).astype(np.float32)
    jk, jv = jpa.append_token_kv(*map(jnp.asarray, (kp, vp, kn, vn, table,
                                                    lens)))
    tk, tv = _torch(kp.copy(), vp.copy())
    tpa.append_token_kv(tk, tv, *_torch(kn, vn, table, lens))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_append_token_kv_past_the_table_writes_nothing():
    """A budget overrun (logical page >= MP) is dropped, as JAX's
    out-of-bounds gather drops it."""
    rng = np.random.default_rng(7)
    kp = rng.normal(size=(4, 1, 2, 4)).astype(np.float32)
    table = np.asarray([[1, 2]], np.int32)
    lens = np.asarray([4], np.int32)               # logical page 2 == MP
    kn = rng.normal(size=(1, 1, 4)).astype(np.float32)
    jk, _ = jpa.append_token_kv(*map(jnp.asarray, (kp, kp, kn, kn, table,
                                                   lens)))
    tk, tv = _torch(kp.copy(), kp.copy())
    tpa.append_token_kv(tk, tv, *_torch(kn, kn, table, lens))
    np.testing.assert_array_equal(tk.numpy(), kp)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("S,pages", [(5, [3, 1]), (8, [0, 4]), (1, [2])])
def test_write_prefill_kv_matches_jax(S, pages):
    rng = np.random.default_rng(S)
    P, KV, page, D = 6, 2, 4, 8
    kp = rng.normal(size=(P, KV, page, D)).astype(np.float32)
    vp = rng.normal(size=(P, KV, page, D)).astype(np.float32)
    ks = rng.normal(size=(S, KV, D)).astype(np.float32)
    vs = rng.normal(size=(S, KV, D)).astype(np.float32)
    pages = np.asarray(pages, np.int32)
    jk, jv = jpa.write_prefill_kv(*map(jnp.asarray, (kp, vp, ks, vs,
                                                     pages)))
    tk, tv = _torch(kp.copy(), vp.copy())
    tpa.write_prefill_kv(tk, tv, *_torch(ks, vs, pages))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# the split mirror: 7 pages of 4 tokens per sequence, so 2 and 3 pages per
# split leave a short last split; lengths empty, one token, a page and one
# past it, at the 2- and 3-page split edges and past them, the whole table,
# and past the table's end
_SPLIT_SHAPE = dict(KV=2, D=32, page=4, P=40, MP=7)
_SPLIT_LENS = [0, 1, 4, 5, 8, 9, 12, 13, 24, 25, 28, 40]


def _bf16(x):
    """numpy f32 -> the same values rounded to bf16, as a torch bf16
    tensor and as a JAX bf16 array."""
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@functools.lru_cache(maxsize=None)
def _split_case(G, dtype):
    """(torch inputs, the JAX Pallas kernel's output in interpret mode)."""
    sh = _SPLIT_SHAPE
    args = _case(10 + G, len(_SPLIT_LENS), G * sh["KV"], sh["KV"], sh["D"],
                 sh["page"], sh["P"], sh["MP"], _SPLIT_LENS)
    if dtype == "bfloat16":
        pairs = [_bf16(a) for a in args[:3]]
        targs = [t for t, _ in pairs] + _torch(*args[3:])
        jargs = [j for _, j in pairs] + list(map(jnp.asarray, args[3:]))
    else:
        targs, jargs = _torch(*args), list(map(jnp.asarray, args))
    return targs, np.asarray(jpa.paged_attention(*jargs, interpret=True))


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-5),
                                        ("bfloat16", 1e-4)])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("pps", [1, 2, 3, 7])
def test_split_mirror_matches_jax_kernel(pps, G, dtype, tol):
    """The CUDA kernel's arithmetic (base-2 softmax per split of pps
    logical pages, unnormalised partials, the fixed-order merge) equals the
    Pallas kernel at every split size: f32 to 1e-5, bf16 inputs (the same
    rounded values on both sides, f32 accumulation) to 1e-4."""
    targs, want = _split_case(G, dtype)
    o, m, l = tpa.paged_attention_splits(*targs, pages_per_split=pps)
    S = -(-_SPLIT_SHAPE["MP"] // pps)
    B, H, D = want.shape
    assert o.shape == (B, H, S, D) and m.shape == l.shape == (B, H, S)
    got = tpa.merge_splits(o, m, l).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=tol)
    np.testing.assert_allclose(got[0], 0.0)    # length 0 gives zeros


def test_split_partials_of_empty_splits():
    """A split that starts at or past its sequence's end is the empty
    partial: m = -1e30, l = 0, o = 0; every other split has l >= 1 (its
    largest score contributes exp2(0))."""
    targs, _ = _split_case(2, "float32")
    o, m, l = tpa.paged_attention_splits(*targs, pages_per_split=2)
    page, MP = _SPLIT_SHAPE["page"], _SPLIT_SHAPE["MP"]
    lens = np.minimum(_SPLIT_LENS, MP * page)
    starts = np.arange(m.shape[2]) * 2 * page
    empty = torch.from_numpy(starts[None, :] >= lens[:, None])[:, None, :]
    empty = empty.expand_as(m)
    assert bool((m[empty] == tpa.NEG_INF).all() and (l[empty] == 0).all())
    assert bool((o[empty] == 0).all())
    assert bool((l[~empty] >= 1).all())


class _RecordingLibrary:
    """Stands in for the kernel library: records each entry point's name and
    arguments and returns 0 (success)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


@pytest.fixture
def recorded(monkeypatch):
    """The wrapper on meta tensors reaches its launch, which goes to a
    recording library instead of the card. Meta tensors hold no values:
    a wrapper that read the lengths would fail."""
    from ray_tpu_torch.ops import _build

    lib = _RecordingLibrary()
    monkeypatch.setattr(_build, "library", lambda name, signatures: lib)
    monkeypatch.setattr(tpa, "_KERNEL_DEVICE", "meta")
    monkeypatch.setattr(tpa, "_stream", lambda device: 0)
    return lib


def _meta(B=64, H=8, KV=4, D=128, page=16, P=1024, MP=16,
          dtype=torch.bfloat16):
    """The serving shapes by default, on the meta device."""
    return (torch.empty((B, H, D), dtype=dtype, device="meta"),
            torch.empty((P, KV, page, D), dtype=dtype, device="meta"),
            torch.empty((P, KV, page, D), dtype=dtype, device="meta"),
            torch.empty((B, MP), dtype=torch.int32, device="meta"),
            torch.empty((B,), dtype=torch.int32, device="meta"))


def test_wrapper_launch_at_the_serving_shape(recorded):
    """One wrapper call: one entry call with 2 pages per split (8 splits),
    a workspace, dtype code 1; the launch counter counts the call."""
    before = tpa.paged_attention.launches
    out = tpa.paged_attention(*_meta())
    assert tpa.paged_attention.launches == before + 1
    (name, args), = recorded.calls
    assert name == "paged_decode_attention" and len(args) == 17
    assert args[6] is not None                     # workspace
    # B, H, KV, D, page, MP, pages per split, dtype, device; stream
    assert args[7:] == (64, 8, 4, 128, 16, 16, 2, 1, 0, 0)
    assert out.shape == (64, 8, 128) and out.dtype == torch.float32


def test_wrapper_one_split_needs_no_workspace(recorded):
    tpa.paged_attention(*_meta(), pages_per_split=16)
    (_name, args), = recorded.calls
    assert args[6] is None and args[13] == 16
    recorded.calls.clear()
    tpa.paged_attention(*_meta(MP=1, dtype=torch.float32))
    (_name, args), = recorded.calls
    assert args[6] is None and args[12:15] == (1, 1, 0)


@pytest.mark.parametrize("B, KV, MP, page, elt, plan", [
    (64, 4, 16, 16, 2, (2, 8)),      # serving: 2048 blocks
    (64, 4, 16, 16, 4, (2, 8)),      # f32 pages: the same split
    (1, 4, 16, 16, 2, (1, 16)),      # one sequence: a split per page
    (64, 4, 7, 16, 2, (1, 7)),       # 1792 blocks at one page per split
    (256, 4, 16, 16, 2, (4, 4)),     # 8 pages would take 65 KiB: 48 KiB cap
    (1024, 4, 16, 16, 2, (4, 4)),    # the same cap
    (1024, 4, 64, 1, 2, (32, 2)),    # at most 32 pages (one lane each)
])
def test_split_plan_from_shapes(B, KV, MP, page, elt, plan):
    assert tpa.split_plan(B, 8, KV, MP, page, elt) == plan


def test_split_plan_reads_shapes_only(recorded):
    """split_plan takes shapes, not tensors; the wrapper's launch is the
    same whatever the lengths hold (here: none at all, on meta)."""
    params = list(inspect.signature(tpa.split_plan).parameters)
    assert params == ["B", "H", "KV", "MP", "page", "elt", "D"]
    for _ in range(2):
        tpa.paged_attention(*_meta())
    (_n1, a1), (_n2, a2) = recorded.calls
    assert a1 == a2


@pytest.mark.parametrize("kw, call, match", [
    (dict(H=16, KV=1), {}, "group <= 8"),
    (dict(D=320), {}, "head_dim"),
    (dict(page=256, dtype=torch.float32), {}, "shared memory"),
    ({}, dict(pages_per_split=17), "pages per split"),
    (dict(MP=40, page=4), dict(pages_per_split=33), "pages per split"),
    ({}, dict(pages_per_split=0), "pages per split"),
])
def test_wrapper_refuses_before_any_launch(recorded, kw, call, match):
    before = tpa.paged_attention.launches
    with pytest.raises(ValueError, match=match):
        tpa.paged_attention(*_meta(**kw), **call)
    assert not recorded.calls and tpa.paged_attention.launches == before


def test_split_smem_bytes():
    """The wrapper's count of a split block's shared memory (as the
    kernel's split_layout lays it out): the serving shape's 16,740 bytes;
    the largest f32 split at page 16 that fits an H100 block."""
    assert tpa.split_smem_bytes(2, 16, 2, 2) == (
        2 * 2 * 16 * 128 * 2 + 2 * 2 * 16 * 4 + 2 * 2 * 8 + 5 * 4)
    assert tpa.split_smem_bytes(14, 16, 2, 4) <= tpa.MAX_SMEM
    assert tpa.split_smem_bytes(15, 16, 2, 4) > tpa.MAX_SMEM
