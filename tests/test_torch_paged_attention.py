"""ray_tpu_torch.ops.paged_attention against the JAX reference package.

The port's plain paged attention (the CPU path of its wrapper, and the
oracle its CUDA kernel is held against on the card by chip_smoke.py) must
match JAX's Pallas kernel in interpret mode and JAX's XLA reference; the
page-cache writers must match JAX's exactly. Inputs come from numpy with a
seed and go to both sides.
"""

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
