"""ray_tpu_torch.ops.flash against the JAX package, on the CPU.

The library Pallas flash kernel the reference calls has no interpret mode,
so the JAX oracle is ``ray_tpu.ops.ring_attention.attention_reference``
(plain attention, f32) and ``jax.vjp`` of it. On the CPU the port's
``_FlashAttention`` runs the plain version of each of its three kernels
(forward, dq, dk/dv) — the functions the CUDA kernels are held against on
the card — so these tests check those formulas and the Function's wiring
(saved tensors, ``di``, layouts, GQA through the model's repeat). f32
throughout; the bound is 1e-5 absolute: the same sums in another order.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.ops.ring_attention import attention_reference  # noqa: E402
from ray_tpu_torch.ops import flash as tf  # noqa: E402

ATOL = 1e-5
B, H = 2, 4
CASES = [(16, 8), (37, 8), (16, 128), (37, 128)]   # (S, head_dim)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _inputs(S, D, kv_heads=H, seed=0):
    rng = np.random.default_rng(seed)
    return (_normal(rng, B, S, H, D), _normal(rng, B, S, kv_heads, D),
            _normal(rng, B, S, kv_heads, D), _normal(rng, B, S, H, D))


def _torch_grads(fn, arrays, cotangent):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    (out * torch.from_numpy(cotangent)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,D", CASES)
def test_forward_matches_attention_reference(S, D, causal):
    q, k, v, _do = _inputs(S, D)
    got = tf.flash_attention_bshk(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal)
    want = attention_reference(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal)
    assert got.shape == (B, S, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,D", CASES)
def test_gradients_match_jax(S, D, causal):
    q, k, v, do = _inputs(S, D)
    _out, grads = _torch_grads(
        lambda a, b, c: tf.flash_attention_bshk(a, b, c, causal), (q, k, v),
        do)
    _o, vjp = jax.vjp(lambda a, b, c: attention_reference(a, b, c, causal),
                      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, got, want in zip("qkv", grads, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("S,D", CASES)
def test_backward_formulas_equal_autograd(S, D):
    """The plain versions of the dq and dk/dv kernels, given lse from the
    forward's and di = rowsum(o * do), equal autograd through the plain
    attention — the CPU check of what the backward kernels compute."""
    q, k, v, do = (torch.from_numpy(a).transpose(1, 2).contiguous()
                   for a in _inputs(S, D))
    o, lse = tf._flash_fwd_reference(q, k, v, causal=True)
    di = (o * do).sum(-1)
    dq = tf._flash_bwd_dq_reference(q, k, v, do, lse, di, causal=True)
    dk, dv = tf._flash_bwd_dkv_reference(q, k, v, do, lse, di, causal=True)

    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    want_o = tf.flash_attention_reference(*ts, causal=True)
    (want_o * do).sum().backward()
    np.testing.assert_allclose(o.numpy(), want_o.detach().numpy(), atol=ATOL)
    want_lse = torch.logsumexp(tf._scores(q, k, True), -1)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=ATOL)
    # row 0 sees only key 0: lse is its own scaled score
    np.testing.assert_allclose(
        lse[:, :, 0].numpy(),
        ((q[:, :, 0] * k[:, :, 0]).sum(-1) / np.sqrt(D)).numpy(), atol=ATOL)
    for name, got, t in zip("qkv", (dq, dk, dv), ts):
        np.testing.assert_allclose(got.numpy(), t.grad.numpy(), atol=ATOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("S", [16, 37])
def test_gqa_dk_dv_through_the_model_repeat(S):
    """Two query heads per KV head: the model repeats K/V (head j reads KV
    head j // 2) before the call; autograd sums each group's gradient into
    its KV head, as jax.vjp through jnp.repeat does."""
    q, k, v, do = _inputs(S, 128, kv_heads=H // 2, seed=1)

    def port(a, b, c):
        return tf.flash_attention_bshk(a, torch.repeat_interleave(b, 2, 2),
                                       torch.repeat_interleave(c, 2, 2))

    def ref(a, b, c):
        return attention_reference(a, jnp.repeat(b, 2, axis=2),
                                   jnp.repeat(c, 2, axis=2), True)

    out, grads = _torch_grads(port, (q, k, v), do)
    want_o, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k),
                          jnp.asarray(v))
    np.testing.assert_allclose(out, np.asarray(want_o), atol=ATOL)
    for name, got, want in zip("qkv", grads, vjp(jnp.asarray(do))):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL,
                                   err_msg=f"d{name}")


def test_cpu_path_launches_no_kernel():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(16, 128))
    before = (tf.flash_fwd.launches, tf.flash_bwd_dq.launches,
              tf.flash_bwd_dkv.launches)
    q.requires_grad_()
    (tf.flash_attention_bshk(q, k, v) * do).sum().backward()
    assert (tf.flash_fwd.launches, tf.flash_bwd_dq.launches,
            tf.flash_bwd_dkv.launches) == before


def test_wrappers_raise_off_cpu_without_a_kernel():
    """No fallback: a tensor that is not on the CPU gets the kernel or an
    error, never the plain version."""
    q = torch.empty((1, 2, 16, 128), device="meta")
    rows = torch.empty((1, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tf.flash_fwd(q, q, q)
    with pytest.raises(ValueError, match="no kernel"):
        tf.flash_bwd_dq(q, q, q, q, rows, rows)
    with pytest.raises(ValueError, match="no kernel"):
        tf.flash_bwd_dkv(q, q, q, q, rows, rows)


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
    """The wrappers on meta tensors reach their launches, which go to a
    recording library instead of the card."""
    from ray_tpu_torch.ops import _build

    lib = _RecordingLibrary()
    monkeypatch.setattr(_build, "library", lambda name, signatures: lib)
    monkeypatch.setattr(tf, "_KERNEL_DEVICE", "meta")
    monkeypatch.setattr(tf, "_stream", lambda device: 0)
    return lib


def _model_view(dtype, S=37, heads=4, batch=2):
    """The model's [B, S, H, 128] activations as the [B, H, S, 128] view
    the flash branch passes."""
    return torch.empty((batch, S, heads, 128), dtype=dtype,
                       device="meta").transpose(1, 2)


def test_bf16_forward_reaches_the_sm90_entry_with_byte_strides(recorded):
    q, k, v = (_model_view(torch.bfloat16) for _ in range(3))
    before = tf.flash_fwd.launches
    o, lse = tf.flash_fwd(q, k, v)
    assert tf.flash_fwd.launches == before + 1
    (name, args), = recorded.calls
    assert name == "flash_attention_fwd_bf16"
    # B, H, S, D; byte strides of [B, S, H, D] bf16; causal, device, stream
    assert args[5:] == (2, 4, 37, 128, 37 * 4 * 256, 256, 1024, 1, 0, 0)
    assert o.dtype == torch.bfloat16 and o.stride() == q.stride()
    assert lse.shape == (2, 4, 37) and lse.dtype == torch.float32


_BACKWARD = ("flash_bwd_dq", "flash_bwd_dkv")


def _call(kernel, dtype):
    """One wrapper on the model's [B, 37, 4, 128] views: the forward on
    (q, k, v), a backward kernel on (q, k, v, do, lse, di) whose lse/di head
    rows are 37 * 4 = 148 bytes apart (not 16-byte aligned)."""
    q, k, v, do = (_model_view(dtype) for _ in range(4))
    if kernel == "flash_fwd":
        return tf.flash_fwd(q, k, v)
    rows = torch.empty((2, 4, 37), device="meta")
    return getattr(tf, kernel)(q, k, v, do, rows, rows)


@pytest.mark.parametrize("dtype, kernel, entry, n_ptrs, tail", [
    # bf16 backward: the bf16 entries, byte strides of [B, S, H, D] bf16,
    # no dtype code; causal, device, stream
    (torch.bfloat16, "flash_bwd_dq", "flash_attention_bwd_dq_bf16", 7,
     (37 * 4 * 256, 256, 1024, 1, 0, 0)),
    (torch.bfloat16, "flash_bwd_dkv", "flash_attention_bwd_dkv_bf16", 8,
     (37 * 4 * 256, 256, 1024, 1, 0, 0)),
    # f32: the FMA entries, element strides, dtype code 0
    (torch.float32, "flash_fwd", "flash_attention_fwd", 5,
     (37 * 4 * 128, 128, 512, 1, 0, 0, 0)),
    (torch.float32, "flash_bwd_dq", "flash_attention_bwd_dq", 7,
     (37 * 4 * 128, 128, 512, 1, 0, 0, 0)),
    (torch.float32, "flash_bwd_dkv", "flash_attention_bwd_dkv", 8,
     (37 * 4 * 128, 128, 512, 1, 0, 0, 0))])
def test_kernels_reach_their_entries(recorded, dtype, kernel, entry, n_ptrs,
                                     tail):
    """bf16 dq and dk/dv reach the bf16 entries with byte strides; f32
    stays on the FMA entries. Each wrapper counts one launch and returns
    outputs in q's dtype and strides."""
    wrapper = getattr(tf, kernel)
    before = wrapper.launches
    outs = _call(kernel, dtype)
    assert wrapper.launches == before + 1
    (name, args), = recorded.calls
    assert name == entry and len(args) == n_ptrs + 4 + len(tail)
    assert args[n_ptrs:] == (2, 4, 37, 128, *tail)
    q = _model_view(dtype)
    outs = (outs,) if kernel == "flash_bwd_dq" else outs
    mats = outs if kernel != "flash_fwd" else outs[:1]
    assert all(o.dtype == dtype and o.stride() == q.stride() for o in mats)


def test_bf16_forward_rejects_strides_tma_cannot_take(recorded):
    """A zero head stride (an expanded tensor) raises ValueError before any
    launch; nothing else runs in the kernel's place."""
    q = torch.empty((2, 1, 37, 128), dtype=torch.bfloat16,
                    device="meta").expand(2, 4, 37, 128)
    before = tf.flash_fwd.launches
    with pytest.raises(ValueError, match="TMA"):
        tf.flash_fwd(q, q, q)
    assert not recorded.calls and tf.flash_fwd.launches == before


@pytest.mark.parametrize("kernel", _BACKWARD)
def test_bf16_backward_rejects_strides_tma_cannot_take(recorded, kernel):
    """The bf16 backward reads q, k, v and do through TMA: a zero head
    stride raises ValueError before any launch, and no launch is counted."""
    q = torch.empty((2, 1, 37, 128), dtype=torch.bfloat16,
                    device="meta").expand(2, 4, 37, 128)
    rows = torch.empty((2, 4, 37), device="meta")
    wrapper = getattr(tf, kernel)
    before = wrapper.launches
    with pytest.raises(ValueError, match="TMA"):
        wrapper(q, q, q, q, rows, rows)
    assert not recorded.calls and wrapper.launches == before


@pytest.mark.parametrize("kernel", ["flash_fwd", *_BACKWARD])
def test_f32_refuses_overlapping_inputs(recorded, kernel):
    """The outputs take q's strides; an expanded q (head stride 0) has
    strides no output can be allocated with, so the wrappers raise before
    any launch rather than let every head write one place."""
    q = torch.empty((2, 1, 37, 128), dtype=torch.float32,
                    device="meta").expand(2, 4, 37, 128)
    rows = torch.empty((2, 4, 37), device="meta")
    wrapper = getattr(tf, kernel)
    before = wrapper.launches
    with pytest.raises(ValueError, match="overlap"):
        if kernel == "flash_fwd":
            wrapper(q, q, q)
        else:
            wrapper(q, q, q, q, rows, rows)
    assert not recorded.calls and wrapper.launches == before
