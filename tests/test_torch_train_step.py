"""ray_tpu_torch.models.train_step against ray_tpu.models.train_step, on
the CPU.

Both sides start from the flax ``PRNGKey(0)`` init of the tiny f32 config
of tests/test_torch_transformer.py (loaded into the port through
``params_from_jax``) and train on the same numpy tokens; the JAX step is
jitted on the CPU, so both take the einsum attention path. Also mirrors
tests/test_models.py::TestForward, checks remat against no remat, the
chunked loss against the reference's, and the device rule.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import train_step as jts  # noqa: E402
from ray_tpu.models.transformer import Transformer as JTransformer  # noqa: E402
from ray_tpu.models.transformer import (  # noqa: E402
    TransformerConfig as JConfig)
from ray_tpu.models.transformer import (  # noqa: E402
    cross_entropy_loss as jcross_entropy)
from ray_tpu_torch._private import perf as tperf  # noqa: E402
from ray_tpu_torch.models import train_step as tts  # noqa: E402
from ray_tpu_torch.models import transformer as tt  # noqa: E402

TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq_len=128)


@pytest.fixture(scope="module")
def tiny():
    jcfg = JConfig(dtype=jnp.float32, **TINY)
    model = JTransformer(jcfg)
    jparams = model.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    params = tt.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       jparams))
    return model, jparams, params


def _port(params, **cfg):
    tcfg = tt.TransformerConfig(dtype=torch.float32, **{**TINY, **cfg})
    return tt.Transformer(tcfg, device="cpu").load_params(params)


def _tokens(high=64, shape=(4, 17)):
    return np.random.default_rng(0).integers(0, high, shape).astype(np.int32)


def test_three_steps_match_jax(tiny):
    """Loss and grad_norm per step to rtol 1e-4; parameters after three
    AdamW steps to atol 1e-4. Adam divides by sqrt(v): for a parameter
    whose gradient is near zero, float noise in the gradient is amplified
    in its update, so the parameters get the looser absolute bound."""
    model, jparams, params = tiny
    tokens = _tokens()
    jopt = jts.make_optimizer(learning_rate=1e-2)
    jstep = jax.jit(jts.make_train_step(model, jopt))
    jstate, jp = jopt.init(jparams), jparams
    net = _port(params)
    step = tts.make_train_step(net, tts.make_optimizer(net.parameters(),
                                                       learning_rate=1e-2))
    for i in range(3):
        jp, jstate, jm = jstep(jp, jstate, {"tokens": jnp.asarray(tokens)})
        m = step({"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4,
                                   err_msg=f"grad_norm, step {i}")
    got = {k.replace(".", "/"): v.detach().numpy()
           for k, v in net.state_dict().items()}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        key = "/".join(p.key for p in path)
        np.testing.assert_allclose(got[key], np.asarray(leaf), atol=1e-4,
                                   err_msg=key)


def _loss_and_grads(net, tokens):
    net.zero_grad(set_to_none=True)
    logits = net(tokens[:, :-1])
    loss = tt.cross_entropy_loss(logits, tokens[:, 1:])
    loss.backward()
    grads = {k: p.grad.clone() for k, p in net.named_parameters()}
    return float(loss.detach()), grads


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_matches_no_remat(tiny, policy):
    _model, _jparams, params = tiny
    tokens = torch.from_numpy(_tokens())
    loss, grads = _loss_and_grads(_port(params), tokens)
    r_loss, r_grads = _loss_and_grads(
        _port(params, remat=True, remat_policy=policy), tokens)
    assert abs(r_loss - loss) <= 1e-6
    assert sorted(r_grads) == sorted(grads)
    for key, g in grads.items():
        np.testing.assert_allclose(r_grads[key].numpy(), g.numpy(),
                                   atol=1e-6, err_msg=key)


def test_loss_decreases(tiny):
    _model, _jparams, params = tiny
    net = _port(params)
    step = tts.make_train_step(net, tts.make_optimizer(net.parameters(),
                                                       learning_rate=1e-2))
    tokens = torch.from_numpy(_tokens(high=32))   # learnable range
    losses = [float(step({"tokens": tokens})["loss"]) for _ in range(8)]
    assert losses[-1] < losses[0] * 0.9, losses


def test_causality(tiny):
    """Changing a future token must not change earlier logits."""
    _model, _jparams, params = tiny
    fwd = tts.make_forward(_port(params))
    t1 = _tokens(shape=(1, 16))
    t2 = t1.copy()
    t2[0, -1] = (t2[0, -1] + 1) % TINY["vocab_size"]
    l1 = fwd(torch.from_numpy(t1)).numpy()
    l2 = fwd(torch.from_numpy(t2)).numpy()
    assert l1.shape == (1, 16, TINY["vocab_size"])
    np.testing.assert_allclose(l1[0, :-1], l2[0, :-1], atol=1e-4)
    assert not np.allclose(l1[0, -1], l2[0, -1], atol=1e-4)


def test_cross_entropy_matches_uniform():
    loss = tt.cross_entropy_loss(torch.zeros((1, 4, 10)),
                                 torch.zeros((1, 4), dtype=torch.int64))
    np.testing.assert_allclose(float(loss), np.log(10), rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax_over_chunks(monkeypatch, masked):
    """The chunked loss (3 rows per chunk here) and its gradient equal the
    reference's logsumexp formulation."""
    monkeypatch.setattr(tt, "_chunk_rows", lambda flat: 3)
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32) if masked else None
    t_logits = torch.from_numpy(logits).requires_grad_()
    loss = tt.cross_entropy_loss(
        t_logits, torch.from_numpy(targets),
        None if mask is None else torch.from_numpy(mask))
    loss.backward()
    jmask = None if mask is None else jnp.asarray(mask)
    want, jgrad = jax.value_and_grad(
        lambda x: jcross_entropy(x, jnp.asarray(targets), jmask))(
            jnp.asarray(logits))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(t_logits.grad.numpy(), np.asarray(jgrad),
                               atol=1e-7)


def test_model_mfu_on_cpu_returns_the_reference_keys():
    r = tperf.model_mfu(d_model=32, n_layers=1, n_heads=4, n_kv_heads=2,
                        d_ff=64, vocab_size=64, seq_len=16, batch_size=2,
                        steps=2, device="cpu")
    # the keys ray_tpu/_private/perf.py::model_mfu returns
    ref_keys = {"device", "platform", "n_params", "batch_size", "seq_len",
                "step_ms", "tokens_per_sec", "flops_per_step",
                "model_flops_per_step", "model_flops_per_sec",
                "hardware_flops_per_sec", "peak_flops", "mfu", "hfu",
                "loss"}
    assert ref_keys <= set(r)
    assert r["platform"] == "cpu" and r["mfu"] is None
    assert r["batch_size"] == 2 and np.isfinite(r["loss"])
    assert r["flops_per_step"] == 6.0 * r["n_params"] * 2 * 16


def test_entry_points_without_device_need_cuda(tiny):
    """No device means the card: without one, the model and model_mfu
    raise instead of quietly allocating on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = tt.TransformerConfig(dtype=torch.float32, **TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.Transformer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tperf.model_mfu(smoke=True)


def test_model_from_params_without_device_needs_cuda(tiny):
    """model_from_params with no device means the card, as Transformer(cfg)
    does, even for params on the host (params_from_jax returns CPU
    tensors): without a card it raises instead of building a CPU model."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _model, _jparams, params = tiny
    cfg = tt.TransformerConfig(dtype=torch.float32, **TINY)
    assert all(p.device.type == "cpu" for p in params.values())
    with pytest.raises(RuntimeError, match="model_from_params.*CUDA"):
        tt.model_from_params(cfg, params)


def test_explicit_devices_are_kept(tiny):
    _model, _jparams, params = tiny
    cfg = tt.TransformerConfig(dtype=torch.float32, **TINY)
    net = tt.model_from_params(cfg, params, device="cpu")
    assert all(p.device.type == "cpu" and p.requires_grad
               for p in net.parameters())
    x = torch.zeros((1, 4, TINY["d_model"]))
    assert not tt._flash_supported(x, 128)
