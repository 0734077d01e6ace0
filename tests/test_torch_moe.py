"""ray_tpu_torch.ops.moe and the MoE transformer against ray_tpu's, on the CPU.

The same seeded numpy inputs go through ``ray_tpu.ops.moe`` and the port's
counterpart: the routing (``top1_dispatch``), the single-device expert FFN
(``moe_ffn_reference``), and the flagship model with ``moe=True`` (flax's
init loaded through ``params_from_jax``), forward and one train step with
the aux load-balancing term in the loss. Bounds: f32 routing exact and
combine/aux to 1e-6, the FFN to 1e-5, the model to 2e-4 (the bound
tests/test_pipeline_moe.py holds its own model paths to), the train step
to tests/test_torch_train_step.py's rtol 1e-4.
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
from ray_tpu.ops import moe as jmoe  # noqa: E402
from ray_tpu_torch.models import train_step as tts  # noqa: E402
from ray_tpu_torch.models import transformer as tt  # noqa: E402
from ray_tpu_torch.ops import moe as tmoe  # noqa: E402

T, D, F, E = 96, 16, 32, 4
MOE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=64, max_seq_len=128, moe=True, moe_num_experts=4,
           moe_capacity_factor=1.25)
# share of bf16 tokens both packages must route to the same expert: the two
# softmaxes round differently in bf16, and with experts near-equally likely
# a one-ulp change can flip the argmax
BF16_SAME_ROUTE = 0.9


def _weights(seed=0, d=D, f=F, e=E):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(d, e)).astype(np.float32),
            (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32),
            (rng.normal(size=(e, f, d)) / np.sqrt(f)).astype(np.float32))


def _tokens(seed=1, t=T, d=D):
    return np.random.default_rng(seed).normal(size=(t, d)).astype(np.float32)


@pytest.mark.parametrize("cf", [0.5, 1.0, 8.0])
def test_top1_dispatch_matches_jax(cf):
    logits = np.random.default_rng(3).normal(size=(T, E)).astype(np.float32)
    cap = tmoe.capacity(T, E, cf)
    assert cap == max(1, int(T * cf / E))
    jd, jc, ja = jmoe.top1_dispatch(jnp.asarray(logits), cap)
    d, c, a = tmoe.top1_dispatch(torch.from_numpy(logits), cap)
    assert d.dtype == c.dtype == a.dtype == torch.float32
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(float(a), float(ja), atol=1e-6)
    if cf < 1.0:
        assert d.sum() < T   # tokens were dropped


def test_capacity_drops_overflow():
    """tests/test_pipeline_moe.py::test_capacity_drops_overflow: every token
    prefers expert 0 and capacity 2 keeps only the first two."""
    logits = torch.tensor([[10.0, 0.0]]).repeat(5, 1)
    dispatch, combine, _aux = tmoe.top1_dispatch(logits, capacity=2)
    np.testing.assert_allclose(dispatch.sum(dim=(1, 2)).numpy(),
                               [1, 1, 0, 0, 0])
    assert dispatch[0, 0, 0] == 1 and dispatch[1, 0, 1] == 1
    assert float(combine[:2].sum()) == pytest.approx(
        2 * float(torch.softmax(logits[0], -1)[0]))


@pytest.mark.parametrize("cf", [1.0, 1.25, 8.0])
def test_moe_ffn_reference_matches_jax(cf):
    router, w_in, w_out = _weights()
    x = _tokens()
    jy, ja = jmoe.moe_ffn_reference(jnp.asarray(x), jnp.asarray(router),
                                    jnp.asarray(w_in), jnp.asarray(w_out), cf)
    y, a = tmoe.moe_ffn_reference(*map(torch.from_numpy,
                                       (x, router, w_in, w_out)), cf)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(float(a), float(ja), atol=1e-6)


def test_moe_ffn_bf16_routes_mostly_alike():
    """bf16 tokens and weights, as the model passes them: the FFN still
    runs in f32 (the result is f32 in both). The logits agree bit for
    bit; routing agrees on at least BF16_SAME_ROUTE of the tokens (all 512
    at this seed). With capacity for every token (cf 8), a token routed
    alike gets its expert's same f32 output scaled by its bf16 gate
    probability, which the two softmaxes may round one ulp apart: each
    element within 2^-7 of the reference's, relative, plus 1e-5 for the
    f32 products' order."""
    router, w_in, w_out = _weights(seed=4)
    x = _tokens(seed=5, t=512)
    bf = [v.astype(jnp.bfloat16) for v in map(jnp.asarray,
                                              (x, router, w_in, w_out))]
    jy, _ = jmoe.moe_ffn_reference(*bf, 8.0)
    tb = [torch.from_numpy(v).to(torch.bfloat16)
          for v in (x, router, w_in, w_out)]
    y, _ = tmoe.moe_ffn_reference(*tb, 8.0)
    assert y.dtype == torch.float32 and jy.dtype == jnp.float32
    jprobs = jax.nn.softmax(bf[0] @ bf[1], axis=-1)
    tprobs = torch.softmax(tb[0] @ tb[1], dim=-1)
    same = np.asarray(jnp.argmax(jprobs, -1)) == tprobs.argmax(-1).numpy()
    share = same.mean()
    assert share >= BF16_SAME_ROUTE, share
    jy = np.asarray(jy)[same]
    got = y.numpy()[same]
    assert (np.abs(got - jy) <= 2.0 ** -7 * np.abs(jy) + 1e-5).all()


def test_sharded_paths_raise():
    """The shard_map body runs only on the ranks of a mesh that spans
    processes, and the global entry needs token rows that split over the
    expert axis (MoEMLP pads them); on a local-device mesh the entry routes
    each shard as JAX's does (tests/test_torch_sharded_ops.py holds the
    rank path)."""
    from ray_tpu.parallel import mesh as jmesh
    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    router, w_in, w_out = (torch.from_numpy(w) for w in _weights(seed=2))
    x = torch.from_numpy(_tokens(seed=4))
    with pytest.raises(RuntimeError, match="spans ranks"):
        tmoe.moe_ffn_local(x, router, w_in, w_out, 2.0)
    mesh = make_mesh(MeshConfig(expert=4), ["cpu"] * 4)
    with pytest.raises(ValueError, match="split"):
        tmoe.moe_ffn_sharded(x[:-1], router, w_in, w_out, mesh)
    y, aux = tmoe.moe_ffn_sharded(x, router, w_in, w_out, mesh,
                                  capacity_factor=2.0)
    jm = jmesh.make_mesh(jmesh.MeshConfig(expert=4), jax.devices()[:4])
    with jm:
        jy, jaux = jax.jit(lambda *a: jmoe.moe_ffn_sharded(
            *a, jm, capacity_factor=2.0))(*(jnp.asarray(t.numpy()) for t in (
                x, router, w_in, w_out)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_model():
    jcfg = JConfig(dtype=jnp.float32, **MOE)
    model = JTransformer(jcfg)
    jparams = model.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    params = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return model, jparams, params


def _port(params, **cfg):
    tcfg = tt.TransformerConfig(dtype=torch.float32, **{**MOE, **cfg})
    return tt.Transformer(tcfg, device="cpu").load_params(params)


def _batch(shape=(2, 17), seed=0):
    return np.random.default_rng(seed).integers(
        0, MOE["vocab_size"], shape).astype(np.int32)


def test_param_names_match_flax(moe_model):
    _model, _jparams, params = moe_model
    assert params["layer_0/MoEMLP_0/router"].shape == (32, 4)
    assert params["layer_0/MoEMLP_0/w_in"].shape == (4, 32, 64)
    assert params["layer_0/MoEMLP_0/w_out"].shape == (4, 64, 32)
    init = tt.init_params(tt.TransformerConfig(**MOE),
                          torch.Generator().manual_seed(0), device="cpu")
    assert {k: v.shape for k, v in init.items()} == {
        k: v.shape for k, v in params.items()}


def test_moe_model_logits_and_aux_match_flax(moe_model):
    model, jparams, params = moe_model
    tokens = _batch(shape=(2, 16))
    jlogits, mods = model.apply({"params": jparams}, jnp.asarray(tokens),
                                mutable=["intermediates"])
    jaux = jax.tree_util.tree_leaves(mods["intermediates"])
    logits, aux = _port(params)(torch.from_numpy(tokens).long(),
                                return_aux=True)
    assert len(aux) == len(jaux) == MOE["n_layers"]
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose([float(a.detach()) for a in aux],
                               [float(a) for a in jaux], atol=1e-6)


def test_moe_train_step_matches_jax(moe_model):
    """Loss (the aux term included) and grad norm of two AdamW steps."""
    model, jparams, params = moe_model
    tokens = _batch()
    jopt = jts.make_optimizer(learning_rate=1e-2)
    jstep = jax.jit(jts.make_train_step(model, jopt))
    jstate, jp = jopt.init(jparams), jparams
    net = _port(params)
    step = tts.make_train_step(net, tts.make_optimizer(net.parameters(),
                                                       learning_rate=1e-2))
    for i in range(2):
        jp, jstate, jm = jstep(jp, jstate, {"tokens": jnp.asarray(tokens)})
        m = step({"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4,
                                   err_msg=f"grad_norm, step {i}")


def test_train_step_loss_adds_aux(moe_model):
    """The step's loss is ce + 0.01 × Σ mean(aux) on the same params."""
    _model, _jparams, params = moe_model
    net = _port(params)
    tokens = torch.from_numpy(_batch()).long()
    with torch.no_grad():
        logits, aux = net(tokens[:, :-1], return_aux=True)
        want = (tt.cross_entropy_loss(logits, tokens[:, 1:])
                + 0.01 * sum(a.mean() for a in aux))
    step = tts.make_train_step(net, tts.make_optimizer(net.parameters()))
    assert float(step({"tokens": tokens})["loss"]) == float(want)


def _loss_aux_grads(net, tokens):
    net.zero_grad(set_to_none=True)
    logits, aux = net(tokens[:, :-1], return_aux=True)
    loss = (tt.cross_entropy_loss(logits, tokens[:, 1:])
            + 0.01 * sum(a.mean() for a in aux))
    loss.backward()
    return (float(loss), [float(a) for a in aux],
            {k: p.grad.clone() for k, p in net.named_parameters()})


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_same_loss_and_aux(moe_model, policy):
    """Under remat each block's aux is a checkpoint output: the recompute
    in backward adds no second term, and loss, aux and gradients equal
    the run without remat."""
    _model, _jparams, params = moe_model
    tokens = torch.from_numpy(_batch()).long()
    loss, aux, grads = _loss_aux_grads(_port(params), tokens)
    r_loss, r_aux, r_grads = _loss_aux_grads(
        _port(params, remat=True, remat_policy=policy), tokens)
    assert (r_loss, r_aux) == (loss, aux)
    assert len(r_aux) == MOE["n_layers"]
    for key, g in grads.items():
        np.testing.assert_allclose(r_grads[key].numpy(), g.numpy(),
                                   atol=1e-6, err_msg=key)


def test_dense_loss_is_unchanged():
    """A dense model has no aux term: the step's loss is the cross-entropy
    alone, bit for bit."""
    cfg = tt.TransformerConfig(dtype=torch.float32,
                               **{**MOE, "moe": False})
    params = tt.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    net = tt.Transformer(cfg, device="cpu").load_params(params)
    tokens = torch.from_numpy(_batch()).long()
    with torch.no_grad():
        logits, aux = net(tokens[:, :-1], return_aux=True)
        want = tt.cross_entropy_loss(logits, tokens[:, 1:])
    assert aux == []
    step = tts.make_train_step(net, tts.make_optimizer(net.parameters()))
    assert float(step({"tokens": tokens})["loss"]) == float(want)


def test_expert_mesh_raises(moe_model):
    """Under a mesh with expert=2 the model takes the expert-parallel entry
    (its rows padded to a multiple of 2: 2 x 17 tokens) and equals JAX's
    model under the same mesh; nothing raises any more."""
    from ray_tpu.parallel import mesh as jmesh
    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh, use_mesh

    model, jparams, params = moe_model
    net = _port(params)
    tokens = torch.from_numpy(_batch()).long()
    with use_mesh(make_mesh(MeshConfig(expert=2), ["cpu"] * 2)):
        got = net(tokens)
    jm = jmesh.make_mesh(jmesh.MeshConfig(expert=2), jax.devices()[:2])
    with jmesh.use_mesh(jm):
        want = jax.jit(lambda p, t: model.apply({"params": p}, t))(
            jparams, jnp.asarray(_batch()))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-4, rtol=2e-4)
    # a mesh without an expert axis runs the single-device path
    with use_mesh(make_mesh(MeshConfig(data=2), ["cpu"] * 2)):
        assert torch.isfinite(net(tokens)).all()
