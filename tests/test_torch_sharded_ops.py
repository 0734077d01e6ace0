"""Ring attention, expert-parallel MoE and the pipeline across 4 gloo ranks
against ray_tpu's shard_map programs, on the CPU.

Mirrors ``tests/test_ring_attention.py`` (TestRing, TestModelIntegration)
and ``tests/test_pipeline_moe.py`` (TestPipeline, TestMoE, TestMoEModel):
the port's global entries (``ring_attention_sharded``, ``moe_ffn_sharded``,
``pipeline_forward``) run in 4 rank processes (tests/test_torch_sharded.py
``run_ranks``) on a ``RankMesh``, each rank calling them with the same
global inputs; JAX runs the same entries on a mesh of the same shape over
4 of the 8 virtual CPU devices, from the same seeded numpy inputs. Every
rank's result is checked. Bounds, the reference tests' own: the ring 2e-5
(its gradient too), the model with the ring 3e-4; MoE 1e-5 against the
per-shard reference, 2e-4 for the model with ample capacity; the pipeline
1e-5, its gradients 1e-4.
"""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models.transformer import Transformer as JTransformer  # noqa: E402
from ray_tpu.models.transformer import (  # noqa: E402
    TransformerConfig as JConfig)
from ray_tpu.ops import moe as jmoe  # noqa: E402
from ray_tpu.ops.pipeline import pipeline_forward as jpipeline  # noqa: E402
from ray_tpu.parallel import mesh as jmesh  # noqa: E402

from test_torch_sharded import run_ranks  # noqa: E402

jra = importlib.import_module("ray_tpu.ops.ring_attention")

RING_TOL = 2e-5
RING_MODEL_TOL = 3e-4
MOE_TOL = 1e-5
MOE_MODEL_TOL = 2e-4
PIPE_TOL, PIPE_GRAD_TOL = 1e-5, 1e-4

# (mesh, B, S, H, Hkv, causal, seed): the meshes cover seq alone, heads
# split over tensor, and the batch split over data
RINGS = {
    "seq4_causal": (dict(seq=4), 2, 64, 4, 4, True, 0),
    "seq4_non_causal": (dict(seq=4), 2, 32, 4, 4, False, 3),
    "seq4_gqa": (dict(seq=4), 2, 64, 4, 2, True, 7),
    "seq2_tensor2_gqa": (dict(seq=2, tensor=2), 2, 64, 4, 2, True, 8),
    "data2_seq2": (dict(data=2, seq=2), 2, 64, 4, 2, True, 9),
}
RING_MODEL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                  n_kv_heads=2, d_ff=176, max_seq_len=64)
MOE_MODEL = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4,
                 n_kv_heads=2, d_ff=64, max_seq_len=64, moe=True,
                 moe_num_experts=4, moe_capacity_factor=8.0)


def _jmesh(cfg):
    return jmesh.make_mesh(jmesh.MeshConfig(**cfg), jax.devices()[:4])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}|{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v, np.float32)
    return out


_BODY = '''
from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.ops import moe as tmoe
from ray_tpu_torch.ops import ring_attention as tra
from ray_tpu_torch.ops.pipeline import pipeline_forward
from ray_tpu_torch.parallel.mesh import MeshConfig, use_mesh

RINGS = {rings!r}
RING_MODEL = {ring_model!r}
MOE_MODEL = {moe_model!r}

def t(a, grad=False):
    x = torch.from_numpy(np.ascontiguousarray(a))
    return x.requires_grad_() if grad else x

def params(inputs, prefix):
    return {{k[len(prefix):].replace("|", "/"): t(v)
             for k, v in inputs.items() if k.startswith(prefix)}}

def main(rank, world, inputs):
    out = {{}}
    meshes = {{}}
    def mesh(cfg):
        key = tuple(sorted(cfg.items()))
        if key not in meshes:
            meshes[key] = distributed.global_mesh(MeshConfig(**cfg))
        return meshes[key]
    for name, (cfg, B, S, H, KV, causal, seed) in RINGS.items():
        q, k, v = (t(inputs[f"ring/{{name}}/{{x}}"], True) for x in "qkv")
        o = tra.ring_attention_sharded(q, k, v, mesh(cfg), causal=causal)
        (o * t(inputs[f"ring/{{name}}/w"])).sum().backward()
        out[f"ring/{{name}}"] = o.detach().numpy()
        out[f"ring/{{name}}/grads"] = [x.grad.numpy() for x in (q, k, v)]
    # causality across ranks: the last 16 keys changed, earlier rows equal
    q, k, v = (t(inputs[f"ring/seq4_causal/{{x}}"]) for x in "qkv")
    k2, v2 = k.clone(), v.clone()
    k2[:, 48:] = t(inputs["ring/perturb"])
    v2[:, 48:] = 0.0
    o1, o2 = (tra.ring_attention_sharded(q, a, b, mesh(dict(seq=4)))
              for a, b in ((k, v), (k2, v2)))
    out["ring/causality"] = (torch.equal(o1[:, :48], o2[:, :48]),
                             not torch.equal(o1[:, 48:], o2[:, 48:]))
    # the flagship-family model with ring attention on seq=2 x tensor=2
    cfg = tt.TransformerConfig(dtype=torch.float32, ring_attention=True,
                               **RING_MODEL)
    model = tt.Transformer(cfg, device="cpu").load_params(
        params(inputs, "ring_model/"))
    with use_mesh(mesh(dict(seq=2, tensor=2))), torch.no_grad():
        out["ring_model"] = model(t(inputs["ring_tokens"]).long()).numpy()
    # MoE: the global entry on expert=4, and its gradient
    router, w_in, w_out = (t(inputs[f"moe/{{x}}"], True)
                           for x in ("router", "w_in", "w_out"))
    tokens = t(inputs["moe/tokens"])
    y, aux = tmoe.moe_ffn_sharded(tokens, router, w_in, w_out,
                                  mesh(dict(expert=4)), capacity_factor=2.0)
    (y.pow(2).sum() + 0.01 * aux).backward()
    out["moe"] = (y.detach().numpy(), float(aux))
    out["moe/grads"] = [x.grad.numpy() for x in (router, w_in, w_out)]
    cfg = tt.TransformerConfig(dtype=torch.float32, **MOE_MODEL)
    model = tt.Transformer(cfg, device="cpu").load_params(
        params(inputs, "moe_model/"))
    with use_mesh(mesh(dict(expert=4))), torch.no_grad():
        out["moe_model"] = model(t(inputs["moe_tokens"]).long()).numpy()
    # the pipeline over pipe=4, forward and gradients
    w, b = t(inputs["pipe/w"], True), t(inputs["pipe/b"], True)
    xs = t(inputs["pipe/xs"])
    stage = lambda p, x: torch.tanh(x @ p["w"] + p["b"])
    y = pipeline_forward(stage, {{"w": w, "b": b}}, xs, mesh(dict(pipe=4)))
    y.pow(2).sum().backward()
    out["pipe"] = y.detach().numpy()
    out["pipe/grads"] = (w.grad.numpy(), b.grad.numpy())
    return out
'''


@pytest.fixture(scope="module")
def rank_run(tmp_path_factory):
    inputs, want = {}, {}
    for name, (cfg, B, S, H, KV, causal, seed) in RINGS.items():
        rng = np.random.default_rng(seed)
        q = (rng.normal(size=(B, S, H, 32)) * 0.3).astype(np.float32)
        k = (rng.normal(size=(B, S, KV, 32)) * 0.3).astype(np.float32)
        v = (rng.normal(size=(B, S, KV, 32)) * 0.3).astype(np.float32)
        w = rng.normal(size=q.shape).astype(np.float32)
        inputs.update({f"ring/{name}/q": q, f"ring/{name}/k": k,
                       f"ring/{name}/v": v, f"ring/{name}/w": w})
        m = _jmesh(cfg)
        with m:
            f = jax.jit(lambda a, b_, c, _m=m, _c=causal:
                        jra.ring_attention_sharded(a, b_, c, _m, causal=_c))
            want[f"ring/{name}"] = np.asarray(f(q, k, v))
            want[f"ring/{name}/grads"] = [np.asarray(g) for g in jax.jit(
                jax.grad(lambda a, b_, c, _f=f, _w=w: jnp.sum(_f(a, b_, c)
                                                              * _w),
                         argnums=(0, 1, 2)))(q, k, v)]
    inputs["ring/perturb"] = np.random.default_rng(10).normal(
        size=(2, 16, 4, 32)).astype(np.float32)

    base = JConfig(dtype=jnp.float32, **RING_MODEL)
    tokens = np.random.default_rng(0).integers(0, 128, (2, 64)).astype(
        np.int32)
    jm = JTransformer(base)
    jparams = jm.init(jax.random.PRNGKey(1), jnp.asarray(tokens))["params"]
    want["ring_model"] = np.asarray(jm.apply({"params": jparams}, tokens))
    inputs["ring_tokens"] = tokens
    inputs.update({f"ring_model/{k}": v
                   for k, v in _flat(jax.device_get(jparams)).items()})

    rng = np.random.default_rng(20)
    E, D, F, T = 8, 16, 32, 64
    router = (rng.normal(size=(D, E)) * 0.3).astype(np.float32)
    w_in = (rng.normal(size=(E, D, F)) * 0.3).astype(np.float32)
    w_out = (rng.normal(size=(E, F, D)) * 0.3).astype(np.float32)
    x = rng.normal(size=(T, D)).astype(np.float32)
    inputs.update({"moe/router": router, "moe/w_in": w_in,
                   "moe/w_out": w_out, "moe/tokens": x})
    refs = [jmoe.moe_ffn_reference(jnp.asarray(s), router, w_in, w_out,
                                   capacity_factor=2.0)
            for s in x.reshape(4, T // 4, D)]
    want["moe_reference"] = (np.concatenate([np.asarray(r[0]) for r in refs]),
                             float(np.mean([float(r[1]) for r in refs])))
    em = _jmesh(dict(expert=4))
    with em:
        want["moe/grads"] = [np.asarray(g) for g in jax.jit(jax.grad(
            lambda r, wi, wo: (lambda y, a: jnp.sum(y ** 2) + 0.01 * a)(
                *jmoe.moe_ffn_sharded(jnp.asarray(x), r, wi, wo, em,
                                      capacity_factor=2.0)),
            argnums=(0, 1, 2)))(router, w_in, w_out)]
    mcfg = JConfig(dtype=jnp.float32, **MOE_MODEL)
    mm = JTransformer(mcfg)
    mtokens = np.random.default_rng(0).integers(0, 128, (2, 32)).astype(
        np.int32)
    mparams = mm.init(jax.random.PRNGKey(1), jnp.asarray(mtokens))["params"]
    want["moe_model"] = np.asarray(mm.apply({"params": mparams}, mtokens))
    inputs["moe_tokens"] = mtokens
    inputs.update({f"moe_model/{k}": v
                   for k, v in _flat(jax.device_get(mparams)).items()})

    rng = np.random.default_rng(30)
    d, M, mb = 16, 6, 4
    pw = (rng.normal(size=(4, d, d)) * 0.3).astype(np.float32)
    pb = (rng.normal(size=(4, d)) * 0.1).astype(np.float32)
    xs = rng.normal(size=(M, mb, d)).astype(np.float32)
    inputs.update({"pipe/w": pw, "pipe/b": pb, "pipe/xs": xs})

    def seq(p, x):
        for i in range(4):
            x = jnp.tanh(x @ p["w"][i] + p["b"][i])
        return x

    pm = _jmesh(dict(pipe=4))
    stage = lambda p, x: jnp.tanh(x @ p["w"] + p["b"])  # noqa: E731
    with pm:
        want["pipe_jax"] = np.asarray(jax.jit(lambda p, x: jpipeline(
            stage, p, x, pm))({"w": pw, "b": pb}, xs))
    want["pipe"] = np.asarray(seq({"w": pw, "b": pb}, xs))
    g = jax.grad(lambda p: jnp.sum(seq(p, xs) ** 2))({"w": pw, "b": pb})
    want["pipe/grads"] = (np.asarray(g["w"]), np.asarray(g["b"]))

    body = _BODY.format(rings=RINGS, ring_model=RING_MODEL,
                        moe_model=MOE_MODEL)
    outs = run_ranks(tmp_path_factory.mktemp("sharded_ops"), body, inputs)
    return want, outs


@pytest.mark.parametrize("case", list(RINGS))
def test_ring_matches_jax_ring(rank_run, case):
    want, outs = rank_run
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(out[f"ring/{case}"], want[f"ring/{case}"],
                                   atol=RING_TOL, rtol=RING_TOL,
                                   err_msg=f"rank {rank}")


@pytest.mark.parametrize("case", list(RINGS))
def test_ring_gradient_matches_jax_grad(rank_run, case):
    """Every rank ends with the global dq, dk, dv (GQA unrepeated)."""
    want, outs = rank_run
    for rank, out in enumerate(outs):
        for name, g, w in zip("qkv", out[f"ring/{case}/grads"],
                              want[f"ring/{case}/grads"]):
            np.testing.assert_allclose(g, w, atol=RING_TOL, rtol=RING_TOL,
                                       err_msg=f"rank {rank} d{name}")


def test_causality_holds_across_ranks(rank_run):
    _want, outs = rank_run
    for out in outs:
        assert out["ring/causality"] == (True, True)


def test_model_logits_parity_with_ring(rank_run):
    want, outs = rank_run
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(out["ring_model"], want["ring_model"],
                                   atol=RING_MODEL_TOL, rtol=RING_MODEL_TOL,
                                   err_msg=f"rank {rank}")


def test_moe_matches_per_shard_reference(rank_run):
    want, outs = rank_run
    ref, aux = want["moe_reference"]
    for rank, out in enumerate(outs):
        y, a = out["moe"]
        np.testing.assert_allclose(y, ref, atol=MOE_TOL, rtol=MOE_TOL,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(a, aux, atol=MOE_TOL, rtol=MOE_TOL)


def test_moe_differentiates(rank_run):
    """The gradients of router, w_in and w_out through both all_to_alls
    equal JAX's, on every rank."""
    want, outs = rank_run
    for rank, out in enumerate(outs):
        for name, g, w in zip(("router", "w_in", "w_out"), out["moe/grads"],
                              want["moe/grads"]):
            assert np.isfinite(g).all() and np.abs(g).max() > 0
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4,
                                       err_msg=f"rank {rank} d{name}")


def test_moe_model_sharded_matches_reference(rank_run):
    """Ample capacity: no drops, so the expert=4 path equals the
    single-device model."""
    want, outs = rank_run
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(out["moe_model"], want["moe_model"],
                                   atol=MOE_MODEL_TOL, rtol=MOE_MODEL_TOL,
                                   err_msg=f"rank {rank}")


def test_pipeline_matches_sequential(rank_run):
    want, outs = rank_run
    np.testing.assert_allclose(want["pipe_jax"], want["pipe"], atol=PIPE_TOL,
                               rtol=PIPE_TOL)
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(out["pipe"], want["pipe"], atol=PIPE_TOL,
                                   rtol=PIPE_TOL, err_msg=f"rank {rank}")


def test_pipeline_differentiates(rank_run):
    """Gradients flow back through the send_recv chain: every rank holds
    the whole stacked params' gradients, equal to the sequential run's."""
    want, outs = rank_run
    for rank, out in enumerate(outs):
        for name, g, w in zip("wb", out["pipe/grads"], want["pipe/grads"]):
            np.testing.assert_allclose(g, w, atol=PIPE_GRAD_TOL,
                                       rtol=PIPE_GRAD_TOL,
                                       err_msg=f"rank {rank} d{name}")
