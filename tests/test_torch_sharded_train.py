"""Sharded training across 4 gloo ranks against ray_tpu's, on the CPU.

Mirrors ``tests/test_models.py::TestShardedTraining`` (and the MoE train
step of ``tests/test_pipeline_moe.py``): ``init_sharded`` lays each
parameter out as its logical axes ask (wq's heads and the embedding's
vocab over ``tensor``, the embedding's d_model over ``fsdp``), the layouts
survive a step, and the sharded step computes the single-device math: the
first loss within the reference's rtol 2e-3 of JAX's single-device loss
(bf16, on data=2 x tensor=2 and fsdp=2 x tensor=2), and in f32 loss and
grad_norm of every step within tests/test_torch_train_step.py's rtol 1e-4
of JAX's jitted step, dense, MoE on expert=4 and the ring on data=2 x
seq=2. The parameters come from flax's init (``params_from_jax``) and load
into every rank (``load_sharded``); ranks run through
tests/test_torch_sharded.py ``run_ranks``.

Also: the port's ``_flash_supported`` against the reference's, with and
without a mesh larger than 1.
"""

import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import train_step as jts  # noqa: E402
from ray_tpu.models import transformer as jtm  # noqa: E402
from ray_tpu.parallel import mesh as jmesh  # noqa: E402

from test_torch_sharded import run_ranks  # noqa: E402
from test_torch_sharded_ops import _flat  # noqa: E402

LOSS_RTOL = 2e-3          # tests/test_models.py:119
STEP_RTOL = 1e-4          # tests/test_torch_train_step.py
LR = 1e-2
TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128)
MOE = dict(TINY, moe=True, moe_num_experts=4, moe_capacity_factor=8.0)
# (config, mesh, dtype, steps)
RUNS = {
    "bf16_data2_tensor2": (TINY, dict(data=2, tensor=2), "bfloat16", 1),
    "bf16_fsdp2_tensor2": (TINY, dict(fsdp=2, tensor=2), "bfloat16", 1),
    "f32_fsdp2_tensor2": (TINY, dict(fsdp=2, tensor=2), "float32", 3),
    "f32_moe_expert4": (MOE, dict(expert=4), "float32", 2),
    "f32_ring_data2_seq2": (dict(TINY, ring_attention=True),
                            dict(data=2, seq=2), "float32", 2),
}

_BODY = '''
from ray_tpu_torch.models import train_step as ts
from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.parallel.mesh import MeshConfig

RUNS = {runs!r}
TINY = {tiny!r}
LR = {lr!r}

def layout(p):
    return [str(x) for x in p.placements]

def main(rank, world, inputs):
    out = {{}}
    # init_sharded: layouts, values equal init_params', kept by a step
    mesh = distributed.global_mesh(MeshConfig(data=2, tensor=2))
    cfg = tt.TransformerConfig(**TINY)
    model, params, shardings = ts.init_sharded(cfg, mesh, 4, 16, seed=3)
    full = tt.init_params(cfg, torch.Generator().manual_seed(3))
    out["init_equal"] = all(
        torch.equal(p.to_local(),
                    ts.collectives.local_block(full[n], shardings[n].spec,
                                               mesh))
        for n, p in params.items())
    wq, emb = params["layer_0/Attention_0/wq"], params["embedding"]
    before = (layout(wq), layout(emb), tuple(wq.to_local().shape))
    step = ts.make_train_step(model, ts.make_optimizer(model.parameters()),
                              param_shardings=shardings)
    m = step({{"tokens": torch.ones((4, 16), dtype=torch.long)}})
    out["init_step"] = (before, (layout(wq), layout(emb)),
                        float(m["loss"]), type(wq).__name__,
                        type(wq.grad).__name__,
                        all(tuple(p.placements) == shardings[n].placements
                            for n, p in params.items()))
    for name, (cfg_kw, mesh_kw, dtype, steps) in RUNS.items():
        cfg = tt.TransformerConfig(dtype=getattr(torch, dtype), **cfg_kw)
        prefix = name + "/"
        full = {{k[len(prefix):].replace("|", "/"): torch.from_numpy(v)
                for k, v in inputs.items() if k.startswith(prefix)}}
        mesh = distributed.global_mesh(MeshConfig(**mesh_kw))
        model, params, shardings = ts.load_sharded(cfg, full, mesh)
        opt = ts.make_optimizer(model.parameters(), learning_rate=LR)
        step = ts.make_train_step(model, opt, param_shardings=shardings)
        tokens = torch.from_numpy(inputs["tokens"]).long()
        out[name] = [[float(v) for v in (m["loss"], m["grad_norm"])]
                     for m in (step({{"tokens": tokens}})
                               for _ in range(steps))]
    return out
'''


def _jax_runs():
    """Per run: the flax params, and JAX's (loss, grad_norm) a step from
    the reference's jitted make_train_step under a mesh of the same shape
    over 4 virtual devices (the MoE's per-shard routing and aux, the ring);
    the first loss also on one device, unsharded."""
    tokens = np.random.default_rng(1).integers(0, 256, (4, 17)).astype(
        np.int32)
    inputs, want = {"tokens": tokens}, {}
    for name, (cfg_kw, mesh_kw, dtype, steps) in RUNS.items():
        jcfg = jtm.TransformerConfig(dtype=getattr(jnp, dtype), **cfg_kw)
        model = jtm.Transformer(jcfg)
        params = model.init(jax.random.PRNGKey(7),
                            jnp.asarray(tokens[:, :-1]))["params"]
        inputs.update({f"{name}/{k}": v
                       for k, v in _flat(jax.device_get(params)).items()})
        want[name + "/single"] = float(jtm.cross_entropy_loss(
            jts.make_forward(jtm.Transformer(jcfg.__class__(
                **{**jcfg.__dict__, "ring_attention": False})))(
                params, jnp.asarray(tokens[:, :-1])), tokens[:, 1:]))
        opt = jts.make_optimizer(learning_rate=LR)
        mesh = jmesh.make_mesh(jmesh.MeshConfig(**mesh_kw),
                               jax.devices()[:4])
        got = []
        with jmesh.use_mesh(mesh):
            step = jax.jit(jts.make_train_step(model, opt))
            state = opt.init(params)
            for _ in range(steps):
                params, state, m = step(params, state,
                                        {"tokens": jnp.asarray(tokens)})
                got.append((float(m["loss"]), float(m["grad_norm"])))
        want[name] = got
    return inputs, want


@pytest.fixture(scope="module")
def rank_run(tmp_path_factory):
    inputs, want = _jax_runs()
    body = _BODY.format(runs=RUNS, tiny=TINY, lr=LR)
    outs = run_ranks(tmp_path_factory.mktemp("sharded_train"), body, inputs)
    return want, outs


def test_sharded_init_and_step_on_mesh(rank_run):
    """wq's heads and the embedding's vocab split over tensor; both
    layouts the same after a step; init_sharded's blocks are
    init_params' own."""
    _want, outs = rank_run
    for rank, out in enumerate(outs):
        assert out["init_equal"], rank
        before, after, loss, kind, grad_kind, kept = out["init_step"]
        # the DTensor mesh's axes: data, tensor (the axes larger than 1)
        assert before[0] == ["R", "S(1)"]
        assert before[1] == ["R", "S(0)"]
        assert before[2] == (64, 2, 16)          # 4 heads over tensor=2
        assert after == before[:2] and kept
        assert kind == grad_kind == "DTensor"
        assert np.isfinite(loss)


@pytest.mark.parametrize("run", [r for r in RUNS if r.startswith("bf16")])
def test_single_vs_multichip_loss_match(rank_run, run):
    """The sharded program computes the same math as single-device."""
    want, outs = rank_run
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(out[run][0][0], want[run + "/single"],
                                   rtol=LOSS_RTOL, err_msg=f"rank {rank}")


@pytest.mark.parametrize("run", [r for r in RUNS if r.startswith("f32")])
def test_sharded_steps_match_jax(rank_run, run):
    """Loss and grad_norm of every step, f32: dense on fsdp x tensor, MoE
    on expert=4 (ample capacity: no drops), the ring on data x seq."""
    want, outs = rank_run
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(np.asarray(out[run]),
                                   np.asarray(want[run]), rtol=STEP_RTOL,
                                   err_msg=f"rank {rank}")


# ----------------------------------------------------------------------
# the attention path: the port's rule against the reference's
# ----------------------------------------------------------------------

MESHES = [None, dict(), dict(data=2), dict(seq=2), dict(tensor=2),
          dict(fsdp=2, tensor=2)]


@pytest.mark.parametrize("cfg", MESHES)
@pytest.mark.parametrize("head_dim", [128, 64])
def test_flash_rule_matches_reference(monkeypatch, cfg, head_dim):
    """Both packages take flash only with no mesh axis larger than 1 (and
    a lane-aligned head_dim on their accelerator): the reference on a TPU
    backend, the port on a CUDA tensor."""
    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.parallel import mesh as tmesh

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    cuda_x = types.SimpleNamespace(device=torch.device("cuda"))
    if cfg is None:
        want = jtm._flash_supported(head_dim)
        got = tt._flash_supported(cuda_x, head_dim)
    else:
        n = jmesh.MeshConfig(**cfg).num_devices
        with jmesh.use_mesh(jmesh.make_mesh(jmesh.MeshConfig(**cfg),
                                            jax.devices()[:n])):
            want = jtm._flash_supported(head_dim)
        with tmesh.use_mesh(tmesh.make_mesh(tmesh.MeshConfig(**cfg),
                                            ["cpu"] * n)):
            got = tt._flash_supported(cuda_x, head_dim)
    assert got == want
    assert want == (head_dim == 128 and (cfg is None or n == 1))
    # the port's rule on a host tensor: never flash
    assert not tt._flash_supported(
        types.SimpleNamespace(device=torch.device("cpu")), head_dim)
