"""ray_tpu_torch.models (transformer + functional serving forward) against
the flax model and ray_tpu.models.inference.

The flax Transformer is initialised with PRNGKey(0) at the tiny f32
config of tests/test_inference.py; its params go through
``params_from_jax`` into the port. Logits and K/V must agree to 2e-4,
the tolerance tests/test_inference.py already holds the JAX functional
forward to (f32 sums in another order on another library).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import inference as jinf  # noqa: E402
from ray_tpu.models.transformer import Transformer as JTransformer  # noqa: E402
from ray_tpu.models.transformer import (  # noqa: E402
    TransformerConfig as JConfig)
from ray_tpu.models.transformer import _rope as jrope  # noqa: E402
from ray_tpu_torch.models import inference as tinf  # noqa: E402
from ray_tpu_torch.models import transformer as tt  # noqa: E402

ATOL = 2e-4
TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq_len=128)


@pytest.fixture(scope="module")
def tiny():
    jcfg = JConfig(dtype=jnp.float32, **TINY)
    model = JTransformer(jcfg)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 8), jnp.int32))
    tcfg = tt.TransformerConfig(dtype=torch.float32, **TINY)
    tree = jax.tree_util.tree_map(np.asarray, variables)
    return jcfg, model, variables["params"], tcfg, tt.params_from_jax(tree)


def test_params_from_jax_keeps_keys_and_layouts(tiny):
    _jcfg, _model, jparams, _tcfg, params = tiny
    assert params["layer_1/Attention_0/wq"].shape == (32, 4, 8)
    assert params["layer_0/Attention_0/wo"].shape == (4, 8, 32)
    assert params["layer_0/MLP_0/w_down"].shape == (64, 32)
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == len(params)
    for path, leaf in flat:
        key = "/".join(p.key for p in path)
        np.testing.assert_array_equal(params[key].numpy(), np.asarray(leaf))
        assert params[key].dtype == torch.float32


def test_init_params_matches_flax_tree_and_scales():
    cfg = tt.TransformerConfig(dtype=torch.float32, vocab_size=512,
                               d_model=128, n_layers=1, n_heads=4,
                               n_kv_heads=2, d_ff=256)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0))
    jcfg = JConfig(dtype=jnp.float32, vocab_size=512, d_model=128,
                   n_layers=1, n_heads=4, n_kv_heads=2, d_ff=256)
    jp = JTransformer(jcfg).init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 4), jnp.int32))["params"]
    flat = {"/".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert sorted(flat) == sorted(params)
    for key, ref in flat.items():
        got = params[key].numpy()
        assert got.shape == ref.shape, key
        # same distribution: std within 10%, same truncation bound
        if ref.std() > 0:
            assert abs(got.std() / ref.std() - 1) < 0.1, key
            assert np.abs(got).max() <= np.abs(ref).max() * 1.5, key
        else:
            np.testing.assert_array_equal(got, ref)


def test_rope_rotates_interleaved_pairs_like_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 100, size=(2, 5)).astype(np.int32)
    got = tt._rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    want = jrope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_config_rejects_unported_options():
    """moe=True builds a model with the expert layer in place of the dense
    MLP, and its engine and its expert-parallel path are what the port
    refuses: the engine raises ValueError (the reference's reads MLP_0).
    A forward under a mesh with expert > 1 takes the expert-parallel path
    (tests/test_torch_moe.py and tests/test_torch_sharded_ops.py hold it to
    the reference)."""
    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh, use_mesh

    cfg = tt.TransformerConfig(dtype=torch.float32, moe=True,
                               moe_num_experts=4, **TINY)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    model = tt.Transformer(cfg, device="cpu").load_params(params)
    assert hasattr(model.layer_0, "MoEMLP_0")
    assert not hasattr(model.layer_0, "MLP_0")
    assert params["layer_1/MoEMLP_0/w_in"].shape == (4, 32, 64)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    assert torch.isfinite(model(tokens)).all()
    with pytest.raises(ValueError, match="MLP_0"):
        tinf.InferenceEngine(params, cfg, device="cpu")
    with use_mesh(make_mesh(MeshConfig(expert=2), ["cpu"] * 2)):
        assert torch.isfinite(model(tokens)).all()


def test_config_builds_with_ring_attention():
    cfg = tt.TransformerConfig(ring_attention=True)
    assert cfg.ring_attention and not cfg.moe


def test_ring_model_logits_match_jax_ring_model():
    """Counterpart of tests/test_ring_attention.py::TestModelIntegration:
    the flagship forward with ring attention on a seq=2 mesh (the port's
    over two CPU devices, JAX's over fsdp=2, seq=2, tensor=2 of the virtual
    CPU mesh) from the same flax params, against each other and against the
    port's forward without the ring, at that test's 3e-4."""
    from ray_tpu.parallel import mesh as jmesh
    from ray_tpu_torch.parallel import mesh as tmesh

    base = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=176, max_seq_len=64)
    tokens = np.random.default_rng(0).integers(0, 128, (2, 64)).astype(
        np.int32)
    jparams = JTransformer(JConfig(dtype=jnp.float32, **base)).init(
        jax.random.PRNGKey(1), jnp.asarray(tokens))["params"]
    jring = JTransformer(JConfig(dtype=jnp.float32, ring_attention=True,
                                 **base))
    jm = jmesh.make_mesh(jmesh.MeshConfig(fsdp=2, seq=2, tensor=2),
                         jax.devices()[:8])
    with jmesh.use_mesh(jm):
        want = np.asarray(jax.jit(lambda p, t: jring.apply({"params": p}, t))(
            jparams, jnp.asarray(tokens)))

    params = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    net = tt.model_from_params(
        tt.TransformerConfig(dtype=torch.float32, ring_attention=True, **base),
        params, device="cpu")
    tm = tmesh.make_mesh(tmesh.MeshConfig(seq=2), ["cpu"] * 2)
    with torch.no_grad():
        with tmesh.use_mesh(tm):
            got = net(torch.from_numpy(tokens)).numpy()
        plain = net(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=3e-4)
    np.testing.assert_allclose(got, plain, atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("toks", [[5, 9, 2, 40, 7, 1, 33, 12],
                                  [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]])
def test_full_forward_matches_flax(tiny, toks):
    _jcfg, model, jparams, tcfg, params = tiny
    want = np.asarray(model.apply({"params": jparams},
                                  jnp.asarray([toks], jnp.int32)))
    net = tt.model_from_params(tcfg, params, device="cpu")
    with torch.no_grad():
        got = net(torch.tensor([toks], dtype=torch.int32)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_prefill_matches_jax_functional_prefill(tiny):
    jcfg, _model, jparams, tcfg, params = tiny
    toks = [[5, 9, 2, 40, 7, 1, 33, 12]]
    jl, jk, jv = jinf.prefill(jparams, jcfg, jnp.asarray(toks, jnp.int32))
    tl, tk, tv = tinf.prefill(params, tcfg,
                              torch.tensor(toks, dtype=torch.int32))
    assert tl.dtype == torch.float32 and tk.shape == (2, 8, 2, 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


def test_decode_step_matches_jax(tiny):
    """One decode step over a filled cache: prefill K/V written to pages,
    then a batch of two slots (one live, one idle on the parking page)."""
    jcfg, _model, jparams, tcfg, params = tiny
    page, P, MP = 4, 8, 4
    prompt = [3, 14, 15, 9, 2]
    _l, jk, jv = jinf.prefill(jparams, jcfg,
                              jnp.asarray([prompt + [0, 0, 0]], jnp.int32))
    L, KV, D = 2, 2, 8
    table = np.asarray([[2, 5, 1, 7], [7, 7, 7, 7]], np.int32)
    lens = np.asarray([len(prompt), 0], np.int32)
    toks = np.asarray([9, 0], np.int32)
    jkp, jvp, tkp, tvp = [], [], [], []
    for i in range(L):
        kp = jnp.zeros((P, KV, page, D), jnp.float32)
        kp, vp = jinf.write_prefill_kv(kp, kp, jk[i], jv[i],
                                       jnp.asarray([2, 5], jnp.int32))
        jkp.append(kp)
        jvp.append(vp)
        tkp.append(torch.from_numpy(np.array(kp)))
        tvp.append(torch.from_numpy(np.array(vp)))
    jlog, jkp, jvp = jinf.decode_step(
        jparams, jcfg, jnp.asarray(toks), tuple(jkp), tuple(jvp),
        jnp.asarray(table), jnp.asarray(lens))
    tlog = tinf.decode_step(params, tcfg, torch.from_numpy(toks), tkp, tvp,
                            torch.from_numpy(table), torch.from_numpy(lens))
    assert tlog.dtype == torch.float32 and tlog.shape == (2, 64)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
    for i in range(L):
        # the live sequence's pages; the parking page (7) is don't-care
        for p in (2, 5, 1):
            np.testing.assert_allclose(tkp[i][p].numpy(),
                                       np.asarray(jkp[i][p]), atol=ATOL)
            np.testing.assert_allclose(tvp[i][p].numpy(),
                                       np.asarray(jvp[i][p]), atol=ATOL)


def test_decode_chunk_feeds_back_argmax(tiny):
    """decode_chunk's tokens equal n single decode_steps with argmax."""
    _jcfg, _model, _jparams, tcfg, params = tiny
    page, P = 4, 8
    shape = (P, 2, page, 8)
    table = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32)
    k1, v1 = [torch.zeros(shape) for _ in range(2)], [torch.zeros(shape)
                                                     for _ in range(2)]
    k2, v2 = [t.clone() for t in k1], [t.clone() for t in v1]
    toks = torch.tensor([7], dtype=torch.int32)
    lens = torch.tensor([0], dtype=torch.int32)
    outs, nxt, nlens = tinf.decode_chunk(params, tcfg, toks, k1, v1, table,
                                         lens, n_steps=5)
    want = []
    t, n = toks, lens
    for _ in range(5):
        t = torch.argmax(tinf.decode_step(params, tcfg, t, k2, v2, table, n),
                         -1).to(torch.int32)
        want.append(int(t[0]))
        n = n + 1
    assert outs[:, 0].tolist() == want
    assert int(nxt[0]) == want[-1] and int(nlens[0]) == 5
    for a, b in zip(k1 + v1, k2 + v2):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
