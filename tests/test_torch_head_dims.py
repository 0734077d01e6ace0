"""The port's kernels at every head width they are built for, against the
JAX package, on the CPU.

``ray_tpu_torch/ops/head_dims.py`` names the widths: kernels 1 and 2 at
16, 32, 64, 128 and 256 (the JAX package's configurations: ``tiny``, the
smoke decode model and the serving A/B model at 16, the smoke model at 32,
the default ``TransformerConfig`` at 64, the flagship at 128), the flash
kernels at 128 and 256 (the multiples of 128 the flash rule picks). At each
width the port's plain versions (what each CUDA kernel is held against on
the card) match the reference's Pallas kernels in interpret mode; at 256
the port's plain flash forward and backward, inside the model, match the
JAX model's einsum attention; the engine at head_dim 16, 64, 80, 96 and
100 gives exactly the JAX engine's greedy tokens; and each width, those
below a class too (tests/test_torch_head_dims_any.py), reaches its class's
library with its true head_dim. Inputs are seeded numpy arrays (or
flax-initialised params through ``params_from_jax``) handed to both.

Tolerances, f32 throughout, as the head_dim-128 tests state them:
ATOL 1e-5 for a kernel's outputs (the same sums in another order:
tests/test_torch_paged_attention.py, tests/test_torch_ring_attention.py,
tests/test_torch_flash.py), MODEL_ATOL 2e-4 for a model's logits, loss
and gradients (tests/test_torch_transformer.py). Greedy tokens are equal.
"""

import importlib
import re
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import inference as jinf  # noqa: E402
from ray_tpu.models import transformer as jtt  # noqa: E402
from ray_tpu.ops import paged_attention as jpa  # noqa: E402
from ray_tpu.ops.ring_attention import attention_reference  # noqa: E402
from ray_tpu_torch.models import inference as tinf  # noqa: E402
from ray_tpu_torch.models import transformer as tt  # noqa: E402
from ray_tpu_torch.ops import flash as tf  # noqa: E402
from ray_tpu_torch.ops import head_dims  # noqa: E402
from ray_tpu_torch.ops import paged_attention as tpa  # noqa: E402
from ray_tpu_torch.ops import ring_attention as tra  # noqa: E402

jra = importlib.import_module("ray_tpu.ops.ring_attention")

ATOL = 1e-5
MODEL_ATOL = 2e-4
WIDTHS = (16, 32, 64, 128, 256)
ANY = ("block_attention", "paged_attention")   # every width up to 256


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def test_the_kernels_widths():
    assert head_dims.PAGED_ATTENTION == WIDTHS
    assert head_dims.BLOCK_ATTENTION == WIDTHS
    assert head_dims.FLASH == (128, 256)
    assert tpa._HEAD_DIMS == head_dims.PAGED_ATTENTION
    assert set(head_dims.SM90_FORWARD) <= set(WIDTHS)
    assert set(head_dims.SM90_BACKWARD) <= set(head_dims.FLASH)
    assert [head_dims.library("paged_attention", d) for d in (16, 128)] == [
        "paged_attention_d16", "paged_attention"]


# kernels 1 and 2 take every head_dim from 1 to 256, flash 128 and 256
_REFUSED = ([(kernel, width) for kernel in ANY
             for width in (0, 257, 264, 384, 512, 1024)]
            + [("flash", width) for width in (8, 48, 96, 100, 192, 384, 512)])


@pytest.mark.parametrize("kernel, width", _REFUSED)
def test_other_widths_raise_naming_the_set(kernel, width):
    """A width a kernel does not take raises, naming what it takes and the
    queue of ROADMAP.md that holds wider heads (B5 for kernels 1 and 2,
    B4 for flash)."""
    takes = ("head_dim 1 to 256" if kernel in ANY
             else "head_dim in (128, 256)")
    queue = "B5" if kernel in ANY else "B4"
    with pytest.raises(ValueError, match=re.escape(takes) + ".*" + queue):
        head_dims.check(kernel, width)


# ----------------------------------------------------------------------
# kernel 1: paged decode attention
# ----------------------------------------------------------------------

@pytest.mark.parametrize("D", WIDTHS)
def test_paged_attention_matches_jax_kernel(D):
    """GQA (8 query heads over 2 KV heads), ragged lengths with an empty
    sequence and one past a page: the wrapper's CPU path and the plain
    mirror of the CUDA kernel's split and merge against the reference's
    Pallas kernel in interpret mode."""
    B, H, KV, page, P, MP = 4, 8, 2, 4, 12, 3
    rng = np.random.default_rng(D)
    q = _normal(rng, B, H, D)
    kp, vp = _normal(rng, P, KV, page, D), _normal(rng, P, KV, page, D)
    table = rng.permutation(P)[:B * MP].reshape(B, MP).astype(np.int32)
    lens = np.asarray([0, 1, 5, 12], np.int32)
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


@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("elt", [2, 4])
def test_split_plan_fits_every_width(D, elt):
    """At the serving shape the plan keeps a split block under 48 KiB of
    shared memory at every width and dtype (a K and a V tile of page x D
    a page): the wider the head, the fewer pages a split."""
    pps, splits = tpa.split_plan(64, 8, 4, 16, 16, elt, D)
    assert pps * splits >= 16
    assert tpa.split_smem_bytes(pps, 16, 2, elt, D) <= 48 * 1024
    assert tpa.split_plan(64, 8, 4, 16, 16, elt, D)[0] <= tpa.split_plan(
        64, 8, 4, 16, 16, elt, 16)[0]


# ----------------------------------------------------------------------
# kernel 2: ring attention's block
# ----------------------------------------------------------------------

# (q_offset, k_offset, Tq, Tk, kv_heads, causal)
BLOCKS = {"ragged_gqa": (37, 5, 24, 40, 2, True),
          "non_causal": (0, 0, 24, 20, 4, False)}


@pytest.mark.parametrize("case", list(BLOCKS))
@pytest.mark.parametrize("D", WIDTHS)
def test_block_attention_matches_jax_pallas(D, case):
    q_off, k_off, tq, tk, kv, causal = BLOCKS[case]
    rng = np.random.default_rng(D + 1)
    q = _normal(rng, 2, 4, tq, D, scale=0.3)
    k, v = (_normal(rng, 2, kv, tk, D, scale=0.3) for _ in range(2))
    got = tra.block_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), q_off, k_off, causal)
    want = jra.block_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), q_off, k_off, causal,
                               impl="pallas", interpret=True)
    for out, g, w in zip(("o", "m", "l"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=ATOL, err_msg=out)


# ----------------------------------------------------------------------
# kernels 3a-3c: flash attention at 256
# ----------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_flash_at_256_matches_jax_attention(causal):
    """The port's Function at head_dim 256 (each kernel's plain version on
    the CPU): forward and the three gradients against the JAX package's
    plain attention and its VJP."""
    rng = np.random.default_rng(256)
    q, k, v, do = (_normal(rng, 2, 37, 4, 256) for _ in range(4))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tf.flash_attention_bshk(*ts, causal=causal)
    (out * torch.from_numpy(do)).sum().backward()
    want, vjp = jax.vjp(lambda a, b, c: attention_reference(a, b, c, causal),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    for name, t, w in zip("qkv", ts, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=ATOL,
                                   err_msg=f"d{name}")


# d_model 512 over 2 query heads: head_dim 256, one KV head (GQA)
D256 = dict(vocab_size=64, d_model=512, n_layers=2, n_heads=2, n_kv_heads=1,
            d_ff=128, max_seq_len=64)


@pytest.fixture(scope="module")
def model_256():
    jcfg = jtt.TransformerConfig(dtype=jnp.float32, **D256)
    model = jtt.Transformer(jcfg)
    variables = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 8),
                                                            jnp.int32))
    params = tt.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       variables))
    return model, variables["params"], params


def test_transformer_forward_and_loss_at_256(model_256, monkeypatch):
    """The model at head_dim 256 through params_from_jax: its flash branch
    (the rule taken as on the card; on the CPU the Function runs the
    kernels' plain versions) against the JAX model's einsum attention:
    logits, loss and every gradient; and the einsum branch's logits."""
    model, jparams, params = model_256
    tokens = np.random.default_rng(0).integers(0, 64, (2, 33)).astype(
        np.int32)
    inp, tgt = tokens[:, :-1], tokens[:, 1:]

    def jloss(p):
        logits = model.apply({"params": p}, jnp.asarray(inp))
        return jtt.cross_entropy_loss(logits, jnp.asarray(tgt)), logits

    (want_loss, want_logits), jgrads = jax.value_and_grad(
        jloss, has_aux=True)(jparams)
    flat = {"/".join(p.key for p in path): np.asarray(g) for path, g in
            jax.tree_util.tree_flatten_with_path(jgrads)[0]}

    cfg = tt.TransformerConfig(dtype=torch.float32, **D256)
    assert cfg.head_dim == 256
    plain = tt.model_from_params(cfg, params, device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose(plain(torch.from_numpy(inp)).numpy(),
                                   np.asarray(want_logits), atol=MODEL_ATOL)

    calls = []

    def flash_on(x, head_dim):
        calls.append(head_dim)
        return head_dim in head_dims.FLASH

    monkeypatch.setattr(tt, "_flash_supported", flash_on)
    net = tt.model_from_params(cfg, params, device="cpu")
    logits = net(torch.from_numpy(inp))
    loss = tt.cross_entropy_loss(logits, torch.from_numpy(tgt).long())
    loss.backward()
    assert calls and set(calls) == {256}
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), atol=MODEL_ATOL)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=MODEL_ATOL)
    grads = {k.replace(".", "/"): p for k, p in net.named_parameters()}
    assert sorted(flat) == sorted(grads)
    for key, want in flat.items():
        np.testing.assert_allclose(grads[key].grad.numpy(), want,
                                   atol=MODEL_ATOL, err_msg=key)


# ----------------------------------------------------------------------
# the engine at head_dim 16, 64, 80, 96 and 100
# ----------------------------------------------------------------------

ENGINES = {16: dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4,
                    n_kv_heads=2, d_ff=64, max_seq_len=128),
           64: dict(vocab_size=64, d_model=128, n_layers=2, n_heads=2,
                    n_kv_heads=1, d_ff=64, max_seq_len=128),
           # widths below their class: Phi-2's 80, Phi-3-mini's 96 (group
           # 1), and 100, whose rows are not whole 16-byte units in bf16
           80: dict(vocab_size=64, d_model=160, n_layers=2, n_heads=2,
                    n_kv_heads=1, d_ff=64, max_seq_len=128),
           96: dict(vocab_size=64, d_model=192, n_layers=2, n_heads=2,
                    n_kv_heads=2, d_ff=64, max_seq_len=128),
           100: dict(vocab_size=64, d_model=200, n_layers=2, n_heads=2,
                     n_kv_heads=1, d_ff=64, max_seq_len=128)}


@pytest.mark.parametrize("D", sorted(ENGINES))
def test_engine_matches_jax_engine(D):
    """Ragged prompts, more requests than slots: the port's engine on the
    CPU (kernel 1's plain version) gives exactly the JAX engine's greedy
    tokens at head_dim D."""
    fields = ENGINES[D]
    jcfg = jtt.TransformerConfig(dtype=jnp.float32, **fields)
    variables = jtt.Transformer(jcfg).init(jax.random.PRNGKey(D),
                                           jnp.zeros((1, 8), jnp.int32))
    params = tt.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       variables))
    tcfg = tt.TransformerConfig(dtype=torch.float32, **fields)
    assert tcfg.head_dim == D
    icfg = jinf.InferenceConfig(batch_size=2, page_size=4,
                                max_pages_per_seq=8, num_pages=16,
                                prefill_buckets=(8,))
    prompts = [[7], [1, 2, 3, 4, 5, 6], [9, 9, 9]]

    def run(engine):
        try:
            return [f.result(timeout=120) for f in
                    [engine.submit(p, max_new_tokens=6) for p in prompts]]
        finally:
            engine.shutdown()

    want = run(jinf.InferenceEngine(variables["params"], jcfg, icfg))
    got = run(tinf.InferenceEngine(params, tcfg, tinf.InferenceConfig(
        **vars(icfg)), device="cpu"))
    assert got == want
    assert all(len(o) == 6 for o in got)


# ----------------------------------------------------------------------
# the flash rule never picks a width without an instance
# ----------------------------------------------------------------------

def _repo_widths():
    """{configuration: head_dim} of every model configuration the repo
    runs: the defaults, the perf sections' models, chip_smoke's."""
    import chip_smoke
    from ray_tpu_torch._private import perf

    keys = ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
            "d_ff")
    configs = {
        "default": tt.TransformerConfig(),
        "tiny": tt.TransformerConfig.tiny(),
        "serving_ab": tt.TransformerConfig(**perf.SERVING_AB_MODEL),
        "smoke_model": tt.TransformerConfig(
            **{k: perf.SMOKE_MODEL[k] for k in keys}),
        "smoke_decode": tt.TransformerConfig(
            **{k: perf.SMOKE_DECODE[k] for k in keys}),
        **{name: tt.TransformerConfig(**fields) for name, fields in (
            ("serve", chip_smoke.SERVE), ("train", chip_smoke.TRAIN),
            ("train_d256", chip_smoke.TRAIN_D256),
            ("tune", chip_smoke.TUNE_MODEL))},
        **{f"width_{d}": tt.TransformerConfig(**fields)
           for d, fields in chip_smoke.width_models().items()}}
    return {name: cfg.head_dim for name, cfg in configs.items()}


def test_flash_rule_picks_only_built_widths():
    """For every width the repo's configurations use, whenever the port's
    rule (the reference's: a CUDA tensor, head_dim % 128 == 0, no mesh
    axis above 1) picks the flash branch, the flash wrapper is built for
    that width; and the configurations cover every width of kernels 1
    and 2."""
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    widths = _repo_widths()
    assert set(widths.values()) == set(WIDTHS), widths
    picked = {name: d for name, d in widths.items()
              if tt._flash_supported(on_card, d)}
    assert set(picked.values()) == {128, 256}, picked
    for name, d in picked.items():
        head_dims.check("flash", d, name)
    for d in set(widths.values()):
        head_dims.check("paged_attention", d)
        head_dims.check("block_attention", d)
    # the rule itself is the reference's: multiples of 128 only
    assert [d for d in range(16, 513, 16)
            if tt._flash_supported(on_card, d)] == [128, 256, 384, 512]


# ----------------------------------------------------------------------
# routes: which library and entry each width's launch reaches
# ----------------------------------------------------------------------

class _RecordingLibrary:
    """Stands in for the kernel libraries: records the library each launch
    loads, the entry point and its arguments, and returns 0 (success)."""

    def __init__(self):
        self.calls = []
        self.name = None

    def __getattr__(self, entry):
        def call(*args):
            self.calls.append((self.name, entry, args))
            return 0

        call.__name__ = entry
        return call


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers on meta tensors reach their launches, which go to a
    recording library instead of the card."""
    from ray_tpu_torch.ops import _build

    lib = _RecordingLibrary()

    def library(name, signatures):
        lib.name = name
        return lib

    monkeypatch.setattr(_build, "library", library)
    for mod in (tpa, tra, tf):
        monkeypatch.setattr(mod, "_KERNEL_DEVICE", "meta")
        monkeypatch.setattr(mod, "_stream", lambda device: 0)
    return lib


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("D", WIDTHS)
def test_paged_attention_loads_its_width(recorded, D):
    tpa.paged_attention(_meta(64, 8, D), _meta(1024, 4, 16, D),
                        _meta(1024, 4, 16, D),
                        _meta(64, 16, dtype=torch.int32),
                        _meta(64, dtype=torch.int32))
    (lib, entry, args), = recorded.calls
    assert lib == head_dims.library("paged_attention", D)
    assert entry == "paged_decode_attention" and args[10] == D
    pps = args[13]
    assert tpa.split_smem_bytes(pps, 16, 2, 2, D) <= 48 * 1024


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", WIDTHS)
def test_block_attention_routes_by_width(recorded, D, dtype):
    """bf16 reaches the bf16 entry with byte strides and the launch plan's
    splits (the sm90 kernels at every width, head_dims.SM90_FORWARD), f32
    the FMA entry with element strides, each in its width's library."""
    q = _meta(2, 64, 4, D, dtype=dtype)[:, 32:].transpose(1, 2)
    kv = _meta(2, 64, 2, D, dtype=dtype)[:, 32:].transpose(1, 2)
    tra.block_attention(q, kv, kv, 32, 0, True)
    (lib, entry, args), = recorded.calls
    assert lib == head_dims.library("ring_attention", D)
    bf16 = dtype == torch.bfloat16
    assert entry == ("ring_block_attention_bf16" if bf16
                     else "ring_block_attention") and args[11] == D
    unit = 2 if bf16 else 1
    assert args[14:17] == (64 * 4 * D * unit, D * unit, 4 * D * unit)
    # causal, then in bf16 the plan: 8 64-query tiles, one key tile, so
    # the split kernel unsplit at every width
    assert args[23:-2] == ((1, 1) if bf16 else (1,))
    assert D in head_dims.SM90_FORWARD


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [1, 8, 37, 96, 100, 192])
def test_paged_attention_loads_its_class(recorded, D, dtype):
    """The class's library gets the true head_dim, a workspace of
    B x H x S x (D + 2) values and split_plan's pages per split at D; the
    cache goes in as it is."""
    kp = _meta(1024, 4, 16, D, dtype=dtype)
    out = tpa.paged_attention(_meta(64, 8, D, dtype=dtype), kp, kp,
                              _meta(64, 16, dtype=torch.int32),
                              _meta(64, dtype=torch.int32))
    (lib, entry, args), = recorded.calls
    assert lib == head_dims.library("paged_attention",
                                    head_dims.width_class(D))
    assert entry == "paged_decode_attention" and args[10] == D
    assert args[1] == kp.data_ptr() and out.shape == (64, 8, D)
    elt = kp.element_size()
    pps, splits = tpa.split_plan(64, 8, 4, 16, 16, elt, D)
    assert args[13] == pps
    assert tpa.split_smem_bytes(pps, 16, 2, elt, D) <= 48 * 1024


@pytest.mark.parametrize("D", [8, 40, 96, 100, 112, 200])
def test_bf16_block_routes_by_class(recorded, D):
    """bf16 at a width below its class: the class's library, the true D,
    the launch plan at the class's tiles. A width that is a multiple of 8
    goes in as the ring's views (byte strides of the views); 100 comes as
    a zero-padded copy of 104 columns, counted in padded_calls."""
    q = _meta(2, 64, 4, D)[:, 32:].transpose(1, 2)
    kv = _meta(2, 64, 2, D)[:, 32:].transpose(1, 2)
    before = tra.block_attention.padded_calls
    o, m, l = tra.block_attention(q, kv, kv, 32, 0, True)
    (lib, entry, args), = recorded.calls
    cls = head_dims.width_class(D, "block_attention")
    assert lib == head_dims.library("ring_attention", cls)
    assert entry == "ring_block_attention_bf16" and args[11] == D
    assert o.shape == (2, 4, 32, D) and m.shape == l.shape == (2, 4, 32)
    padded = D % 8 != 0
    assert tra.block_attention.padded_calls == before + padded
    if padded:
        row = -(-D // 8) * 8
        assert args[14:17] == (4 * 32 * row * 2, 32 * row * 2, row * 2)
    else:
        assert args[14:17] == (64 * 4 * D * 2, D * 2, 4 * D * 2)
    assert args[23] == 1
    assert args[24] == tra.block_plan(2, 4, 32, 32, cls)


@pytest.mark.parametrize("D, padded", [(100, False), (36, False),
                                       (99, True), (6, True)])
def test_f32_block_pads_only_rows_of_partial_vectors(recorded, D, padded):
    """f32 reads whole 16-byte vectors: a multiple of 4 goes in as it is,
    any other width as a zero-padded copy to a multiple of 8, still with
    the true D."""
    q = _meta(1, 2, 16, D, dtype=torch.float32)
    before = tra.block_attention.padded_calls
    tra.block_attention(q, q, q, 0, 0, False)
    (lib, entry, args), = recorded.calls
    assert entry == "ring_block_attention" and args[11] == D
    assert tra.block_attention.padded_calls == before + padded
    row = -(-D // 8) * 8 if padded else D
    assert args[14:17] == (2 * 16 * row, 16 * row, row)


@pytest.mark.parametrize("D", [257, 384])
def test_wider_than_256_raises_before_any_launch(recorded, D):
    before = (tpa.paged_attention.launches, tra.block_attention.launches)
    with pytest.raises(ValueError, match="B5"):
        tpa.paged_attention(_meta(2, 2, D), _meta(4, 1, 4, D),
                            _meta(4, 1, 4, D), _meta(2, 2, dtype=torch.int32),
                            _meta(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="B5"):
        tra.block_attention(*(_meta(1, 2, 8, D) for _ in range(3)))
    assert not recorded.calls
    assert (tpa.paged_attention.launches,
            tra.block_attention.launches) == before


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"])
@pytest.mark.parametrize("D", head_dims.FLASH)
def test_bf16_flash_routes_by_width(recorded, D, kernel):
    """bf16 reaches each flash kernel's bf16 entry with byte strides and
    no dtype code, in its width's library, at every width; that library
    routes the kernel through the wgmma + TMA kernels (the forward's
    template, the backward's kernels at 128 and 256), none through the
    FMA tiles."""
    from ray_tpu_torch.ops import _build

    route = "FORWARD" if kernel == "flash_fwd" else "BACKWARD"
    _path, defines = _build.sources()[head_dims.library("flash_attention",
                                                        D)]
    assert f"-DRAY_TPU_SM90_{route}=1" in defines
    q = _meta(2, 37, 4, D).transpose(1, 2)
    rows = _meta(2, 4, 37, dtype=torch.float32)
    if kernel == "flash_fwd":
        tf.flash_fwd(q, q, q)
    else:
        getattr(tf, kernel)(q, q, q, q, rows, rows)
    (lib, entry, args), = recorded.calls
    assert lib == head_dims.library("flash_attention", D)
    assert entry == f"flash_attention_{kernel.removeprefix('flash_')}_bf16"
    # the tail: (batch, head, seq) strides, causal, device, stream
    assert args[-6:-3] == (37 * 4 * D * 2, D * 2, 4 * D * 2)


@pytest.mark.parametrize("D", WIDTHS)
def test_each_width_builds_with_its_routes(D):
    """Each width's library is its source compiled with the width and its
    bf16 routes: the forwards on wgmma at head_dims.SM90_FORWARD (every
    width: kernel 2 at 16 and 32 too), the flash backward at
    head_dims.SM90_BACKWARD (128 and 256, every width flash takes)."""
    from ray_tpu_torch.ops import _build

    srcs = _build.sources()
    for source, widths in head_dims.SOURCES.items():
        if D not in widths:
            assert head_dims.library(source, D) not in srcs
            continue
        path, defines = srcs[head_dims.library(source, D)]
        assert path == _build.CSRC / f"{source}.cu"
        assert defines == (
            f"-DRAY_TPU_HEAD_DIM={D}",
            "-DRAY_TPU_SM90_FORWARD=1",
            f"-DRAY_TPU_SM90_BACKWARD={int(D in (128, 256))}")


@pytest.mark.parametrize("D", [16, 32])
def test_narrow_ring_libraries_build_the_sm90_forward(D):
    """Kernel 2's libraries at 16 and 32 build with
    -DRAY_TPU_SM90_FORWARD=1: bf16 runs the wgmma + TMA split kernel there
    (32- and 64-byte swizzled boxes), and no bf16 call reaches the FMA
    tiles (ring_attention.cu asserts the define at compile time)."""
    from ray_tpu_torch.ops import _build

    path, defines = _build.sources()[head_dims.library("ring_attention", D)]
    assert "-DRAY_TPU_SM90_FORWARD=1" in defines
    source = path.read_text()
    assert "static_assert(RAY_TPU_SM90_FORWARD," in source
    assert "ring_block_kernel<bf16" not in source
