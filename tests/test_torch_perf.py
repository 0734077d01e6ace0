"""The port's ``_private/perf.py`` against the reference's, on the CPU.

- The two modules define the same sections, with the reference's
  parameters in the reference's order and with its defaults, read
  through ``ast`` (no import of the reference module needed). Where the
  port differs on purpose it is listed here: ``e2e_task_throughput``
  takes ``system_config`` (``{"worker_mode": ...}``) in place of
  ``mode``; sections that touch the card take ``device`` (None: the
  card), sections that start a runtime take ``system_config`` (the tests
  pass ``{"sched_device": "cpu"}``).
  The port's ``flops_per_step`` is the reference's private
  ``_flops_per_step`` without a compiler to ask.
- Every key a section returns beyond the reference's is named in its
  docstring, after "Keys added to the reference's:" (``added_keys``, which
  the other ``test_torch_perf_*`` files import), and occurs in the
  section's code.
- Each section that touches the card raises on a host without one
  unless it is given ``device="cpu"``.
- ``llm_decode_throughput`` and ``model_time_sinks`` at smoke size,
  through both packages with the same arguments: keys, and counted
  quantities (bounds: equal, exactly). Their times are this host's and
  are not compared.
"""

import ast
import math
import re
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from ray_tpu_torch._private import perf  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
REF_PERF = REPO / "ray_tpu" / "_private" / "perf.py"
PORT_PERF = REPO / "ray_tpu_torch" / "_private" / "perf.py"

# parameters of the reference's the port leaves out, and the port's own
# (each trailing, keyword, default None)
DROPPED = {"e2e_task_throughput": ("mode",)}
ADDED = {
    "e2e_task_throughput": ("system_config",),
    "data_pipeline_throughput": ("system_config", "own_runtime"),
    "data_ingest_overlap": ("system_config",),
    "data_arrow_throughput": ("system_config",),
    "data_shuffle_throughput": ("system_config",),
    "data_join_throughput": ("system_config",),
    "qos_ab": ("system_config",),
    "rl_rollout_throughput": ("device",),
    "locality_ab": ("system_config",),
    "head_bypass_ab": ("system_config",),
    "model_mfu": ("device",),
    "model_time_sinks": ("device",),
    "llm_decode_throughput": ("device",),
    "serving_ab": ("device", "system_config"),
}
# own_runtime=True is the reference's behaviour (start and stop a runtime)
ADDED_DEFAULTS = {("data_pipeline_throughput", "own_runtime"): True}


def _module(path):
    return ast.parse(path.read_text())


def _functions(tree):
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _params(fn):
    """[(name, default)] in order; a parameter without one gets Ellipsis."""
    a = fn.args
    names = [p.arg for p in a.args + a.kwonlyargs]
    defaults = ([...] * (len(a.args) - len(a.defaults))
                + [ast.literal_eval(d) for d in a.defaults]
                + [... if d is None else ast.literal_eval(d)
                   for d in a.kw_defaults])
    return list(zip(names, defaults))


def _constants(tree):
    out = {}
    for n in tree.body:
        if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out[n.target.id] = n.value
        elif isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name):
            out[n.targets[0].id] = n.value
    return out


def test_the_port_defines_the_reference_sections():
    ref, port = _functions(_module(REF_PERF)), _functions(_module(PORT_PERF))
    ref_public = {n for n in ref if not n.startswith("_")}
    port_public = {n for n in port if not n.startswith("_")}
    assert len(ref_public) == 14, sorted(ref_public)
    assert port_public == ref_public | {"flops_per_step"}, (
        sorted(port_public ^ ref_public))
    assert set(ADDED) == ref_public


@pytest.mark.parametrize("name", sorted(ADDED))
def test_each_section_keeps_the_reference_signature(name):
    ref = _functions(_module(REF_PERF))[name]
    port = _functions(_module(PORT_PERF))[name]
    want = [p for p in _params(ref) if p[0] not in DROPPED.get(name, ())]
    got = _params(port)
    assert got[:len(want)] == want, (got, want)
    extra = got[len(want):]
    assert [n for n, _ in extra] == list(ADDED[name])
    for n, d in extra:
        assert d == ADDED_DEFAULTS.get((name, n)), (name, n, d)


def test_smoke_configs_are_the_reference_ones():
    ref, port = _constants(_module(REF_PERF)), _constants(_module(PORT_PERF))
    for name in ("SMOKE_MODEL", "SMOKE_DECODE"):
        assert ast.literal_eval(port[name]) == ast.literal_eval(ref[name])
    assert perf.SMOKE_DECODE == ast.literal_eval(ref["SMOKE_DECODE"])


def test_perf_imports_nothing_of_the_reference():
    """perf.py's imports, at module level and inside every section."""
    banned = ("jax", "flax", "optax", "ray_tpu")
    for node in ast.walk(_module(PORT_PERF)):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in banned, m


def added_keys(name):
    """The keys section ``name`` adds to the reference's: those its
    docstring names in double backquotes after "Keys added to the
    reference's:" (none where it says nothing of it)."""
    doc = " ".join(getattr(perf, name).__doc__.split())
    _, said, tail = doc.partition("Keys added to the reference's:")
    return set(re.findall(r"``(\w+)``", tail)) if said else set()


# the sections that return a dict of keys (model_time_sinks returns rows)
DICT_SECTIONS = sorted(set(ADDED) - {"model_time_sinks"})


@pytest.mark.parametrize("name", DICT_SECTIONS)
def test_added_keys_are_named_in_the_docstring(name):
    """Each key the docstring lists is a string the section's code holds
    (a key of the dict it returns); "Keys added" is said once, last."""
    fn = _functions(_module(PORT_PERF))[name]
    strings = {n.value for n in ast.walk(fn)
               if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    keys = added_keys(name)
    assert keys <= strings, sorted(keys - strings)
    doc = " ".join(getattr(perf, name).__doc__.split())
    assert doc.count("Keys added") == (1 if keys else 0)


def assert_keys(name, got, want):
    """The port's keys are the reference's plus exactly its listed ones."""
    assert set(want) <= set(got), sorted(set(want) - set(got))
    assert set(got) - set(want) == added_keys(name), (
        sorted(set(got) - set(want)))


CARD_SECTIONS = {
    "llm_decode_throughput": lambda: perf.llm_decode_throughput(smoke=True),
    "model_time_sinks": lambda: perf.model_time_sinks(smoke=True),
    "serving_ab": lambda: perf.serving_ab(False, sessions=1, turns=1,
                                          max_new=2),
    "model_mfu": lambda: perf.model_mfu(smoke=True),
    "rl_rollout_throughput": lambda: perf.rl_rollout_throughput(iters=1),
}


@pytest.mark.parametrize("name", sorted(CARD_SECTIONS))
def test_card_sections_without_a_device_raise(name):
    """No device means the card: without one a section raises before it
    starts anything, and names the way to the host path."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    import ray_tpu_torch

    if name == "rl_rollout_throughput":
        # it runs on the caller's runtime, which the host path needs
        ray_tpu_torch.init(num_workers=2,
                           _system_config={"sched_device": "cpu"})
    try:
        with pytest.raises(RuntimeError, match="CUDA.*device='cpu'"):
            CARD_SECTIONS[name]()
    finally:
        ray_tpu_torch.shutdown()


@pytest.mark.parametrize("batch_slots", [None, 3])
def test_llm_decode_throughput_matches_the_reference(batch_slots):
    """SMOKE_DECODE through both engines: the same slots, new tokens,
    parameter count and tokens generated; on the CPU kernel 1's counter
    stays 0 (the wrapper takes its plain version) and the engine's decode
    steps cover every token."""
    from ray_tpu._private import perf as rperf

    want = rperf.llm_decode_throughput(smoke=True, batch_slots=batch_slots)
    got = perf.llm_decode_throughput(smoke=True, batch_slots=batch_slots,
                                     device="cpu")
    assert_keys("llm_decode_throughput", got, want)
    slots = batch_slots or perf.SMOKE_DECODE["batch"]
    for k in ("batch_slots", "new_tokens", "n_params"):
        assert got[k] == want[k], (k, got[k], want[k])
    assert got["batch_slots"] == slots
    ref_tokens = round(want["tokens_per_sec"] * want["seconds"])
    assert got["tokens"] == ref_tokens == slots * got["new_tokens"]
    assert got["device"] == "cpu" and got["paged_attention_launches"] == 0
    assert got["decode_steps"] >= got["new_tokens"] - 1
    assert got["tokens_per_sec"] > 0 and got["seconds"] > 0


def test_decode_width_has_the_reference_parameter_count():
    """At the serving width (127M): the port's init_params holds as many
    parameters as flax's init of the reference's model (shapes only)."""
    import jax.numpy as jnp

    from ray_tpu.models.transformer import Transformer as JTransformer
    from ray_tpu.models.transformer import TransformerConfig as JConfig
    from ray_tpu_torch.models.transformer import (TransformerConfig,
                                                  init_params, param_count)

    width = dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=8,
                 n_kv_heads=4, d_ff=2816, max_seq_len=2048)
    shapes = jax.eval_shape(
        lambda: JTransformer(JConfig(**width)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    want = sum(math.prod(x.shape)
               for x in jax.tree_util.tree_leaves(shapes["params"]))
    got = param_count(init_params(TransformerConfig(**width),
                                  torch.Generator().manual_seed(0)))
    assert got == want == 127_157_248


def _check_sinks(rows, top_k):
    assert 0 < len(rows) <= top_k
    shares = [r["pct_of_device_time"] for r in rows]
    assert shares == sorted(shares, reverse=True)
    assert all(0 < s <= 100 for s in shares), shares
    assert sum(shares) <= 100.05
    assert all(isinstance(r["op"], str) and r["op"] for r in rows)


def test_model_time_sinks_has_the_reference_form():
    """[{op, pct_of_device_time}], at most top_k, descending, each share in
    (0, 100], summing to at most 100.05, as the reference's; with every op
    (a large top_k) the shares sum to 100. On the CPU the ops are aten
    operators; the train step's matrix products are among them."""
    from ray_tpu._private import perf as rperf

    want = rperf.model_time_sinks(smoke=True)
    got = perf.model_time_sinks(smoke=True, device="cpu")
    _check_sinks(want, 5)
    _check_sinks(got, 5)
    assert {frozenset(r) for r in got} == {frozenset(r) for r in want} == {
        frozenset({"op", "pct_of_device_time"})}
    every = perf.model_time_sinks(top_k=10_000, smoke=True, device="cpu")
    _check_sinks(every, 10_000)
    assert sum(r["pct_of_device_time"] for r in every) == pytest.approx(100)
    assert any(r["op"] in ("aten::mm", "aten::bmm", "aten::addmm")
               for r in every)
