"""ray_tpu_torch's InferenceEngine against ray_tpu's, on the CPU.

Both engines get the same flax-initialised tiny f32 model (the config of
tests/test_inference.py); the port runs with ``device="cpu"``, where its
paged-attention wrapper takes the plain PyTorch path. Greedy token
streams must be EXACTLY equal — ragged prompts, more requests than
slots, streaming, and the prefill-export -> decode-import hand-off.
Also: the port imports no JAX, and without CUDA an engine with no
``device`` refuses to start.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import inference as jinf  # noqa: E402
from ray_tpu.models.transformer import Transformer as JTransformer  # noqa: E402
from ray_tpu.models.transformer import (  # noqa: E402
    TransformerConfig as JConfig)
from ray_tpu_torch.models import inference as tinf  # noqa: E402
from ray_tpu_torch.models import transformer as tt  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq_len=128)


@pytest.fixture(scope="module")
def tiny():
    jcfg = JConfig(dtype=jnp.float32, **TINY)
    variables = JTransformer(jcfg).init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 8), jnp.int32))
    params = tt.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       variables))
    tcfg = tt.TransformerConfig(dtype=torch.float32, **TINY)
    return jcfg, variables["params"], tcfg, params


def _run(engine, prompts, max_new):
    try:
        futs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
        return [f.result(timeout=120) for f in futs]
    finally:
        engine.shutdown()


def _both(tiny, icfg, prompts, max_new):
    jcfg, jparams, tcfg, params = tiny
    want = _run(jinf.InferenceEngine(jparams, jcfg, icfg), prompts, max_new)
    port = tinf.InferenceEngine(params, tcfg, tinf.InferenceConfig(
        **vars(icfg)), device="cpu")
    got = _run(port, prompts, max_new)
    return got, want, port


def test_ragged_prompts_match_jax_engine(tiny):
    icfg = jinf.InferenceConfig(batch_size=3, page_size=4,
                                max_pages_per_seq=8, num_pages=32,
                                prefill_buckets=(8, 16))
    prompts = [[7], [1, 2, 3, 4, 5, 6, 7, 8], [9, 9, 9]]
    got, want, _ = _both(tiny, icfg, prompts, 5)
    assert got == want
    assert all(len(o) == 5 for o in got)


def test_more_requests_than_slots_match_jax_engine(tiny):
    icfg = jinf.InferenceConfig(batch_size=2, page_size=4,
                                max_pages_per_seq=8, num_pages=16,
                                prefill_buckets=(8,))
    prompts = [[i + 1, i + 2] for i in range(5)]
    got, want, port = _both(tiny, icfg, prompts, 6)
    assert got == want
    st = port.stats()
    assert st["active"] == 0 and st["queued"] == 0
    assert port.max_concurrent <= 2
    # all pages returned to the pool
    assert st["free_pages"] == icfg.num_pages - 1


def test_token_stream_matches_generate_and_jax(tiny):
    """submit_stream yields what generate() returns (small decode_chunk
    forces several sync bursts), and both equal the JAX engine."""
    jcfg, jparams, tcfg, params = tiny
    kw = dict(batch_size=2, page_size=4, max_pages_per_seq=8, num_pages=32,
              prefill_buckets=(8,), decode_chunk=2)
    prompt = [3, 14, 15]
    (want,) = _run(jinf.InferenceEngine(jparams, jcfg,
                                        jinf.InferenceConfig(**kw)),
                   [prompt], 8)
    engine = tinf.InferenceEngine(params, tcfg, tinf.InferenceConfig(**kw),
                                  device="cpu")
    try:
        gen = engine.generate(prompt, max_new_tokens=8)
        stream = engine.submit_stream(prompt, max_new_tokens=8)
        got = list(stream)
        assert stream.result(timeout=10) == got
    finally:
        engine.shutdown()
    assert got == gen == want


def test_prefill_export_to_decode_engine_matches_jax(tiny):
    """prefill-mode engine -> exported K/V + first token -> decode-mode
    engine: the stream equals the JAX monolithic engine's tokens."""
    jcfg, jparams, tcfg, params = tiny
    kw = dict(batch_size=2, page_size=4, max_pages_per_seq=8, num_pages=32,
              prefill_buckets=(8, 16), decode_chunk=4)
    prompts = [[4, 8, 15, 16, 23, 42], [1], [2, 7, 1, 8, 2, 8, 1, 8, 2]]
    want = _run(jinf.InferenceEngine(jparams, jcfg,
                                     jinf.InferenceConfig(**kw)), prompts, 7)
    pre = tinf.InferenceEngine(params, tcfg, tinf.InferenceConfig(**kw),
                               mode="prefill", device="cpu")
    dec = tinf.InferenceEngine(params, tcfg, tinf.InferenceConfig(**kw),
                               mode="decode", device="cpu")
    try:
        with pytest.raises(RuntimeError, match="mode"):
            dec.submit([1, 2], max_new_tokens=2)
        kvs = [pre.prefill_export(p, max_new_tokens=7) for p in prompts]
        assert kvs[0]["k"].shape == (2, 6, 2, 8)
        assert kvs[0]["kv_bytes"] == 2 * 2 * 6 * 2 * 8 * 4
        streams = [dec.submit_stream_from_kv(kv) for kv in kvs]
        got = [list(s) for s in streams]
        assert [s.result(timeout=10) for s in streams] == got
        assert dec.stats()["free_pages"] == kw["num_pages"] - 1
    finally:
        pre.shutdown()
        dec.shutdown()
    assert got == want
    assert [kv["first_token"] for kv in kvs] == [w[0] for w in want]


def test_engine_without_device_needs_cuda(tiny):
    _jcfg, _jparams, tcfg, params = tiny
    icfg = tinf.InferenceConfig(batch_size=1, page_size=4,
                                max_pages_per_seq=2, num_pages=8,
                                prefill_buckets=(8,))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tinf.InferenceEngine(params, tcfg, icfg)


def test_engine_rejects_oversized_and_empty(tiny):
    _jcfg, _jparams, tcfg, params = tiny
    engine = tinf.InferenceEngine(
        params, tcfg, tinf.InferenceConfig(batch_size=1, page_size=4,
                                           max_pages_per_seq=2, num_pages=8,
                                           prefill_buckets=(8,)),
        device="cpu")
    try:
        with pytest.raises(ValueError, match="max context"):
            engine.submit([1, 2, 3, 4], max_new_tokens=32)
        with pytest.raises(ValueError, match="empty"):
            engine.submit([])
    finally:
        engine.shutdown()


def test_port_imports_no_jax():
    code = ("import ray_tpu_torch, ray_tpu_torch.models.inference, "
            "ray_tpu_torch.ops.paged_attention; import sys; "
            "assert not any(m == 'jax' or m.startswith(('jax.', 'flax', "
            "'ray_tpu.')) or m == 'ray_tpu' for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
