"""Serve's LLM deployments on the port (``ray_tpu_torch.serve.llm``), on
the CPU, against the JAX reference.

The model is the reference's tiny f32 config (``tests/test_serve_scale.py``),
initialised by flax and converted with ``params_from_jax``; every
deployment runs its engine with ``device="cpu"`` (the paged-attention
wrapper's plain path). Whatever path a token takes — the mono continuous
batch, stream polls, SSE over HTTP, sticky SSE across two replicas, the
prefill-export -> decode-import handoff, a cached session replay, or the
resume after a decode replica is killed mid-stream — the client must get
EXACTLY the greedy tokens of the JAX model's full-context forward
(``naive_greedy``, the reference's oracle). Also: SLO admission, the
seeded chaos soak, the metrics plane's Serve families (zeros without
Serve, the reference's family set, and a scrape of ``metrics_export_port``
after Serve traffic).
"""

import http.client
import json
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import ray_tpu  # noqa: E402
import ray_tpu_torch as ray  # noqa: E402
from ray_tpu._private import metrics as ref_metrics  # noqa: E402
from ray_tpu.models.transformer import Transformer as JTransformer  # noqa: E402
from ray_tpu.models.transformer import (  # noqa: E402
    TransformerConfig as JConfig)
from ray_tpu_torch import chaos, serve  # noqa: E402
from ray_tpu_torch._private import metrics, worker  # noqa: E402
from ray_tpu_torch._private.config import GLOBAL_CONFIG  # noqa: E402
from ray_tpu_torch.models import transformer as tt  # noqa: E402
from ray_tpu_torch.models.inference import InferenceConfig  # noqa: E402
from ray_tpu_torch.serve import core  # noqa: E402
from ray_tpu_torch.serve.llm import build_llm_app, run_disagg_llm  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq_len=128)
RUNTIME = dict(scheduler="tensor",
               _system_config={"sched_backend": "cuda", "sched_device": "cpu"})


@pytest.fixture(scope="module")
def tiny_model():
    """(port config, JAX model, JAX params, port params)."""
    jcfg = JConfig(dtype=jnp.float32, **TINY)
    model = JTransformer(jcfg)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 8), jnp.int32))
    params = tt.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       variables))
    tcfg = tt.TransformerConfig(dtype=torch.float32, **TINY)
    return tcfg, model, variables["params"], params


def naive_greedy(model, params, prompt, n_new):
    """The reference's oracle: the JAX model re-run on the whole
    sequence at every step."""
    toks = list(prompt)
    for _ in range(n_new):
        logits = model.apply({"params": params},
                             jnp.asarray([toks], jnp.int32))
        toks.append(int(jnp.argmax(logits[0, -1])))
    return toks[len(prompt):]


def _engine_cfg(max_new=8, decode_chunk=2, batch=2):
    return InferenceConfig(batch_size=batch, page_size=4,
                           max_pages_per_seq=16, num_pages=64,
                           prefill_buckets=(16,), max_new_tokens=max_new,
                           decode_chunk=decode_chunk)


def _mono_cfg():
    return InferenceConfig(batch_size=2, page_size=4, max_pages_per_seq=8,
                           num_pages=32, prefill_buckets=(8,),
                           decode_chunk=2)


@pytest.fixture
def rt():
    ray.shutdown()
    ray.init(num_workers=8, **RUNTIME)
    yield ray
    chaos.disarm()
    serve.shutdown()
    ray.shutdown()


def _drive(handle, prompt, max_new, session, on_frame=None):
    """Drain one disagg stream; returns the delivered token list."""
    out = []
    for fr in handle.stream_frames(prompt, max_new, session_id=session):
        out.extend(fr.get("tokens") or ())
        if on_frame is not None:
            on_frame(out)
    return out


def _sse_tokens(port, body):
    """POST /llm/stream; returns (status, content type, tokens, events)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/llm/stream", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        tokens, events, buf = [], 0, b""
        while True:
            chunk = resp.read(1)
            if not chunk:
                break
            buf += chunk
            while b"\n\n" in buf:
                raw, buf = buf.split(b"\n\n", 1)
                assert raw.startswith(b"data: ")
                ev = json.loads(raw[len(b"data: "):])
                assert "error" not in ev, ev
                events += 1
                tokens.extend(ev["tokens"])
        return resp.status, resp.getheader("Content-Type"), tokens, events
    finally:
        conn.close()


# -- the mono deployment (tests/test_inference.py's Serve cases) -------------

class TestLLMDeployment:
    def test_serve_llm_deployment(self, rt, tiny_model):
        cfg, model, jparams, params = tiny_model
        handle = serve.run(build_llm_app(params, cfg, _mono_cfg(),
                                         device="cpu"))
        prompt = [4, 8, 15]
        got = ray.get(handle.generate.remote(prompt, 5), timeout=120.0)
        assert got == naive_greedy(model, jparams, prompt, 5)
        st = ray.get(handle.engine_stats.remote(), timeout=30)
        assert st["active"] == 0

    def test_serve_llm_stream_polls(self, rt, tiny_model):
        """The replica's poll protocol (start_stream/next_tokens)
        delivers the full generation incrementally across >= 2 polls."""
        cfg, model, jparams, params = tiny_model
        handle = serve.run(build_llm_app(params, cfg, _mono_cfg(),
                                         device="cpu"))
        prompt = [4, 8, 15]
        # budget > pending-cap x chunk: the engine needs >= 2 bursts
        want = naive_greedy(model, jparams, prompt, 16)
        sid = ray.get(handle.start_stream.remote(prompt, 16), timeout=120.0)
        got, polls = [], 0
        for _ in range(100):
            r = ray.get(handle.next_tokens.remote(sid), timeout=120.0)
            polls += 1
            got.extend(r["tokens"])
            if r["done"]:
                break
        assert got == want
        assert polls >= 2  # incremental, not one lump

    def test_sse_stream_over_http(self, rt, tiny_model):
        """POST /llm/stream emits Server-Sent Events with the generated
        tokens, ending with done=true."""
        cfg, model, jparams, params = tiny_model
        serve.run(build_llm_app(params, cfg, _mono_cfg(), device="cpu"))
        port = serve.start_http(0)
        status, ctype, tokens, events = _sse_tokens(
            port, {"prompt": [4, 8, 15], "max_new_tokens": 16})
        assert status == 200 and ctype == "text/event-stream"
        assert events >= 1
        assert tokens == naive_greedy(model, jparams, [4, 8, 15], 16)
        assert core.metrics.snapshot()["ttft_count"] == 1

    def test_sse_stream_sticky_across_replicas(self, rt, tiny_model):
        """With num_replicas=2 every poll must hit the replica holding
        the stream: load-balanced polls would land on strangers."""
        cfg, model, jparams, params = tiny_model
        serve.run(build_llm_app(params, cfg, _mono_cfg(), num_replicas=2,
                                device="cpu"))
        port = serve.start_http(0)
        want = naive_greedy(model, jparams, [4, 8, 15], 12)
        for _ in range(4):  # several streams: routing would flake
            status, _ctype, tokens, _ = _sse_tokens(
                port, {"prompt": [4, 8, 15], "max_new_tokens": 12})
            assert status == 200
            assert tokens == want
        assert serve.status()["llm"]["replicas"] == 2


# -- disaggregated parity + cache-affinity routing ---------------------------

class TestDisaggParity:
    def test_split_pools_match_naive_greedy_and_route_affine(
            self, rt, tiny_model):
        """Every turn over the split pools equals the naive forward, and
        follow-up turns route back to the KV-holding decode replica:
        across 4 sessions x 2 follow-ups the hit rate is >= 80%, with
        first-ever turns counting neither hit nor miss."""
        cfg, model, jparams, params = tiny_model
        max_new = 8
        handle = run_disagg_llm(params, cfg, _engine_cfg(max_new),
                                prefill_replicas=1, decode_replicas=2,
                                device="cpu")
        prompts = {f"sess-{i}": [3 + i, 14, 15, 9 + i, 2]
                   for i in range(4)}
        want = {s: naive_greedy(model, jparams, p, max_new)
                for s, p in prompts.items()}
        for s, p in prompts.items():
            assert _drive(handle, p, max_new, s) == want[s], s
        snap = core.metrics.snapshot()
        assert snap["affinity_hit"] == 0 and snap["affinity_miss"] == 0
        # 2 layers x 5 tokens x 2 KV heads x 8 x 4 bytes, K and V, x 4
        assert snap["kv_bytes"] == 4 * 2 * (2 * 5 * 2 * 8 * 4)
        kv_before = snap["kv_bytes"]
        for _turn in range(2):
            for s, p in prompts.items():
                assert _drive(handle, p, max_new, s) == want[s], s
        snap = core.metrics.snapshot()
        hits, misses = snap["affinity_hit"], snap["affinity_miss"]
        assert hits + misses == 8, snap
        assert hits / (hits + misses) >= 0.8, snap
        assert snap["kv_bytes"] == kv_before, (
            "cached replays must not re-export KV pages")
        stats = serve.serving_stats()
        assert stats["kv_sessions"] == 4
        names = {d["name"] for d in stats["deployments"]}
        assert {"llm_prefill", "llm_decode"} <= names

    def test_mid_stream_replica_kill_resumes_bit_identical(
            self, rt, tiny_model):
        """Kill the decode replica holding the stream after >= 2 tokens
        are with the client: the driver re-prefills prompt + delivered
        on the survivor and the client's sequence is EXACTLY the naive
        reference — no double-delivered, no divergent token."""
        cfg, model, jparams, params = tiny_model
        max_new = 24
        handle = run_disagg_llm(params, cfg,
                                _engine_cfg(max_new, decode_chunk=1),
                                prefill_replicas=1, decode_replicas=2,
                                device="cpu")
        prompt = [4, 8, 15, 16, 23]
        want = naive_greedy(model, jparams, prompt, max_new)
        dec_state = core.get_app_handle("llm_decode")._state()
        killed = []

        def kill_once(delivered):
            if killed or len(delivered) < 2:
                return
            _status, victim, _ = core.kv_directory.lookup("res-1", dec_state)
            if victim is None:
                with dec_state._lock:
                    victim = dec_state._replicas[0]
            ray.kill(victim.actor)
            killed.append(victim)

        got = _drive(handle, prompt, max_new, "res-1", on_frame=kill_once)
        assert killed, "kill never armed — stream finished too fast"
        assert got == want, (got, want)
        assert core.metrics.snapshot()["resumed"] >= 1
        # the killed replica's entry was invalidated: the session is still
        # KNOWN, and a follow-up re-prefills correctly
        assert core.kv_directory.known("res-1")
        assert _drive(handle, prompt, max_new, "res-1") == want


# -- SLO-aware admission ------------------------------------------------------

class TestSLOAdmission:
    def test_shed_over_target_then_recover(self, tiny_model):
        """With recent p95 TTFT over serve_slo_ttft_p95_s AND a stream in
        flight, a NEW stream sheds at ingress; once load drains the gate
        self-heals."""
        cfg, _model, _jparams, params = tiny_model
        ray.shutdown()
        ray.init(num_workers=8, scheduler="tensor", _system_config={
            **RUNTIME["_system_config"], "serve_slo_ttft_p95_s": 0.05})
        try:
            max_new = 4
            handle = run_disagg_llm(params, cfg, _engine_cfg(max_new),
                                    prefill_replicas=1, decode_replicas=1,
                                    device="cpu")
            dec_state = core.get_app_handle("llm_decode")._state()
            assert float(GLOBAL_CONFIG.serve_slo_ttft_p95_s) == 0.05
            # warm (an IDLE pool never sheds, whatever the window says)
            assert len(handle.generate([1, 2, 3], max_new)) == max_new
            for _ in range(8):
                core.metrics.record_ttft(1.0)  # way over target
            # an open sticky session is the load
            ref, token = dec_state.submit_sticky("engine_stats", (), {})
            ray.get(ref, timeout=30)
            with pytest.raises(serve.AdmissionShedError):
                next(handle.stream_frames([1, 2, 3], max_new))
            shed = core.metrics.snapshot()["admission_shed"]
            assert shed >= 1
            dec_state.end_sticky(token)

            def busy():
                with dec_state._lock:
                    return (sum(r.ongoing for r in dec_state._replicas)
                            + len(dec_state._sticky))

            deadline = time.monotonic() + 10
            while busy() and time.monotonic() < deadline:
                time.sleep(0.02)
            assert busy() == 0
            assert len(handle.generate([1, 2, 3], max_new)) == max_new
            assert core.metrics.snapshot()["admission_shed"] == shed
        finally:
            serve.shutdown()
            ray.shutdown()


# -- chaos serving soak -------------------------------------------------------

class TestChaosServingSoakSeeded:
    def test_seeded_soak_bit_correct_with_zero_double_decodes(
            self, rt, tiny_model):
        """Concurrent sessions stream over the split pools while a seeded
        task-site plan injects exceptions and hangs into the cluster's
        plain-task lane AND a decode replica is killed mid-stream. Every
        session's sequence must equal the naive reference exactly."""
        cfg, model, jparams, params = tiny_model
        max_new = 16
        handle = run_disagg_llm(params, cfg,
                                _engine_cfg(max_new, decode_chunk=1),
                                prefill_replicas=1, decode_replicas=2,
                                device="cpu")
        prompts = {f"soak-{i}": [1 + i, 9, 33, 7 + i] for i in range(3)}
        want = {s: naive_greedy(model, jparams, p, max_new)
                for s, p in prompts.items()}
        for s, p in prompts.items():      # warm pass before the faults
            assert _drive(handle, p, max_new, s) == want[s]

        chaos.arm(chaos.FaultPlan(4242, faults=[
            ("task", 5, "exception"),
            ("task", 11, "hang", {"hang_s": 0.1}),
            ("task", 19, "exception"),
        ]))

        @ray.remote
        def _noise(x):
            return x * 3

        noise_ok = []

        def noise_lane():
            for i in range(30):
                try:
                    if ray.get(_noise.remote(i), timeout=30) == i * 3:
                        noise_ok.append(i)
                except Exception:  # noqa: BLE001 — injected crash
                    pass

        dec_state = core.get_app_handle("llm_decode")._state()
        killed = []
        kill_lock = threading.Lock()

        def kill_once(delivered):
            with kill_lock:
                if killed or len(delivered) < 2:
                    return
                _status, victim, _ = core.kv_directory.lookup(
                    "soak-0", dec_state)
                if victim is None:
                    with dec_state._lock:
                        victim = dec_state._replicas[0]
                ray.kill(victim.actor)
                killed.append(victim)

        got, errs = {}, []

        def session(s, with_kill):
            try:
                got[s] = _drive(handle, prompts[s], max_new, s,
                                on_frame=kill_once if with_kill else None)
            except Exception as e:  # noqa: BLE001 — re-raised below
                errs.append((s, e))

        threads = [threading.Thread(target=session, args=(s, i == 0),
                                    daemon=True)
                   for i, s in enumerate(prompts)]
        threads.append(threading.Thread(target=noise_lane, daemon=True))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive(), "soak session hung"
        chaos.disarm()
        assert not errs, errs
        assert killed, "the mid-stream kill never armed"
        for s in prompts:
            assert got[s] == want[s], (s, got[s], want[s])
        assert core.metrics.snapshot()["resumed"] >= 1
        ctr = chaos.counters()
        assert ctr["injected_total"] >= 1, ctr
        assert len(noise_ok) >= 20, (len(noise_ok), ctr)


# -- the metrics plane --------------------------------------------------------

_SERVE_ZEROS = (
    'ray_tpu_serve_ttft_seconds_bucket{le="+Inf"} 0',
    "ray_tpu_serve_ttft_seconds_sum 0",
    "ray_tpu_serve_ttft_seconds_count 0",
    "ray_tpu_serve_affinity_hit_total 0",
    "ray_tpu_serve_affinity_miss_total 0",
    "ray_tpu_serve_admission_shed_total 0",
    "ray_tpu_kv_pages_transferred_bytes_total 0")


def test_serve_metric_families_render_zeros_without_serve():
    """A scrape of a runtime that NEVER imported ray_tpu_torch.serve still
    renders every serving family as zeros (a fresh interpreter, so the
    no-import precondition holds)."""
    code = f"""
import sys
import ray_tpu_torch
ray_tpu_torch.init(num_workers=1, _system_config={{"sched_device": "cpu"}})
from ray_tpu_torch._private import metrics, worker
text = metrics.render_all(worker.get_worker())
assert "ray_tpu_torch.serve.core" not in sys.modules
for needle in {_SERVE_ZEROS!r}:
    assert needle in text, needle
ray_tpu_torch.shutdown()
print("OK")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-2000:]


def _skeleton(text):
    """A scrape without its values: HELP/TYPE lines whole, each sample by
    its name and labels. Per-site chaos series appear only after an
    injection, so they are left out."""
    return [line if line.startswith("#") else line.rsplit(" ", 1)[0]
            for line in text.splitlines() if 'site="' not in line]


def test_scrape_has_the_reference_families_line_for_line():
    """With no traffic, the port's runtime families (render_all without
    the user metrics, which each package's process-wide registry holds)
    are the reference's: names, HELP texts and label sets in the
    reference's order; the planes the port lacks render as the
    reference renders them off."""
    ray_tpu.shutdown()
    ray_tpu.init(num_workers=1, scheduler="event")
    try:
        want = _skeleton("\n".join(ref_metrics._render_core(
            ray_tpu._private.worker.get_worker())))
    finally:
        ray_tpu.shutdown()
    ray.shutdown()
    ray.init(num_workers=1, scheduler="event")
    try:
        got = _skeleton("\n".join(metrics._render_core(
            worker.get_worker())))
    finally:
        ray.shutdown()
    assert got == want
    assert any("ray_tpu_serve_ttft_seconds" in line for line in got)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_metrics_export_port_scrape_after_serve_traffic(tiny_model):
    """init(metrics_export_port=...) serves the Prometheus endpoint; after
    mono and split-pool Serve traffic its scrape holds every ray_tpu_serve_
    family the reference renders, with the traffic counted."""
    cfg, model, jparams, params = tiny_model
    port = _free_port()
    ray.shutdown()
    ray.init(num_workers=8, scheduler="tensor", _system_config={
        **RUNTIME["_system_config"], "metrics_export_port": port})
    try:
        assert worker.get_worker().metrics_server.port == port
        serve.run(build_llm_app(params, cfg, _mono_cfg(), device="cpu"))
        frames = list(core._frames_for("llm", [4, 8, 15], 6))
        assert [t for f in frames for t in f["tokens"]] == naive_greedy(
            model, jparams, [4, 8, 15], 6)
        # the split pools beside the mono app (serve.shutdown would reset
        # the counters this scrape reads)
        handle = run_disagg_llm(params, cfg, _engine_cfg(6),
                                device="cpu")
        assert _drive(handle, [5, 6, 7], 6, "m-1") == naive_greedy(
            model, jparams, [5, 6, 7], 6)
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=30).read().decode()
    finally:
        serve.shutdown()
        ray.shutdown()
    families = re.findall(r"^# TYPE (ray_tpu_(?:serve|kv)_\S+) (\S+)$",
                          "\n".join(ref_metrics._render_serve()), re.M)
    assert len(families) == 5
    for name, kind in families:
        assert f"# TYPE {name} {kind}" in body, name
    samples = dict(line.rsplit(" ", 1) for line in body.splitlines()
                   if line and not line.startswith("#"))
    assert float(samples["ray_tpu_serve_ttft_seconds_count"]) == 2
    # 2 layers x 3 tokens x 2 KV heads x 8 x 4 bytes, K and V
    assert float(samples["ray_tpu_kv_pages_transferred_bytes_total"]) == \
        2 * (2 * 3 * 2 * 8 * 4)
    # the endpoint closed with the runtime
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                               timeout=5)
