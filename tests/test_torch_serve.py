"""Serve on the port's runtime (``ray_tpu_torch.serve``): the non-model
cases of ``tests/test_serve.py`` — deployments, routing, composition,
crash recovery, redeploy, HTTP ingress, autoscaling, multiplexing, gRPC
ingress, versioned rolling redeploys — and the multiplexing loader's
every-slot-mid-load case and the KV directory's node-death case
(``test_promotion_then_gone_when_sole_copy_node_dies``, on a remote
node in process mode) of ``tests/test_serve_scale.py``.

The runtime is thread mode with the TensorScheduler assigning every
batch through ``kernels.assign``'s plain version (``sched_device``
"cpu"). The model cases are in ``tests/test_torch_serve_llm.py``.
"""

import json
import threading
import time
import urllib.request

import pytest

import ray_tpu_torch as ray
from ray_tpu_torch import serve


@pytest.fixture
def rt():
    ray.shutdown()
    ray.init(num_workers=8, scheduler="tensor",
             _system_config={"sched_backend": "cuda", "sched_device": "cpu"})
    yield ray
    serve.shutdown()
    ray.shutdown()


class TestServe:
    def test_basic_deployment(self, rt):
        @serve.deployment(num_replicas=2)
        class Doubler:
            def __call__(self, x):
                return x * 2

        handle = serve.run(Doubler.bind())
        out = ray.get([handle.remote(i) for i in range(10)],
                          timeout=30)
        assert out == [i * 2 for i in range(10)]
        assert serve.status()["Doubler"]["replicas"] == 2

    def test_method_calls_and_state(self, rt):
        @serve.deployment
        class Counter:
            def __init__(self, start):
                self.n = start

            def incr(self):
                self.n += 1
                return self.n

        handle = serve.run(Counter.bind(10))
        assert ray.get(handle.incr.remote(), timeout=30) == 11
        assert ray.get(handle.incr.remote(), timeout=30) == 12

    def test_composition(self, rt):
        @serve.deployment
        class Embed:
            def __call__(self, x):
                return x + 1

        @serve.deployment
        class Pipeline:
            def __init__(self, embed):
                self.embed = embed

            def __call__(self, x):
                inner = ray.get(self.embed.remote(x), timeout=30)
                return inner * 100

        handle = serve.run(Pipeline.bind(Embed.bind()))
        assert ray.get(handle.remote(4), timeout=30) == 500

    def test_replica_crash_recovery(self, rt):
        @serve.deployment(num_replicas=2)
        class Svc:
            def __call__(self, x):
                return x

        handle = serve.run(Svc.bind())
        assert ray.get(handle.remote(1), timeout=30) == 1
        # kill ONE replica behind the router's back
        state = serve.core._controller.deployments["Svc"]
        ray.kill(state._replicas[0].actor)
        # requests keep succeeding (retry + replacement)
        out = ray.get([handle.remote(i) for i in range(20)],
                          timeout=30)
        assert out == list(range(20))
        assert serve.status()["Svc"]["replicas"] == 2

    def test_redeploy_updates(self, rt):
        @serve.deployment
        class V:
            def __call__(self, x):
                return "v1"

        handle = serve.run(V.bind())
        assert ray.get(handle.remote(0), timeout=30) == "v1"

        @serve.deployment(name="V")
        class V2:
            def __call__(self, x):
                return "v2"

        handle = serve.run(V2.bind())
        assert ray.get(handle.remote(0), timeout=30) == "v2"

    def test_options_scaling(self, rt):
        @serve.deployment
        class S:
            def __call__(self, x):
                return x

        serve.run(S.options(num_replicas=3).bind())
        assert serve.status()["S"]["replicas"] == 3

    def test_http_ingress(self, rt):
        @serve.deployment
        class Api:
            def __call__(self, payload):
                return {"sum": payload["a"] + payload["b"]}

        serve.run(Api.bind())
        port = serve.start_http(0)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/Api",
            data=json.dumps({"a": 2, "b": 3}).encode(),
            headers={"Content-Type": "application/json"})
        body = json.loads(urllib.request.urlopen(req, timeout=10).read())
        assert body == {"result": {"sum": 5}}


class TestAutoscaling:
    def test_scales_up_under_load_and_down_when_idle(self, rt):
        @serve.deployment(autoscaling_config=serve.AutoscalingConfig(
            min_replicas=1, max_replicas=3,
            target_ongoing_requests=1.0, interval_s=0.05))
        class Slow:
            def __call__(self, x):
                time.sleep(0.25)
                return x

        handle = serve.run(Slow.bind())
        assert serve.status()["Slow"]["replicas"] == 1
        refs = [handle.remote(i) for i in range(12)]
        deadline = time.monotonic() + 10
        peak = 1
        while time.monotonic() < deadline:
            peak = max(peak, serve.status()["Slow"]["replicas"])
            if peak >= 2:
                break
            time.sleep(0.05)
        assert peak >= 2, "never scaled up under queued load"
        assert ray.get(refs, timeout=60) == list(range(12))
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if serve.status()["Slow"]["replicas"] == 1:
                break
            time.sleep(0.05)
        assert serve.status()["Slow"]["replicas"] == 1


class TestMultiplexedModels:
    """Model multiplexing (reference: @serve.multiplexed +
    handle.options(multiplexed_model_id=...) + router model
    affinity): replicas hold a bounded LRU of loaded models and the
    router prefers a warm replica."""

    def test_loader_lru_and_model_id(self, rt):
        @serve.deployment(num_replicas=1)
        class Mux:
            def __init__(self):
                self.loads = []

            @serve.multiplexed(max_num_models_per_replica=2)
            def get_model(self, model_id):
                self.loads.append(model_id)
                return f"model-{model_id}"

            def __call__(self, x):
                mid = serve.get_multiplexed_model_id()
                model = self.get_model(mid)
                return (model, mid, list(self.loads))

        h = serve.run(Mux.bind())
        m, mid, loads = ray.get(
            h.options(multiplexed_model_id="a").remote(1), timeout=60)
        assert (m, mid) == ("model-a", "a")
        # warm hit: no reload
        _, _, loads = ray.get(
            h.options(multiplexed_model_id="a").remote(1), timeout=60)
        assert loads == ["a"]
        # b, c load; a evicts (LRU cap 2); a again -> reload
        for mid2 in ("b", "c", "a"):
            ray.get(h.options(
                multiplexed_model_id=mid2).remote(1), timeout=60)
        _, _, loads = ray.get(
            h.options(multiplexed_model_id="a").remote(1), timeout=60)
        assert loads == ["a", "b", "c", "a"]
        serve.shutdown()

    def test_router_prefers_warm_replica(self, rt):
        @serve.deployment(num_replicas=3)
        class Who:
            @serve.multiplexed(max_num_models_per_replica=4)
            def get_model(self, model_id):
                return model_id

            def __call__(self):
                self.get_model(serve.get_multiplexed_model_id())
                return id(self)

        h = serve.run(Who.bind())
        hm = h.options(multiplexed_model_id="m1")
        first = ray.get(hm.remote(), timeout=60)
        # the SAME replica serves subsequent m1 requests (affinity)
        for _ in range(6):
            assert ray.get(hm.remote(), timeout=60) == first
        serve.shutdown()

    def test_no_model_id_is_none(self, rt):
        @serve.deployment
        class Plain:
            def __call__(self):
                return serve.get_multiplexed_model_id()

        h = serve.run(Plain.bind())
        assert ray.get(h.remote(), timeout=60) is None
        serve.shutdown()


class TestGrpcIngress:
    """JSON-over-gRPC ingress (reference: serve's gRPC proxy): a
    generic-handler service — Predict (unary) and PredictStream
    (server-streaming, replica-sticky poll protocol)."""

    def test_predict_unary(self, rt):
        grpc = pytest.importorskip("grpc")

        @serve.deployment(num_replicas=2)
        class Echo:
            def __call__(self, x):
                return {"echo": x}

        serve.run(Echo.bind())
        port = serve.start_grpc()
        chan = grpc.insecure_channel(f"127.0.0.1:{port}")
        call = chan.unary_unary("/ray_tpu.serve.Ingress/Predict")
        reply = json.loads(call(json.dumps({"input": [1, 2]}).encode()))
        assert reply == {"result": {"echo": [1, 2]}}
        # named deployment
        reply = json.loads(call(json.dumps(
            {"deployment": "Echo", "input": "hi"}).encode()))
        assert reply == {"result": {"echo": "hi"}}
        chan.close()
        serve.shutdown()

    def test_predict_forwards_model_id(self, rt):
        grpc = pytest.importorskip("grpc")

        @serve.deployment
        class Mid:
            def __call__(self, x):
                return serve.get_multiplexed_model_id()

        serve.run(Mid.bind())
        port = serve.start_grpc()
        chan = grpc.insecure_channel(f"127.0.0.1:{port}")
        call = chan.unary_unary("/ray_tpu.serve.Ingress/Predict")
        reply = json.loads(call(json.dumps(
            {"input": 1, "multiplexed_model_id": "m-7"}).encode()))
        assert reply == {"result": "m-7"}
        chan.close()
        serve.shutdown()

    def test_predict_error_maps_to_status(self, rt):
        grpc = pytest.importorskip("grpc")

        @serve.deployment
        class Boom:
            def __call__(self, x):
                raise ValueError("grpc kapow")

        serve.run(Boom.bind())
        port = serve.start_grpc()
        chan = grpc.insecure_channel(f"127.0.0.1:{port}")
        call = chan.unary_unary("/ray_tpu.serve.Ingress/Predict")
        with pytest.raises(grpc.RpcError) as err:
            call(json.dumps({"input": 1}).encode())
        assert "kapow" in err.value.details()
        chan.close()
        serve.shutdown()

    def test_predict_stream(self, rt):
        grpc = pytest.importorskip("grpc")

        @serve.deployment
        class Tok:
            def __init__(self):
                self.streams = {}

            def start_stream(self, prompt, max_new_tokens=None):
                self.streams["s1"] = list(prompt or "abc")
                return "s1"

            def next_tokens(self, sid):
                toks = self.streams[sid]
                if not toks:
                    return {"tokens": [], "done": True}
                return {"tokens": [toks.pop(0)], "done": not toks}

        serve.run(Tok.bind())
        port = serve.start_grpc()
        chan = grpc.insecure_channel(f"127.0.0.1:{port}")
        call = chan.unary_stream("/ray_tpu.serve.Ingress/PredictStream")
        frames = [json.loads(f) for f in
                  call(json.dumps({"prompt": "xyz"}).encode())]
        toks = [t for fr in frames for t in fr["tokens"]]
        assert toks == ["x", "y", "z"]
        assert frames[-1]["done"]
        chan.close()
        serve.shutdown()


class TestRollingRedeploy:
    """Versioned rolling updates (reference: DeploymentState's versioned
    rolling updates): old-version replicas keep serving mid-redeploy,
    retired replicas drain, the health gate protects the old set."""

    def test_old_version_serves_mid_roll_then_drains_to_zero(self, rt):
        @serve.deployment(num_replicas=3, version="v1")
        class Svc:
            def __call__(self, x):
                return "v1"

        handle = serve.run(Svc.bind())
        assert ray.get(handle.remote(0)) == "v1"

        class SvcV2:
            def __init__(self):
                time.sleep(0.4)  # slow boot stretches the roll

            def __call__(self, x):
                return "v2"

        v2 = serve.deployment(SvcV2, name="Svc", num_replicas=3,
                              version="v2")
        roll = threading.Thread(target=lambda: serve.run(v2.bind()))
        roll.start()
        saw_v1_during_roll = False
        responses = []
        while roll.is_alive():
            responses.append(ray.get(handle.remote(0), timeout=30))
            if roll.is_alive() and "v1" in responses[-1:]:
                saw_v1_during_roll = True
            time.sleep(0.02)
        roll.join()
        # service never went dark, old version answered mid-roll
        assert responses and saw_v1_during_roll
        assert all(r in ("v1", "v2") for r in responses)
        # ...and the old version drained to zero
        st = serve.status()["Svc"]
        assert st["replica_versions"] == ["v2", "v2", "v2"], st
        assert ray.get(handle.remote(0)) == "v2"

    def test_in_flight_request_drains_before_kill(self, rt):
        @serve.deployment(num_replicas=1, version="a")
        class Slow:
            def __call__(self, t):
                time.sleep(t)
                return "done-a"

        handle = serve.run(Slow.bind())
        # park a long request on the old replica...
        fut = handle.remote(1.0)
        time.sleep(0.1)

        class SlowB:
            def __call__(self, t):
                return "done-b"

        b = serve.deployment(SlowB, name="Slow", num_replicas=1,
                             version="b")
        roll = threading.Thread(target=lambda: serve.run(b.bind()))
        roll.start()
        # ...the retired replica must finish it, not die mid-request
        assert ray.get(fut, timeout=30) == "done-a"
        roll.join()
        assert ray.get(handle.remote(0.0)) == "done-b"

    def test_health_gate_aborts_roll_and_old_set_survives(self, rt):
        @serve.deployment(num_replicas=2, version="good")
        class Svc:
            def __call__(self, x):
                return "good"

        handle = serve.run(Svc.bind())

        class Broken:
            def check_health(self):
                raise RuntimeError("not ready")

            def __call__(self, x):
                return "broken"

        bad = serve.deployment(Broken, name="Svc", num_replicas=2,
                               version="bad")
        with pytest.raises(Exception, match="health"):
            serve.run(bad.bind())
        st = serve.status()["Svc"]
        assert st["replica_versions"] == ["good", "good"]
        assert ray.get(handle.remote(0)) == "good"

    def test_same_version_redeploy_only_rescales(self, rt):
        @serve.deployment(num_replicas=1, version="v")
        class Svc:
            def __call__(self, x):
                return "v"

        serve.run(Svc.bind())
        before = serve.status()["Svc"]["replica_versions"]
        serve.run(Svc.options(num_replicas=3).bind())
        st = serve.status()["Svc"]
        assert st["replicas"] == 3
        assert st["replica_versions"] == ["v"] * 3
        assert before == ["v"]


class TestMultiplexedEverySlotMidLoad:
    def test_cap_holds_when_every_slot_is_loading(self):
        """The loader LRU's hardest corner: cap=2 and BOTH slots hold
        in-flight placeholder events when more loads arrive. The late
        loaders wait for a slot instead of inserting a third
        placeholder, loaded models are never double-loaded, and the
        cache never exceeds cap."""
        gate = threading.Event()
        started = []
        loads = []
        lock = threading.Lock()

        class Holder:
            @serve.multiplexed(max_num_models_per_replica=2)
            def get_model(self, model_id):
                with lock:
                    started.append(model_id)
                gate.wait(timeout=30)
                with lock:
                    loads.append(model_id)
                return f"model:{model_id}"

        h = Holder()
        results = {}

        def load(mid):
            results[mid] = h.get_model(mid)

        # two loads occupy BOTH slots mid-load
        t1 = threading.Thread(target=load, args=("a",), daemon=True)
        t2 = threading.Thread(target=load, args=("b",), daemon=True)
        t1.start(), t2.start()
        deadline = time.monotonic() + 10
        while len(started) < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert sorted(started) == ["a", "b"]
        # four MORE arrivals while every slot is mid-load: two new
        # models (must wait, no placeholder) and two duplicates of the
        # in-flight ones (must coalesce, not double-load)
        late = [threading.Thread(target=load, args=(m,), daemon=True)
                for m in ("c", "d", "a", "b")]
        for t in late:
            t.start()
        time.sleep(0.2)
        cache = h.__dict__["_ray_tpu_mux_get_model"]
        assert len(cache) <= 2, dict(cache)
        # nothing new started while the cap was saturated
        assert sorted(started) == ["a", "b"]
        gate.set()
        for t in [t1, t2] + late:
            t.join(timeout=30)
            assert not t.is_alive()
        assert results == {m: f"model:{m}" for m in "abcd"}
        # c and d load once each; a and b at most twice (evicted by c/d
        # before their duplicate waiter re-entered), never more
        assert loads.count("c") == 1 and loads.count("d") == 1, loads
        assert loads.count("a") <= 2 and loads.count("b") <= 2, loads
        assert len(cache) <= 2


# -- the KV-page directory against node death (tests/test_serve_scale.py) --

_KV_PRODUCE_SRC = """
def produce_kv():
    # > the inline threshold: the sole copy stays in the producing
    # node's shm arena; the head holds a placeholder only
    return bytes(range(256)) * 1024
"""


def _load_src(src, name):
    ns: dict = {}
    exec(src, ns)
    return ns[name]


class TestKVDirectoryNodeDeath:
    def test_promotion_then_gone_when_sole_copy_node_dies(self):
        """Directory semantics under replica and node loss, against the
        real object directory of a remote node: a dead replica whose
        handoff bytes survive elsewhere resolves "promoted" (re-import,
        no prefill); when the sole-copy node dies too, the entry
        resolves "gone", drops, and the session stays known — its next
        turn counts as an affinity miss (re-prefill), never as a first
        turn."""
        from ray_tpu_torch import chaos
        from ray_tpu_torch._private import worker as worker_mod
        from ray_tpu_torch.serve import core

        ray.shutdown()
        ray.init(num_workers=2,
                 _system_config={"worker_mode": "process",
                                 "sched_device": "cpu",
                                 "node_heartbeat_timeout_s": 20.0,
                                 "health_check_timeout_s": 5.0})
        w = worker_mod.get_worker()
        ea = w.add_remote_cluster_node(num_cpus=2.0, num_workers=1,
                                       resources={"a": 2})
        try:
            @serve.deployment(num_replicas=2)
            class Stub:  # decode-pool stand-in: directory semantics
                def __call__(self, x):  # don't need a real engine
                    return x

            h = serve.run(Stub.bind())
            st = h._state()
            with st._lock:
                both = list(st._replicas)
            # retire one replica so the recorded holder is GONE
            st._scale_to(1)
            with st._lock:
                live = st._replicas[0]
            retired = next(r for r in both if r is not live)

            producer = ray.remote(_load_src(_KV_PRODUCE_SRC, "produce_kv"))

            @ray.remote(resources={"a": 1.0})
            def make():
                import ray_tpu_torch
                ref = producer.remote()
                ray_tpu_torch.get(ref, timeout=60.0)  # completes ON the node
                return ref

            ref = ray.get(make.remote(), timeout=120.0)
            assert w.gcs.object_locations(ref.object_id())

            core.kv_directory.record("s1", "Stub", retired, ref)
            # holder dead, bytes alive on node a -> promoted (entry
            # retained: any replica can re-import without a prefill)
            status, rep, got_ref = core.kv_directory.lookup("s1", st)
            assert status == "promoted" and rep is None
            assert got_ref is ref
            assert len(core.kv_directory) == 1

            # the sole-copy node dies -> gone; entry drops, seen stays
            ea.pool.simulate_machine_death()
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                if not w.gcs.object_locations(ref.object_id()):
                    break
                time.sleep(0.1)
            status, rep, got_ref = core.kv_directory.lookup("s1", st)
            assert status == "gone" and rep is None and got_ref is None
            assert len(core.kv_directory) == 0
            assert core.kv_directory.known("s1")
            # a live holder still resolves "hit"
            core.kv_directory.record("s2", "Stub", live, None)
            assert core.kv_directory.lookup("s2", st)[0] == "hit"
        finally:
            chaos.disarm()
            serve.shutdown()
            ray.shutdown()
