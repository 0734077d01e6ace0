"""The port's raylint: every case of ``tests/test_analysis.py`` on
``ray_tpu_torch``, held to the reference's passes, plus the port's own
checks of its tables and its runtime mirror.

Parity: each fixture tree is written twice, once as the reference's case
writes it (under ``ref/``) and once in the port's spelling (under
``port/``); the reference's pass reads the first, the port's pass the
second, and the two lists of finding keys must be equal, in order. Then
the case's own assertions run on the port's keys. The port's spelling
differs only where a fixture names the package: ``ray_tpu.get``,
``@ray_tpu.remote`` and ``import ray_tpu`` become ``ray_tpu_torch`` (in
a README ``ray\\_tpu\\_torch``, as the repo's README escapes it), and an
environment spelling ``RAY_TPU_<NAME>`` becomes ``RAY_TPU_TORCH_<NAME>``
(``_port_spelling``). Metric names keep their
``ray_tpu_`` prefix: the port emits the reference's names.

The real tree: the whole-tree gate over ``ray_tpu_torch/`` (zero new
findings, zero stale suppressions) runs the eight passes once for the
module (``port_report``); the CLI's ``lint --json`` runs them once more in
a subprocess. The port's own checks: every anchor of its channel and
frame-field tables resolves to a function that still has the sends or
reads it names (a stale anchor makes the pass report nothing); the wire
schema the sanitizer compiles from the table against the table that was
kept by hand before it; the sanitizer's default lock graph is the static
pass's; every ``wrap_lock`` id names a lock the static pass knows.

The runtime mirrors (``runtime_checks``, ``runtime_sanitizer``) and the
regression cases of the violations raylint surfaced run on the port's
modules.
"""

import ast
import gc
import json
import os
import re
import subprocess
import sys
import textwrap
import threading
from types import SimpleNamespace

import pytest

from ray_tpu._private import analysis as ref_analysis
from ray_tpu._private.analysis import blocking_calls as ref_blocking_calls
from ray_tpu._private.analysis import closure_capture as ref_closure_capture
from ray_tpu._private.analysis import knobs as ref_knobs
from ray_tpu._private.analysis import lock_order as ref_lock_order
from ray_tpu._private.analysis import ref_lifecycle as ref_ref_lifecycle
from ray_tpu._private.analysis import registry as ref_registry
from ray_tpu._private.analysis import shared_state as ref_shared_state
from ray_tpu._private.analysis import wire_protocol as ref_wire_protocol
from ray_tpu_torch._private import analysis
from ray_tpu_torch._private.analysis import (blocking_calls, closure_capture,
                                             knobs, lock_order, ref_lifecycle,
                                             registry, runtime_checks,
                                             runtime_sanitizer, shared_state,
                                             wire_protocol)
from ray_tpu_torch._private.analysis._astutil import (collect_classes,
                                                      collect_module_locks,
                                                      find_function,
                                                      iter_py_files,
                                                      module_name,
                                                      parse_file)

REF = SimpleNamespace(
    analysis=ref_analysis, lock_order=ref_lock_order,
    shared_state=ref_shared_state, wire_protocol=ref_wire_protocol,
    knobs=ref_knobs, registry=ref_registry, ref_lifecycle=ref_ref_lifecycle,
    closure_capture=ref_closure_capture, blocking_calls=ref_blocking_calls)
PORT = SimpleNamespace(
    analysis=analysis, lock_order=lock_order, shared_state=shared_state,
    wire_protocol=wire_protocol, knobs=knobs, registry=registry,
    ref_lifecycle=ref_lifecycle, closure_capture=closure_capture,
    blocking_calls=blocking_calls)


def _mk(key, message, file, line):
    return SimpleNamespace(key=key, message=message, file=file, line=line)


def _write(root, relpath, source):
    path = root / relpath
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return path


def _keys(findings):
    return [f.key for f in findings]


def _port_spelling(text, markdown=False):
    """The reference fixture as the port spells it: the package's name
    and its environment prefix (metric names keep ``ray_tpu_``). In
    markdown the name is written with escaped underscores, as the repo's
    README writes it: the registry pass reads every ``ray_tpu_`` token
    there as a metric name."""
    name = r"ray\\_tpu\\_torch" if markdown else "ray_tpu_torch"
    text = re.sub(r"\bray_tpu\b", name, text)
    return re.sub(r"\bRAY_TPU_(?!TORCH_)", "RAY_TPU_TORCH_", text)


def _parity(tmp_path, files, run):
    """Write ``files`` (relpath -> source, the reference's spelling)
    under ``ref/`` and, in the port's spelling, under ``port/``; ``run(m,
    root)`` runs the case with the pass modules ``m`` (REF or PORT) over
    ``root``. Asserts the two key lists are equal and returns the port's."""
    keys = {}
    for side, m in (("ref", REF), ("port", PORT)):
        root = tmp_path / side
        for rel, src in files.items():
            _write(root, rel, src if side == "ref" else _port_spelling(
                textwrap.dedent(src), markdown=rel.endswith(".md")))
        keys[side] = _keys(run(m, root))
    assert keys["port"] == keys["ref"], keys
    return keys["port"]


def _one(pass_name, files, tmp_path, **kw):
    """Parity of one pass's ``analyze(root, _mk, **kw)`` over ``files``."""
    return _parity(tmp_path, files, lambda m, root: getattr(
        m, pass_name).analyze(str(root), _mk, **kw))


@pytest.fixture(scope="module")
def port_report():
    """The eight passes over ray_tpu_torch/ against its baseline, once."""
    return analysis.run_all()


# ---------------------------------------------------------------------------
# lock_order
# ---------------------------------------------------------------------------

class TestLockOrder:
    def test_cycle_detected(self, tmp_path):
        keys = _one("lock_order", {"mod.py": """
            import threading

            class C:
                def __init__(self):
                    self._lock_a = threading.Lock()
                    self._lock_b = threading.Lock()

                def m1(self):
                    with self._lock_a:
                        with self._lock_b:
                            pass

                def m2(self):
                    with self._lock_b:
                        with self._lock_a:
                            pass
            """}, tmp_path)
        assert any(k.startswith("lock_order:cycle:") for k in keys), keys

    def test_consistent_nesting_passes(self, tmp_path):
        keys = _one("lock_order", {"mod.py": """
            import threading

            class C:
                def __init__(self):
                    self._lock_a = threading.Lock()
                    self._lock_b = threading.Lock()

                def m1(self):
                    with self._lock_a:
                        with self._lock_b:
                            pass

                def m2(self):
                    with self._lock_a:
                        with self._lock_b:
                            pass
            """}, tmp_path)
        assert keys == []

    def test_nonreentrant_reacquire_detected(self, tmp_path):
        keys = _one("lock_order", {"mod.py": """
            import threading

            class C:
                def __init__(self):
                    self._lock = threading.Lock()

                def outer(self):
                    with self._lock:
                        with self._lock:
                            pass
            """}, tmp_path)
        assert any(k.startswith("lock_order:reacquire:") for k in keys), keys

    def test_rlock_reacquire_is_fine(self, tmp_path):
        keys = _one("lock_order", {"mod.py": """
            import threading

            class C:
                def __init__(self):
                    self._lock = threading.RLock()

                def outer(self):
                    with self._lock:
                        with self._lock:
                            pass
            """}, tmp_path)
        assert keys == []

    def test_reacquire_via_self_call_detected(self, tmp_path):
        keys = _one("lock_order", {"mod.py": """
            import threading

            class C:
                def __init__(self):
                    self._lock = threading.Lock()

                def outer(self):
                    with self._lock:
                        self.helper()

                def helper(self):
                    with self._lock:
                        pass
            """}, tmp_path)
        assert any(k.startswith("lock_order:reacquire-via-call:")
                   for k in keys), keys


# ---------------------------------------------------------------------------
# shared_state
# ---------------------------------------------------------------------------

class TestSharedState:
    def test_mixed_guard_detected(self, tmp_path):
        keys = _one("shared_state", {"mod.py": """
            import threading

            class C:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._items = []
                    threading.Thread(target=self._run).start()

                def _run(self):
                    with self._lock:
                        self._items.append(1)

                def poke(self):
                    self._items.append(2)
            """}, tmp_path)
        assert "shared_state:mixed-guard:mod.C._items" in keys, keys

    def test_guarded_everywhere_passes(self, tmp_path):
        keys = _one("shared_state", {"mod.py": """
            import threading

            class C:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._items = []
                    threading.Thread(target=self._run).start()

                def _run(self):
                    with self._lock:
                        self._items.append(1)

                def poke(self):
                    with self._lock:
                        self._items.append(2)
            """}, tmp_path)
        assert keys == []

    def test_locked_suffix_convention_passes(self, tmp_path):
        # *_locked methods assert a caller-holds-lock contract; they
        # count as guarded, not as an unguarded mutation site.
        keys = _one("shared_state", {"mod.py": """
            import threading

            class C:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._items = []
                    threading.Thread(target=self._run).start()

                def _run(self):
                    with self._lock:
                        self._append_locked()

                def _append_locked(self):
                    self._items.append(1)
            """}, tmp_path)
        assert keys == []

    def test_unguarded_rmw_detected(self, tmp_path):
        keys = _one("shared_state", {"mod.py": """
            import threading

            class C:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.n = 0
                    threading.Thread(target=self._run).start()

                def _run(self):
                    self.n += 1

                def bump(self):
                    self.n += 1
            """}, tmp_path)
        assert "shared_state:unguarded-rmw:mod.C.n" in keys, keys

    def test_non_threaded_class_exempt(self, tmp_path):
        # no thread spawn -> no cross-thread hazard -> no findings
        keys = _one("shared_state", {"mod.py": """
            class C:
                def __init__(self):
                    self.n = 0

                def a(self):
                    self.n += 1

                def b(self):
                    self.n += 1
            """}, tmp_path)
        assert keys == []


# ---------------------------------------------------------------------------
# wire_protocol
# ---------------------------------------------------------------------------

def _wire(tmp_path, files, channels=(), op_channels=(), frame_fields=None):
    """Parity of the wire pass. ``channels`` etc. are functions of the
    pass module ``w`` building its spec objects."""
    def run(m, root):
        w = m.wire_protocol
        kw = {}
        if frame_fields is not None:
            kw["frame_fields"] = [f(w) for f in frame_fields]
        return w.analyze(str(root), _mk,
                         channels=[c(w) for c in channels],
                         op_channels=[c(w) for c in op_channels], **kw)
    return _parity(tmp_path, files, run)


def _channel(name, sends, recvs, **kw):
    """A ChannelSpec of the given module: ``sends``/``recvs`` are
    (file, callee)/(file, func) pairs."""
    return lambda w: w.ChannelSpec(
        name=name, sends=[w.SendSpec(f, c) for f, c in sends],
        recvs=[w.RecvSpec(f, fn) for f, fn in recvs], **kw)


_WIRE_FIXTURE = {
    "sender.py": """
        def go(conn):
            conn.send(("ok", 1))
            conn.send(("drift", 2))
            conn.send(("orphan",))
        """,
    "recv.py": """
        def handle(msg):
            kind = msg[0]
            if kind == "ok":
                return msg[1]
            elif kind == "drift":
                return msg[2]
            elif kind == "ghost":
                return None
            return None
        """,
}
_WIRE_CHANNEL = _channel("t", [("sender.py", "send")],
                         [("recv.py", "handle")])


class TestWireProtocol:
    def test_tag_arity_drift_caught(self, tmp_path):
        keys = _wire(tmp_path, _WIRE_FIXTURE, [_WIRE_CHANNEL])
        assert any(k.startswith("wire:arity:") and "drift" in k
                   for k in keys), keys

    def test_sent_unhandled_and_handled_unsent(self, tmp_path):
        keys = _wire(tmp_path, _WIRE_FIXTURE, [_WIRE_CHANNEL])
        assert any(k.startswith("wire:sent-unhandled:") and "orphan" in k
                   for k in keys), keys
        assert any(k.startswith("wire:handled-unsent:") and "ghost" in k
                   for k in keys), keys
        # the well-formed tag raises nothing
        assert not any("ok" in k.split(":")[-1] for k in keys), keys

    def test_op_channel_drift(self, tmp_path):
        files = {
            "client.py": """
                class Cli:
                    def put(self, a, b):
                        return self._rpc("put", a, b)

                    def nope(self):
                        return self._rpc("nope")
                """,
            "server.py": """
                class Srv:
                    def _op_put(self, session, a):
                        return a

                    def _op_extra(self, session):
                        return None
                """,
        }
        och = [lambda w: w.OpChannelSpec(
            name="oc", client_file="client.py", rpc_callees=("_rpc",),
            server_file="server.py", server_class="Srv")]
        keys = _wire(tmp_path, files, op_channels=och)
        assert any("op-arity" in k and "put" in k for k in keys), keys
        assert any("op-undefined" in k and "nope" in k for k in keys), keys
        assert any("op-unsent" in k and "extra" in k for k in keys), keys

    def test_trace_extension_drift_caught(self, tmp_path):
        """A trace field added as new framed tuples on one side only:
        arity drift on the extended tag, and a tag with no branch."""
        files = {
            "sender.py": """
                def go(conn):
                    conn.send(("trace_span", "tid", "sid", "psid"))
                    conn.send(("trace_mark", "tid"))
                """,
            "recv.py": """
                def handle(msg):
                    kind = msg[0]
                    if kind == "trace_span":
                        # expects a 5th element the sender never ships
                        return msg[4]
                    return None
                """,
        }
        keys = _wire(tmp_path, files, [_channel(
            "trace", [("sender.py", "send")], [("recv.py", "handle")])])
        assert any(k.startswith("wire:arity:") and "trace_span" in k
                   for k in keys), keys
        assert any(k.startswith("wire:sent-unhandled:")
                   and "trace_mark" in k for k in keys), keys

    def test_ring_schema_drift_caught(self, tmp_path):
        """The control ring's envelopes through the ring callees: a tag
        with no branch, and a completion branch indexing past the
        sender's tuple."""
        files = {
            "owner.py": """
                def pump(self, h):
                    self._ring_send(("env", b"blob"), h)
                    self._ring_send(("env2", b"blob"), h)
                """,
            "wrk.py": """
                def flush(self):
                    self._ring_emit(("cenv", b"blob"))
                """,
            "recv_o.py": """
                def handle_ring(msg):
                    kind = msg[0]
                    if kind == "env":
                        return msg[1]
                    return None
                """,
            "recv_w.py": """
                def handle_comp(msg):
                    kind = msg[0]
                    if kind == "cenv":
                        return msg[2]
                    return None
                """,
        }
        keys = _wire(tmp_path, files, [
            _channel("o2w_ring", [("owner.py", "_ring_send")],
                     [("recv_o.py", "handle_ring")]),
            _channel("w2o_ring", [("wrk.py", "_ring_emit")],
                     [("recv_w.py", "handle_comp")])])
        assert any(k.startswith("wire:sent-unhandled:") and "env2" in k
                   for k in keys), keys
        assert any(k.startswith("wire:arity:") and "cenv" in k
                   for k in keys), keys
        # the conformant env tag raises nothing
        assert not any(k.split(":")[-1] == "env" for k in keys), keys

    def test_profile_channel_drift_caught(self, tmp_path):
        """The profile plane's ("prof", payload) and ("util", payload)
        frames: a branch expecting an element the sampler never ships,
        and a tag with no branch at the head."""
        files = {
            "wkr.py": """
                def ship(conn, payload):
                    conn.send(("prof", payload))
                """,
            "recv_prof.py": """
                def handle(msg):
                    kind = msg[0]
                    if kind == "prof":
                        # expects a node index the worker never ships
                        return msg[2]
                    return None
                """,
            "daemon.py": """
                def ship_util(self, payload):
                    self._send_head(("util", payload))
                """,
            "recv_util.py": """
                def dispatch(msg):
                    kind = msg[0]
                    if kind == "clock":
                        return msg[1]
                    return None
                """,
        }
        keys = _wire(tmp_path, files, [
            _channel("w2o_prof", [("wkr.py", "send")],
                     [("recv_prof.py", "handle")]),
            _channel("d2h_util", [("daemon.py", "_send_head")],
                     [("recv_util.py", "dispatch")])])
        assert any(k.startswith("wire:arity:") and "prof" in k
                   for k in keys), keys
        assert any(k.startswith("wire:sent-unhandled:") and "util" in k
                   for k in keys), keys

    def test_peer_actor_lane_drift_caught(self, tmp_path):
        """The peer actor lane and the daemon's local-dispatch reports:
        an acall branch expecting a field the caller never ships, and two
        tags sent with no branch."""
        files = {
            "caller.py": """
                def ship(self, lane, env):
                    self._lane_send(("acall", env), lane)
                    self._lane_send(("acancel", b"tid"), lane)
                """,
            "exec_side.py": """
                def serve(conn):
                    msg = conn.recv()
                    kind = msg[0]
                    if kind == "acall":
                        # expects a priority field the caller never ships
                        return msg[2]
                    return None
                """,
            "daemon.py": """
                def report(self, tid, info):
                    self._send_head(("local_lease", tid, info))
                    self._send_head(("p2p_done", tid, info, "extra"))
                """,
            "head.py": """
                def dispatch(msg):
                    kind = msg[0]
                    if kind == "p2p_done":
                        return msg[2]
                    return None
                """,
        }
        keys = _wire(tmp_path, files, [
            _channel("peer_lane", [("caller.py", "_lane_send")],
                     [("exec_side.py", "serve")]),
            _channel("d2h_two_level", [("daemon.py", "_send_head")],
                     [("head.py", "dispatch")])])
        assert any(k.startswith("wire:arity:") and "acall" in k
                   for k in keys), keys
        assert any(k.startswith("wire:sent-unhandled:")
                   and "acancel" in k for k in keys), keys
        assert any(k.startswith("wire:sent-unhandled:")
                   and "local_lease" in k for k in keys), keys
        # the conformant p2p_done tag raises nothing
        assert not any(k.split(":")[-1] == "p2p_done" for k in keys), keys

    def test_gossip_and_remote_envelope_drift_caught(self, tmp_path):
        """Gossip, the local-retry report and the remote lease envelope:
        a gossip branch past the sender's tuple, a report with no head
        branch, and a relay unpacking a shape no sender produces."""
        files = {
            "gossiper.py": """
                def tick(self, lane, view):
                    self._lane_send(("rview", view), lane)
                """,
            "peer.py": """
                def serve(conn):
                    msg = conn.recv()
                    kind = msg[0]
                    if kind == "rview":
                        # expects a delta list the gossiper never ships
                        return msg[2]
                    return None
                """,
            "daemon.py": """
                def retry(self, tid, info):
                    self._send_head(("local_retry", tid, info))
                """,
            "head.py": """
                def dispatch(msg):
                    kind = msg[0]
                    if kind == "local_lease":
                        return msg[1]
                    return None
                """,
            "pool.py": """
                def pump(self, h):
                    self._ring_send(("env", b"blob"), h)
                """,
            "relay.py": """
                def bookkeep(msg):
                    kind = msg[0]
                    if kind == "env":
                        tag, blob, extra = msg
                        return extra
                    return None
                """,
        }
        keys = _wire(tmp_path, files, [
            _channel("gossip", [("gossiper.py", "_lane_send")],
                     [("peer.py", "serve")]),
            _channel("d2h_retry", [("daemon.py", "_send_head")],
                     [("head.py", "dispatch")],
                     assume_sent={"local_lease"}),
            _channel("remote_env", [("pool.py", "_ring_send")],
                     [("relay.py", "bookkeep")])])
        assert any(k.startswith("wire:arity:") and "rview" in k
                   for k in keys), keys
        assert any(k.startswith("wire:sent-unhandled:")
                   and "local_retry" in k for k in keys), keys
        assert any(k.startswith("wire:arity:") and "env" in k
                   and "unpack3" in k for k in keys), keys

    def test_node_death_frame_drift_caught(self, tmp_path):
        """The death broadcast and the rejoin fence on head_to_daemon: a
        fence branch expecting a field the head never ships, and a
        broadcast with no branch."""
        files = {
            "head.py": """
                def declare_dead(self, index, peer, epoch):
                    self._send_daemon(("node_dead", {"index": index,
                                                     "peer": peer}))
                    self._send_daemon(("fence", epoch))
                """,
            "daemon.py": """
                def run_one(msg):
                    kind = msg[0]
                    if kind == "fence":
                        # expects a generation the head never ships
                        return msg[2]
                    return None
                """,
        }
        keys = _wire(tmp_path, files, [_channel(
            "h2d_death", [("head.py", "_send_daemon")],
            [("daemon.py", "run_one")])])
        assert any(k.startswith("wire:arity:") and "fence" in k
                   for k in keys), keys
        assert any(k.startswith("wire:sent-unhandled:")
                   and "node_dead" in k for k in keys), keys

    def test_resview_watermark_field_drift_caught(self, tmp_path):
        """The resview frame's dict fields, both directions of drift:
        a consumer reads a key no producer writes, producers ship keys
        nothing reads; then the fixed consumer is clean."""
        files = {
            "head.py": """
                def push_loop(self):
                    for p in self.pools():
                        view = {"accept": True, "cap": 8, "job": b"j",
                                "deadline": 0.5}
                        if self.qos_plane is not None:
                            view["watermark"] = self.qos_plane.top()
                        p.send_resview(view)
                """,
            "daemon.py": """
                def admit(self, view, d):
                    # reads the RENAMED key the producer no longer writes
                    wm = view.get("wm")
                    if wm is not None and d.get("priority", 0) < wm:
                        return "spill"
                    if not view.get("accept") or view.get("cap") is None:
                        return "spill"
                    return view["job"]
                """,
        }
        tables = [lambda w: w.FrameFieldSpec(
            name="resview_fixture",
            producers=[w.FrameVarSpec("head.py", "push_loop", "view")],
            consumers=[w.FrameVarSpec("daemon.py", "admit", "view")])]
        keys = _wire(tmp_path, files, frame_fields=tables)
        assert "wire:field-unproduced:resview_fixture:wm" in keys, keys
        assert ("wire:field-unread:resview_fixture:deadline"
                in keys), keys
        assert ("wire:field-unread:resview_fixture:watermark"
                in keys), keys
        # the healthy rows (accept/cap/job) raise nothing
        assert not any(k.endswith(":accept") or k.endswith(":cap")
                       or k.endswith(":job") for k in keys), keys
        # fix the drift (consumer reads the shipped names) -> clean
        files["daemon.py"] = """
            def admit(self, view, d):
                wm = view.get("watermark")
                if wm is not None and d.get("priority", 0) < wm:
                    return "spill"
                if not view.get("accept") or view.get("cap") is None:
                    return "spill"
                if view.get("deadline"):
                    return "spill"
                return view["job"]
            """
        keys = _wire(tmp_path, files, frame_fields=tables)
        assert keys == [], keys

    def test_real_channels_have_no_drift(self, port_report):
        # the port's remote_pool <-> node_daemon (and the other channels)
        # agree on tags and arities
        tuple_drift = [f.key for f in port_report.findings
                       if f.pass_id == "wire_protocol"
                       and not f.key.startswith("wire:op-")]
        assert tuple_drift == [], tuple_drift


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

def _knobs(tmp_path, files, readme_text, readme="README.md"):
    """Parity of the knob pass over a ``pkg/`` tree and a README."""
    files = dict(files)
    files[readme] = readme_text
    return _parity(tmp_path, files, lambda m, root: m.knobs.analyze(
        str(root / "pkg"), _mk, readme_path=str(root / readme)))


class TestKnobs:
    FILES = {
        "pkg/_private/config.py": """
            GLOBAL_CONFIG.define("used_knob", int, 1, "read and documented")
            GLOBAL_CONFIG.define("dead_knob", int, 2, "documented, never read")
            GLOBAL_CONFIG.define("hidden_knob", int, 3, "read, undocumented")
            """,
        "pkg/app.py": """
            from config import GLOBAL_CONFIG
            def f():
                return GLOBAL_CONFIG.used_knob + GLOBAL_CONFIG.hidden_knob
            """,
    }
    README = "Knobs: `used_knob`, `dead_knob`.\n"

    def test_dead_knob_caught(self, tmp_path):
        keys = _knobs(tmp_path, self.FILES, self.README)
        assert "knob:dead:dead_knob" in keys, keys
        assert not any("used_knob" in k for k in keys), keys

    def test_undocumented_knob_caught(self, tmp_path):
        keys = _knobs(tmp_path, self.FILES, self.README)
        assert "knob:undocumented:hidden_knob" in keys, keys

    def test_bad_name_caught(self, tmp_path):
        keys = _knobs(tmp_path, {"pkg/_private/config.py": """
            GLOBAL_CONFIG.define("BadName", int, 1, "not lowercase")
            """}, "`BadName`\n")
        assert "knob:bad-name:BadName" in keys, keys


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY_FILES = {
    "pkg/client.py": """
        _STATE_VERBS = ("alpha", "ghost")
        """,
    "pkg/util/state.py": """
        def _client_dispatch(fn):
            return fn

        @_client_dispatch
        def alpha():
            pass

        @_client_dispatch
        def beta():
            pass
        """,
    "pkg/_private/metrics.py": """
        def emit(name, value):
            pass

        def export():
            emit("ray_tpu_test_documented", 1)
            emit("ray_tpu_test_secret", 2)
        """,
    "README.md": "Exports `ray_tpu_test_documented` and "
                 "`ray_tpu_test_phantom`.\n",
}


def _registry(tmp_path, extra=None, readme="README.md"):
    files = dict(_REGISTRY_FILES, **(extra or {}))
    return _parity(tmp_path, files, lambda m, root: m.registry.analyze(
        str(root / "pkg"), _mk, client_relpath="client.py",
        state_relpath="util/state.py",
        metrics_relpaths=("_private/metrics.py",),
        readme_path=str(root / readme)))


_CHAOS_README = (
    "### Chaos engineering\n\n"
    "Sites: `task` (exception/hang), `phantom_site` (drop).\n"
    "Also mentions `ray_tpu.chaos` (the module) which is not "
    "a site.\n\n## Next section\n`secret_site` (out of the "
    "chaos section, must not count)\n")


class TestRegistry:
    def test_verb_drift_caught_both_ways(self, tmp_path):
        keys = _registry(tmp_path)
        assert "registry:verb-unlisted:beta" in keys, keys
        assert "registry:verb-undefined:ghost" in keys, keys
        assert not any("alpha" in k for k in keys), keys

    def test_metric_drift_caught_both_ways(self, tmp_path):
        keys = _registry(tmp_path)
        assert ("registry:metric-undocumented:ray_tpu_test_secret"
                in keys), keys
        assert any(k.startswith("registry:metric-phantom:")
                   and "phantom" in k for k in keys), keys
        assert not any(k.endswith(":ray_tpu_test_documented")
                       for k in keys), keys

    def test_chaos_site_drift_caught_both_ways(self, tmp_path):
        keys = _registry(tmp_path, {
            "pkg/_private/chaos.py": """
                _SITE_KINDS = {
                    "task": ("exception", "hang"),
                    "secret_site": ("kill",),
                }
                """,
            "README2.md": _CHAOS_README}, readme="README2.md")
        assert "registry:chaos-site-undocumented:secret_site" in keys, keys
        assert "registry:chaos-site-phantom:phantom_site" in keys, keys
        assert not any(k.endswith(":task") for k in keys), keys

    def test_chaos_site_annassign_table_is_collected(self, tmp_path):
        """The chaos registry declared with a type annotation is still
        read: an undocumented site surfaces, the documented ones pass."""
        keys = _registry(tmp_path, {
            "pkg/_private/chaos.py": """
                from typing import Dict, Tuple

                _SITE_KINDS: Dict[str, Tuple[str, ...]] = {
                    "task": ("exception", "hang"),
                    "node": ("kill", "restart", "flap"),
                    "secret_site": ("kill",),
                }
                """,
            "README3.md": (
                "### Chaos engineering\n\n"
                "Sites: `task` (exception/hang), `node` (kill/restart/"
                "flap: machine-death SIGKILL of a node's daemon and "
                "worker tree).\n\n## Next section\n")}, readme="README3.md")
        assert "registry:chaos-site-undocumented:secret_site" in keys, keys
        assert not any(k.endswith(":node") or k.endswith(":task")
                       for k in keys), keys


# ---------------------------------------------------------------------------
# baseline semantics + the tier-1 gate
# ---------------------------------------------------------------------------

_DEAD_KNOB = {"pkg/_private/config.py": """
    GLOBAL_CONFIG.define("dead_knob", int, 2, "never read")
    """, "README.md": "`dead_knob`\n"}


def _baseline_run(tmp_path, suppress):
    """Parity of run_all (the knob pass alone) over the dead-knob tree
    with a baseline of ``suppress`` (None: no baseline file); returns
    the port's report."""
    reports = []

    def run(m, root):
        bl = str(root / "baseline.json")
        if suppress is not None:
            m.analysis.save_baseline(suppress, path=bl)
        reports.append(m.analysis.run_all(
            root=str(root / "pkg"), baseline_path=bl,
            passes=(("knobs", m.knobs.analyze),)))
        return reports[-1].new + reports[-1].baselined

    _parity(tmp_path, _DEAD_KNOB, run)
    ref, port = reports
    assert (port.ok, _keys(port.new), _keys(port.baselined),
            port.stale_suppressions) == (
        ref.ok, _keys(ref.new), _keys(ref.baselined),
        ref.stale_suppressions)
    return port


class TestBaseline:
    def test_new_finding_fails_gate(self, tmp_path):
        report = _baseline_run(tmp_path, None)
        assert not report.ok
        assert _keys(report.new) == ["knob:dead:dead_knob"]

    def test_baselined_finding_suppressed(self, tmp_path):
        report = _baseline_run(tmp_path, ["knob:dead:dead_knob"])
        assert report.ok
        assert _keys(report.baselined) == ["knob:dead:dead_knob"]
        assert report.stale_suppressions == []

    def test_stale_suppression_reported(self, tmp_path):
        report = _baseline_run(tmp_path, ["knob:dead:dead_knob",
                                          "knob:dead:long_gone"])
        assert report.ok  # stale entries warn, they don't fail the gate
        assert report.stale_suppressions == ["knob:dead:long_gone"]


class TestRepoGate:
    def test_whole_repo_zero_new_findings(self, port_report):
        """The gate: the eight passes over ray_tpu_torch/ report nothing
        beyond its baseline, and no suppression is stale."""
        assert analysis.PACKAGE_ROOT == os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(analysis.__file__))))
        assert os.path.basename(analysis.PACKAGE_ROOT) == "ray_tpu_torch"
        assert port_report.ok, "\n" + port_report.render_text()
        assert port_report.stale_suppressions == [], \
            port_report.stale_suppressions
        assert [p for p, _ in analysis.PASSES] == [
            p for p, _ in ref_analysis.PASSES]
        assert sum(port_report.durations.values()) < 20.0, \
            port_report.durations

    def test_cli_json(self):
        proc = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch", "lint", "--json"],
            capture_output=True, text=True, timeout=120,
            cwd=os.path.dirname(analysis.PACKAGE_ROOT))
        assert proc.returncode == 0, proc.stdout + proc.stderr
        data = json.loads(proc.stdout)
        assert data["ok"] is True
        assert set(data["durations_s"]) == {p for p, _ in analysis.PASSES}
        assert len(data["durations_s"]) == 8
        assert data["stale_suppressions"] == []
        assert data["new"] == []


# ---------------------------------------------------------------------------
# runtime mirror: assert_holds
# ---------------------------------------------------------------------------

class TestRuntimeChecks:
    def test_noop_when_disabled(self, monkeypatch):
        monkeypatch.setattr(runtime_checks, "_ENABLED", False)
        runtime_checks.assert_holds(threading.Lock())  # unheld: no raise
        assert not runtime_checks.enabled()

    @pytest.mark.parametrize("factory", [threading.Lock, threading.RLock,
                                         threading.Condition])
    def test_raises_when_not_held(self, monkeypatch, factory):
        monkeypatch.setattr(runtime_checks, "_ENABLED", True)
        lock = factory()
        with pytest.raises(runtime_checks.LockNotHeldError):
            runtime_checks.assert_holds(lock, "fixture")

    @pytest.mark.parametrize("factory", [threading.Lock, threading.RLock,
                                         threading.Condition])
    def test_passes_when_held(self, monkeypatch, factory):
        monkeypatch.setattr(runtime_checks, "_ENABLED", True)
        lock = factory()
        with lock:
            runtime_checks.assert_holds(lock, "fixture")

    def test_probe_does_not_leak_the_lock(self, monkeypatch):
        # the plain-Lock probe acquires to test; a failed assert must
        # release it again or the assert itself would deadlock the app
        monkeypatch.setattr(runtime_checks, "_ENABLED", True)
        lock = threading.Lock()
        with pytest.raises(runtime_checks.LockNotHeldError):
            runtime_checks.assert_holds(lock)
        assert lock.acquire(blocking=False)
        lock.release()


# ---------------------------------------------------------------------------
# regression cases for the violations raylint surfaced, on the port
# ---------------------------------------------------------------------------

class TestFixedViolations:
    def test_health_check_knobs_are_live(self):
        """health_check_period_s drives the GCS's probe period; an
        explicit interval wins."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        from ray_tpu_torch._private.gcs import GcsService

        ent = GLOBAL_CONFIG.entry("health_check_period_s")
        old = ent.value
        ent.value = 0.05
        gcs = GcsService(worker=None)
        try:
            gcs.start_health_checks()
            assert gcs.health_check_interval == 0.05
        finally:
            gcs._shutdown = True
            ent.value = old

        gcs2 = GcsService(worker=None)
        try:
            gcs2.start_health_checks(interval=0.03)  # explicit arg wins
            assert gcs2.health_check_interval == 0.03
        finally:
            gcs2._shutdown = True

    def test_actor_max_restarts_knob_is_live(self):
        """actor_max_restarts is what an actor without its own option
        gets."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        from ray_tpu_torch.actor import (_ACTOR_OPTIONS,
                                         _effective_max_restarts)

        assert _ACTOR_OPTIONS["max_restarts"] is None  # = defer to knob
        ent = GLOBAL_CONFIG.entry("actor_max_restarts")
        old = ent.value
        try:
            ent.value = 7
            assert _effective_max_restarts({"max_restarts": None}) == 7
            assert _effective_max_restarts({}) == 7
            assert _effective_max_restarts({"max_restarts": 2}) == 2
            assert _effective_max_restarts({"max_restarts": 0}) == 0
        finally:
            ent.value = old

    def test_note_transfer_is_exact_under_threads(self):
        """note_transfer serializes the transfer counters' updates."""
        from ray_tpu_torch._private.worker import Worker

        dummy = SimpleNamespace(transfer_stats={},
                                _transfer_stats_lock=threading.Lock())
        threads = [threading.Thread(
            target=lambda: [Worker.note_transfer(dummy, "k")
                            for _ in range(500)]) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert dummy.transfer_stats["k"] == 8 * 500

    def test_completion_claim_is_single_shot(self):
        """_take_inflight claims a task once; the racing path gets None."""
        from ray_tpu_torch._private.runtime.process_pool import (
            ProcessWorkerPool)

        h = SimpleNamespace(inflight={"t1": "INF"})
        pool = SimpleNamespace(_lock=threading.Lock(),
                               _by_task={"t1": h})
        assert ProcessWorkerPool._take_inflight(pool, h, "t1") == "INF"
        assert pool._by_task == {}
        assert ProcessWorkerPool._take_inflight(pool, h, "t1") is None

    def test_spill_threshold_knob_is_live(self, tmp_path):
        """object_spill_threshold is hysteresis: a full arena spills down
        to the threshold fraction, not just what one allocation needs."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        from ray_tpu_torch._private.ids import ObjectID
        from ray_tpu_torch._private.runtime.shm_store import ShmObjectStore

        ent = GLOBAL_CONFIG.entry("object_spill_threshold")
        old = ent.value
        ent.value = 0.5
        try:
            cap = 1 << 16
            store = ShmObjectStore(cap, spill_dir=str(tmp_path))
            try:
                chunk = 8192
                for i in range(cap // chunk):  # fill the arena
                    store.create(ObjectID.from_random(), chunk)
                    # seal by hand: only sealed, never-accessed objects
                    # are evictable
                    for oid, alloc in store._table.items():
                        alloc.sealed = True
                store.create(ObjectID.from_random(), chunk)  # forces spill
                assert store.num_spilled >= 2
                assert store.arena.free_bytes() >= cap // 4
            finally:
                store.shutdown()
        finally:
            ent.value = old

    def test_alias_knob_flows_into_inline_max(self):
        """max_direct_call_object_size is the reference API's alias of
        inline_object_max_bytes."""
        import ray_tpu_torch
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(num_workers=2, ignore_reinit_error=True,
                           _system_config={
                               "sched_device": "cpu",
                               "max_direct_call_object_size": 55555})
        try:
            assert GLOBAL_CONFIG.inline_object_max_bytes == 55555
        finally:
            ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# ref_lifecycle
# ---------------------------------------------------------------------------

class TestRefLifecycle:
    def test_weak_escape_via_return(self, tmp_path):
        keys = _one("ref_lifecycle", {"mod.py": """
            def leak(oid):
                ref = ObjectRef(oid, None, _register=False)
                return ref
            """}, tmp_path)
        assert "ref_lifecycle:weak-escape:mod.leak:ref" in keys, keys

    def test_weak_escape_via_self_store(self, tmp_path):
        keys = _one("ref_lifecycle", {"mod.py": """
            class C:
                def stash(self, oid):
                    ref = ObjectRef(oid, None, _register=False)
                    self._kept = ref
            """}, tmp_path)
        assert "ref_lifecycle:weak-escape:mod.C.stash:ref" in keys, keys

    def test_weak_escape_via_container(self, tmp_path):
        keys = _one("ref_lifecycle", {"mod.py": """
            def leak_all(oids):
                out = []
                for o in oids:
                    r = ObjectRef(o, None, _register=False)
                    out.append(r)
                return out
            """}, tmp_path)
        assert any(k.startswith("ref_lifecycle:weak-escape:mod.leak_all")
                   for k in keys), keys

    def test_reregistration_exempts(self, tmp_path):
        keys = _one("ref_lifecycle", {"mod.py": """
            def submit(oid):
                ref = ObjectRef(oid, None, _register=False)
                ref._weak = False
                return ref
            """}, tmp_path)
        assert keys == []

    def test_ephemeral_weak_ref_passes(self, tmp_path):
        keys = _one("ref_lifecycle", {"mod.py": """
            def probe(worker, oids):
                refs = [ObjectRef(o, None, _register=False)
                        for o in oids]
                return worker.wait(refs, 1, 2.0)[0] is not None
            """}, tmp_path)
        assert keys == []

    def test_double_release_caught(self, tmp_path):
        keys = _one("ref_lifecycle", {"mod.py": """
            def f(worker, oid):
                worker.reference_counter.remove_local_reference(oid)
                worker.reference_counter.remove_local_reference(oid)
            """}, tmp_path)
        assert "ref_lifecycle:double-release:mod.f:oid" in keys, keys

    def test_release_on_separate_branches_passes(self, tmp_path):
        keys = _one("ref_lifecycle", {"mod.py": """
            def f(worker, oid, fast):
                if fast:
                    worker.defer_unref(oid)
                else:
                    worker.defer_unref(oid)
            """}, tmp_path)
        assert keys == []

    def test_get_after_free_caught(self, tmp_path):
        # the release is an Expr stmt; the get is in a Return (mod) or
        # an Assign (mod2) — walk both shapes
        keys = _one("ref_lifecycle", {"mod.py": """
            def f(worker, oid):
                worker.defer_unref(oid)
                return worker.get([oid])
            """, "mod2.py": """
            def g(worker, oid):
                worker.defer_unref(oid)
                val = worker.get([oid], None)
                return val
            """}, tmp_path)
        assert "ref_lifecycle:get-after-free:mod2.g:oid" in keys, keys

    def test_rebinding_resets_release_state(self, tmp_path):
        keys = _one("ref_lifecycle", {"mod.py": """
            def f(worker, oid, fresh):
                worker.defer_unref(oid)
                oid = fresh
                worker.defer_unref(oid)
            """}, tmp_path)
        assert keys == []

    def test_repo_worker_batch_path_is_clean(self, port_report):
        # the port's submit path re-registers via ``ref._weak = False``;
        # the pass must understand that idiom or every submit leaks
        assert [f.key for f in port_report.findings
                if "submit_task_batch" in f.key] == []


# ---------------------------------------------------------------------------
# closure_capture
# ---------------------------------------------------------------------------

class TestClosureCapture:
    def test_self_capture_caught(self, tmp_path):
        keys = _one("closure_capture", {"mod.py": """
            class A:
                def kick(self):
                    @remote
                    def probe():
                        return self.state
                    return probe.remote()
            """}, tmp_path)
        assert "closure_capture:self-capture:mod.A.kick.probe" in keys, keys

    def test_resource_capture_caught(self, tmp_path):
        keys = _one("closure_capture", {"mod.py": """
            import threading

            def run():
                lk = threading.Lock()

                @remote
                def guarded():
                    with lk:
                        return 1
                return guarded.remote()
            """}, tmp_path)
        assert ("closure_capture:resource-capture:mod.run.guarded:lk"
                in keys), keys

    def test_array_capture_caught(self, tmp_path):
        keys = _one("closure_capture", {"mod.py": """
            def run(np):
                big = np.zeros(1 << 20)

                @remote
                def add(i):
                    return big + i
                return [add.remote(i) for i in range(8)]
            """}, tmp_path)
        assert ("closure_capture:array-capture:mod.run.add:big"
                in keys), keys

    def test_module_capture_caught(self, tmp_path):
        keys = _one("closure_capture", {"mod.py": """
            def run():
                import numpy as np

                @remote
                def make():
                    return np.zeros(3)
                return make.remote()
            """}, tmp_path)
        assert ("closure_capture:module-capture:mod.run.make:np"
                in keys), keys

    def test_decorator_is_not_a_capture(self, tmp_path):
        # @ray_tpu_torch.remote evaluates in the ENCLOSING scope at def
        # time; it must not count as the task closing over the module
        keys = _one("closure_capture", {"mod.py": """
            def run():
                import ray_tpu

                @ray_tpu.remote
                def double(x):
                    return x * 2
                return double.remote(2)
            """}, tmp_path)
        assert keys == []

    def test_wrapped_nested_def_caught(self, tmp_path):
        keys = _one("closure_capture", {"mod.py": """
            import threading

            def run(remote):
                lk = threading.Lock()

                def task():
                    with lk:
                        return 1
                return remote(task).remote()
            """}, tmp_path)
        assert ("closure_capture:resource-capture:mod.run.task:lk"
                in keys), keys

    def test_param_passing_is_clean(self, tmp_path):
        keys = _one("closure_capture", {"mod.py": """
            def run(np):
                big = np.zeros(1 << 20)

                @remote
                def add(arr, i):
                    return arr + i
                return [add.remote(big, i) for i in range(8)]
            """}, tmp_path)
        assert keys == []


# ---------------------------------------------------------------------------
# blocking_calls
# ---------------------------------------------------------------------------

_AGG = {"mod.py": """
    import ray_tpu

    @ray_tpu.remote
    class Agg:
        def combine(self, ref):
            return ray_tpu.get(ref) + 1
    """}


class TestBlockingCalls:
    def test_blocking_get_in_actor_method(self, tmp_path):
        keys = _one("blocking_calls", _AGG, tmp_path)
        assert "blocking_calls:blocking-get:mod.Agg.combine" in keys, keys

    def test_get_with_timeout_passes(self, tmp_path):
        keys = _one("blocking_calls", {"mod.py": """
            import ray_tpu

            @ray_tpu.remote
            class Agg:
                def combine(self, ref):
                    return ray_tpu.get(ref, timeout=5.0) + 1
            """}, tmp_path)
        assert keys == []

    def test_bare_acquire_in_zone(self, tmp_path):
        keys = _one("blocking_calls", {"_private/runtime/node_daemon.py": """
            class NodeDaemon:
                def run(self):
                    while True:
                        self._lock.acquire()
            """}, tmp_path)
        assert ("blocking_calls:bare-acquire:"
                "_private.runtime.node_daemon.NodeDaemon.run:_lock"
                in keys), keys

    def test_acquire_with_timeout_in_zone_passes(self, tmp_path):
        keys = _one("blocking_calls", {"_private/runtime/node_daemon.py": """
            class NodeDaemon:
                def run(self):
                    while True:
                        if not self._lock.acquire(timeout=1.0):
                            continue
            """}, tmp_path)
        assert keys == []

    def test_blocking_result_in_zone(self, tmp_path):
        keys = _one("blocking_calls", {"_private/runtime/node_daemon.py": """
            class NodeDaemon:
                def run(self):
                    while True:
                        self._pending_fut.result()
            """}, tmp_path)
        assert ("blocking_calls:blocking-result:"
                "_private.runtime.node_daemon.NodeDaemon.run"
                in keys), keys

    def test_allowlist_suppresses(self, tmp_path):
        allow = frozenset({"blocking_calls:blocking-get:mod.Agg.combine"})
        keys = _one("blocking_calls", _AGG, tmp_path, allow=allow)
        assert keys == []

    def test_non_zone_non_actor_code_exempt(self, tmp_path):
        keys = _one("blocking_calls", {"mod.py": """
            import ray_tpu

            def driver_main(refs):
                return ray_tpu.get(refs)
            """}, tmp_path)
        assert keys == []


# ---------------------------------------------------------------------------
# knobs doc tokenizer (regression: substring false negative)
# ---------------------------------------------------------------------------

def _tokenizer_run(tmp_path, readme_text, knob_names):
    lines = "".join(f'GLOBAL_CONFIG.define("{n}", int, 1, "d")\n'
                    for n in knob_names)
    reads = " + ".join(f"GLOBAL_CONFIG.{n}" for n in knob_names)
    return _knobs(tmp_path, {
        "pkg/_private/config.py": lines,
        "pkg/app.py": f"def f(GLOBAL_CONFIG):\n    return {reads}\n"},
        readme_text)


class TestKnobsDocTokenizer:
    def test_substring_ride_along_now_caught(self, tmp_path):
        # `tick_interval_s` is a substring of the documented
        # `sched_tick_interval_s` — a plain `in` check would miss it
        keys = _tokenizer_run(tmp_path, "Knobs: `sched_tick_interval_s`.\n",
                              ["sched_tick_interval_s", "tick_interval_s"])
        assert "knob:undocumented:tick_interval_s" in keys, keys
        assert "knob:undocumented:sched_tick_interval_s" not in keys

    def test_brace_expanded_doc_counts(self, tmp_path):
        keys = _tokenizer_run(tmp_path, "Limits: `sched_max_{edges,nodes}`.\n",
                              ["sched_max_edges", "sched_max_nodes"])
        assert not any(k.startswith("knob:undocumented") for k in keys), keys

    def test_env_spelling_counts(self, tmp_path):
        # the port's fixture reads "Set RAY_TPU_TORCH_SPILL_DIR ..."
        keys = _tokenizer_run(tmp_path,
                              "Set RAY_TPU_SPILL_DIR to relocate spills.\n",
                              ["spill_dir"])
        assert not any(k.startswith("knob:undocumented") for k in keys), keys

    def test_multiline_table_cell_counts(self, tmp_path):
        keys = _tokenizer_run(tmp_path,
                              "| `spill_dir`\n|  where spills go |\n",
                              ["spill_dir"])
        assert not any(k.startswith("knob:undocumented") for k in keys), keys


# ---------------------------------------------------------------------------
# the port's spelling, where it departs from the reference's
# ---------------------------------------------------------------------------

class TestPortSpelling:
    """The port's passes name its own package: the environment spelling
    ``RAY_TPU_TORCH_<NAME>`` documents and reads ``<name>`` (and not
    ``torch_<name>``, nor does the reference's ``RAY_TPU_<NAME>`` count),
    and ``ray_tpu_torch.get`` is a blocking get."""

    def _knob_keys(self, tmp_path, readme_text, reader, names):
        _write(tmp_path, "pkg/_private/config.py", "".join(
            f'GLOBAL_CONFIG.define("{n}", int, 1, "d")\n' for n in names))
        _write(tmp_path, "pkg/app.py", reader)
        (tmp_path / "README.md").write_text(readme_text)
        return _keys(knobs.analyze(str(tmp_path / "pkg"), _mk,
                                   readme_path=str(tmp_path / "README.md")))

    def test_env_spelling_documents_the_knob_not_a_torch_prefixed_one(
            self, tmp_path):
        keys = self._knob_keys(
            tmp_path, "Set RAY_TPU_TORCH_SPILL_DIR.\n",
            "def f(c):\n    return c.spill_dir + c.torch_spill_dir\n",
            ["spill_dir", "torch_spill_dir"])
        assert keys == ["knob:undocumented:torch_spill_dir"], keys
        # the reference reads the same token as documenting torch_spill_dir
        ref_keys = _keys(ref_knobs.analyze(
            str(tmp_path / "pkg"), _mk,
            readme_path=str(tmp_path / "README.md")))
        assert ref_keys == ["knob:undocumented:spill_dir"], ref_keys

    def test_reference_env_spelling_neither_documents_nor_reads(
            self, tmp_path):
        keys = self._knob_keys(
            tmp_path, "Set RAY_TPU_SPILL_DIR.\n",
            'import os\nV = os.environ.get("RAY_TPU_SPILL_DIR")\n',
            ["spill_dir"])
        assert keys == ["knob:dead:spill_dir",
                        "knob:undocumented:spill_dir"], keys

    def test_env_literal_is_a_read(self, tmp_path):
        keys = self._knob_keys(
            tmp_path, "`spill_dir`\n",
            'import os\nV = os.environ.get("RAY_TPU_TORCH_SPILL_DIR")\n',
            ["spill_dir"])
        assert keys == [], keys

    def test_port_get_is_blocking_in_an_actor_and_after_free(self, tmp_path):
        _write(tmp_path, "mod.py", """
            import ray_tpu_torch

            @ray_tpu_torch.remote
            class Agg:
                def combine(self, ref):
                    return ray_tpu_torch.get(ref) + 1

            def g(oid):
                ray_tpu_torch.defer_unref(oid)
                return ray_tpu_torch.get([oid], None)
            """)
        assert _keys(blocking_calls.analyze(str(tmp_path), _mk)) == [
            "blocking_calls:blocking-get:mod.Agg.combine"]
        assert _keys(ref_lifecycle.analyze(str(tmp_path), _mk)) == [
            "ref_lifecycle:get-after-free:mod.g:oid"]

    def test_port_remote_decorator_marks_a_remote_def(self, tmp_path):
        _write(tmp_path, "mod.py", """
            import ray_tpu_torch

            class A:
                def kick(self):
                    @ray_tpu_torch.remote(num_cpus=1)
                    def probe():
                        return self.state
                    return probe.remote()
            """)
        assert _keys(closure_capture.analyze(str(tmp_path), _mk)) == [
            "closure_capture:self-capture:mod.A.kick.probe"]


# ---------------------------------------------------------------------------
# the port's tables: anchors, the baseline, the static lock graph
# ---------------------------------------------------------------------------

def _calls(tree, names):
    return any(isinstance(n, ast.Call) and (
        getattr(n.func, "attr", None) in names
        or getattr(n.func, "id", None) in names) for n in ast.walk(tree))


def _stale_anchors(w, root):
    """Anchors of the channel, op-channel and frame-field tables of pass
    module ``w`` that no longer find what they name under ``root`` (the
    pass itself skips them without a word): a send spec whose file no
    longer calls its callee, a recv spec whose function is gone, an op
    channel whose client calls no rpc callee or whose server class is
    gone, a frame var spec whose function is gone or never names its
    variable."""
    def tree(rel):
        return parse_file(os.path.join(root, rel))

    stale = []
    for ch in w.DEFAULT_CHANNELS:
        for s in ch.sends:
            t = tree(s.file)
            if t is None or not _calls(t, {s.callee}):
                stale.append(f"{ch.name} send {s.file}:{s.callee}")
        for r in ch.recvs:
            t = tree(r.file)
            if t is None or not find_function(t, r.func):
                stale.append(f"{ch.name} recv {r.file}:{r.func}")
    for och in w.DEFAULT_OP_CHANNELS:
        client, server = tree(och.client_file), tree(och.server_file)
        if client is None or server is None \
                or not _calls(client, set(och.rpc_callees)) or not any(
                    isinstance(n, ast.ClassDef)
                    and n.name == och.server_class for n in server.body):
            stale.append(f"{och.name} op channel")
    for ff in w.DEFAULT_FRAME_FIELDS:
        for kind, specs in (("producer", ff.producers),
                            ("consumer", ff.consumers)):
            for v in specs:
                t = tree(v.file)
                fns = find_function(t, v.func) if t is not None else []
                if not any(w._frame_var_matches(n, v.var)
                           for fn in fns for n in ast.walk(fn)):
                    stale.append(f"{ff.name} {kind} {v.file}:{v.func}")
    return stale


class TestTables:
    def test_every_anchor_resolves(self):
        assert _stale_anchors(wire_protocol, analysis.PACKAGE_ROOT) == []
        # the same check on the reference's table and tree
        assert _stale_anchors(ref_wire_protocol,
                              ref_analysis.PACKAGE_ROOT) == []

    def test_a_renamed_function_is_a_stale_anchor(self, tmp_path):
        """check_channel skips a file or function that is gone without a
        word; the anchor check is what notices."""
        import shutil
        root = tmp_path / "pkg"
        named = {s.file for ch in wire_protocol.DEFAULT_CHANNELS
                 for s in list(ch.sends) + list(ch.recvs)}
        named |= {v.file for ff in wire_protocol.DEFAULT_FRAME_FIELDS
                  for v in list(ff.producers) + list(ff.consumers)}
        named |= {f for och in wire_protocol.DEFAULT_OP_CHANNELS
                  for f in (och.client_file, och.server_file)}
        for rel in named:
            (root / rel).parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(os.path.join(analysis.PACKAGE_ROOT, rel), root / rel)
        assert _stale_anchors(wire_protocol, str(root)) == []
        daemon = root / "_private/runtime/node_daemon.py"
        src = daemon.read_text()
        daemon.write_text(src.replace("def _send_locked(",
                                      "def _send_link_locked(")
                          .replace("self._send_locked(",
                                   "self._send_link_locked("))
        (root / "_private/runtime/remote_pool.py").write_text(
            (root / "_private/runtime/remote_pool.py").read_text().replace(
                "def _dispatch_daemon_msg(", "def _dispatch_msg("))
        assert _stale_anchors(wire_protocol, str(root)) == [
            "daemon_to_head send _private/runtime/node_daemon.py:"
            "_send_locked",
            "daemon_to_head recv _private/runtime/remote_pool.py:"
            "RemoteNodePool._dispatch_daemon_msg"]

    def test_daemon_to_head_sends_include_the_locked_wrapper(self):
        ch = {c.name: c for c in wire_protocol.DEFAULT_CHANNELS}
        assert [(s.file, s.callee) for s in ch["daemon_to_head"].sends] == [
            ("_private/runtime/node_daemon.py", "_send_head"),
            ("_private/runtime/node_daemon.py", "_send_head_raw"),
            ("_private/runtime/node_daemon.py", "_send_locked")]
        # without it the seq envelope and the clock handshake are
        # dispatched but never sent
        without = [wire_protocol.ChannelSpec(
            name=ch["daemon_to_head"].name,
            sends=ch["daemon_to_head"].sends[:2],
            recvs=ch["daemon_to_head"].recvs)]
        assert _keys(wire_protocol.analyze(
            analysis.PACKAGE_ROOT, _mk, channels=without, op_channels=[],
            frame_fields=[])) == ["wire:handled-unsent:daemon_to_head:clock",
                                  "wire:handled-unsent:daemon_to_head:seq"]

    def test_baseline_is_the_references_plus_decode_steps(self):
        ref = set(ref_analysis.load_baseline())
        port = set(analysis.load_baseline())
        assert port - ref == {
            "shared_state:unguarded-rmw:"
            "models.inference.InferenceEngine.decode_steps"}
        assert ref - port == set()

    def test_static_lock_graph(self):
        edges = lock_order.collect_edges(analysis.PACKAGE_ROOT)
        d = "_private.runtime.node_daemon.NodeDaemon."
        assert edges == {
            ("_private.client.ClientWorker._send_lock",
             "_private.client.ClientWorker._seq_lock"),
            (d + "_completion_lock", d + "_head_lock"),
            (d + "_completion_lock", d + "_lock"),
            (d + "_completion_lock", d + "_p2p_lock"),
            (d + "_completion_lock", d + "_resview_lock"),
            ("actor._ProcessActorRuntime._restart_lock",
             "_private.worker.Worker._actors_lock"),
            ("data._streaming._SPLIT_REGISTRY_LOCK",
             "data._streaming.StreamingSplitCoordinator._cond"),
            ("serve.core._DeploymentState._roll_lock",
             "serve.core._DeploymentState._lock")}

    def test_wrap_lock_ids_name_static_locks(self):
        """Every ``wrap_lock(lock, id)`` site passes the static pass's id
        of the lock it wraps (module.Class.attr), or the witness diff
        would compare disjoint sets."""
        sites = []
        for rel, ap in iter_py_files(analysis.PACKAGE_ROOT):
            tree = parse_file(ap)
            mod = module_name(rel)
            known = {f"{mod}.{g}" for g in collect_module_locks(tree, mod)}
            for cls in collect_classes(tree, mod):
                known |= {cls.lock_id(a) for a in cls.locks}
            for n in ast.walk(tree):
                if (isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "wrap_lock"):
                    lock_id = n.args[1].value
                    sites.append(lock_id)
                    assert lock_id in known, (rel, n.lineno, lock_id)
        assert len(sites) == 14, sites


class TestParseCache:
    """run_all parses each file once for its eight passes (the port's
    ``_astutil.parse_cache``); the findings are those of each pass run
    alone, and a file written after a run is read afresh."""

    def test_one_tree_a_file_inside_the_block(self, tmp_path):
        from ray_tpu_torch._private.analysis import _astutil

        path = _write(tmp_path, "mod.py", "x = 1\n")
        with _astutil.parse_cache():
            a = parse_file(str(path))
            assert parse_file(str(tmp_path / "." / "mod.py")) is a
            with _astutil.parse_cache():      # nested: the same cache
                assert parse_file(str(path)) is a
            assert parse_file(str(path)) is a
        _write(tmp_path, "mod.py", "x = 2\n")
        b = parse_file(str(path))
        assert b is not a and b.body[0].value.value == 2

    def test_run_all_finds_what_each_pass_finds_alone(self, tmp_path):
        _write(tmp_path, "mod.py", """
            import threading

            class C:
                def __init__(self):
                    self._lock_a = threading.Lock()
                    self._lock_b = threading.Lock()
                    self.n = 0
                    threading.Thread(target=self.m1).start()

                def m1(self):
                    self.n += 1
                    with self._lock_a:
                        with self._lock_b:
                            pass

                def m2(self):
                    self.n += 1
                    with self._lock_b:
                        with self._lock_a:
                            pass

            def leak(oid):
                ref = ObjectRef(oid, None, _register=False)
                return ref
            """)
        report = analysis.run_all(root=str(tmp_path),
                                  baseline_path=str(tmp_path / "none"))
        alone = [f.key for _, fn in analysis.PASSES
                 for f in fn(str(tmp_path), _mk)]
        assert sorted(_keys(report.findings)) == sorted(alone)
        assert {k.split(":")[0] for k in alone} == {
            "lock_order", "shared_state", "ref_lifecycle"}


# ---------------------------------------------------------------------------
# the wire schema compiled from the channel table
# ---------------------------------------------------------------------------

#: the schema the port kept by hand before it compiled one from the table
HAND_SCHEMA = {
    "worker_to_owner": {
        "ready": {2}, "done": {4}, "err": {5}, "rpc": {4}, "many": {2},
        "cring": {1}, "cenv": {2},
    },
    "daemon_to_head": {
        "seq": {5}, "w": {3}, "worker_died": {3, 4}, "fetched": {4},
        "pong": {3}, "log": {3}, "pulled": {2}, "log_listed": {3},
        "log_data": {4}, "clock": {3}, "local_lease": {3},
        "local_retry": {3}, "p2p_done": {3}, "p2p_fallback": {3},
        "aresolve": {2}, "fault": {2}, "store_stats": {3},
    },
    "head_to_daemon": {
        "spawn": {2, 3}, "to_w": {3}, "to_ctrl": {3}, "kill": {2},
        "fetch": {3}, "stage": {2}, "free": {2}, "ping": {2},
        "log_list": {2}, "log_read": {4}, "store_stats": {2},
        "resview": {2}, "aroute": {3}, "node_dead": {2}, "fence": {2},
        "ack": {2}, "exit": {1}, "error": {2},
    },
}


class TestCompiledWireSchema:
    def test_schema_agrees_with_the_hand_table(self):
        """The compiled schema has every tag of the hand table, with its
        arities, except where no sender produces the optional form the
        hand table allowed (a two-element ``spawn``, a three-element
        ``worker_died``: the protocol's docstring lists both, no send
        site builds them), plus the profile plane's ``prof`` and
        ``util`` reports the hand table lacked. Relayed and
        handshake-time tags are allowed at any arity."""
        schema = runtime_sanitizer._build_wire_schema()
        assert set(HAND_SCHEMA) <= set(schema)
        diffs = {}
        for channel, table in HAND_SCHEMA.items():
            sent, allow = schema[channel]
            for tag in sorted(set(table) | set(sent)):
                if tag in allow:
                    diffs[(channel, tag)] = "allowed"
                elif table.get(tag) != sent.get(tag):
                    diffs[(channel, tag)] = (table.get(tag), sent.get(tag))
        assert diffs == {
            ("worker_to_owner", "prof"): (None, {2}),
            ("daemon_to_head", "worker_died"): ({3, 4}, {4}),
            ("daemon_to_head", "util"): (None, {2}),
            ("head_to_daemon", "spawn"): ({2, 3}, {3}),
            ("head_to_daemon", "to_w"): "allowed",
            ("head_to_daemon", "to_ctrl"): "allowed",
            ("head_to_daemon", "error"): "allowed",
        }
        assert not hasattr(runtime_sanitizer, "WIRE_SCHEMA")

    def test_schema_follows_the_table(self, monkeypatch):
        """A send site the table does not model shows up at run time."""
        ch = {c.name: c for c in wire_protocol.DEFAULT_CHANNELS}
        cut = wire_protocol.ChannelSpec(
            name="daemon_to_head", sends=ch["daemon_to_head"].sends[:2],
            recvs=ch["daemon_to_head"].recvs)
        monkeypatch.setattr(wire_protocol, "DEFAULT_CHANNELS", [cut])
        with _Armed() as san:
            san.check_wire("daemon_to_head", ("seq", 1, 0, False, ("w",)))
            san.check_wire("daemon_to_head", ("pong", 1, 2))
            assert san.wire_violations() == [
                "[daemon_to_head] tag 'seq' not in the static channel "
                "table"]


# ---------------------------------------------------------------------------
# runtime sanitizer (raysan's dynamic half)
# ---------------------------------------------------------------------------

class _Armed:
    """Arm the sanitizer for one test, always disarming after."""

    def __enter__(self):
        runtime_sanitizer.arm()
        return runtime_sanitizer

    def __exit__(self, *exc):
        runtime_sanitizer.disarm()
        return False


class TestRuntimeSanitizer:
    def test_wrap_lock_is_identity_when_off(self):
        runtime_sanitizer.disarm()
        lk = threading.Lock()
        assert runtime_sanitizer.wrap_lock(lk, "m.C.x") is lk

    def test_lock_witness_records_edges(self):
        with _Armed() as san:
            a = san.wrap_lock(threading.Lock(), "m.A.a")
            b = san.wrap_lock(threading.Lock(), "m.B.b")
            with a:
                with b:
                    pass
            assert ("m.A.a", "m.B.b") in san.observed_edges()

    def test_inversion_against_static_graph(self):
        # plant the bug: runtime takes b-then-a where the static graph
        # says a-then-b
        with _Armed() as san:
            a = san.wrap_lock(threading.Lock(), "m.A.a")
            b = san.wrap_lock(threading.Lock(), "m.B.b")
            with b:
                with a:
                    pass
            inversions, _ = san.lock_witness_violations(
                static_edges={("m.A.a", "m.B.b")})
            assert len(inversions) == 1 and "inverts" in inversions[0]

    def test_dynamic_only_inversion(self):
        with _Armed() as san:
            a = san.wrap_lock(threading.Lock(), "m.A.a")
            b = san.wrap_lock(threading.Lock(), "m.B.b")
            with a:
                with b:
                    pass
            with b:
                with a:
                    pass
            inversions, _ = san.lock_witness_violations(static_edges=set())
            assert len(inversions) == 1 and "both observed" in inversions[0]

    def test_uncharted_is_informational_not_violation(self):
        with _Armed() as san:
            a = san.wrap_lock(threading.Lock(), "m.A.a")
            b = san.wrap_lock(threading.Lock(), "m.B.b")
            with a:
                with b:
                    pass
            report = san.report_at_shutdown({}, static_edges=set())
            assert report["lock_uncharted"] == ["m.A.a -> m.B.b"]
            assert san.clean(report)

    def test_rlock_reentrancy_keeps_stack_straight(self):
        with _Armed() as san:
            r = san.wrap_lock(threading.RLock(), "m.A.r")
            b = san.wrap_lock(threading.Lock(), "m.B.b")
            with r:
                with r:  # reentrant: must not duplicate the edge base
                    pass
                with b:
                    pass
            assert ("m.A.r", "m.B.b") in san.observed_edges()
            assert ("m.A.r", "m.A.r") not in san.observed_edges()

    def test_witness_forwards_lock_introspection(self):
        with _Armed() as san:
            r = san.wrap_lock(threading.RLock(), "m.A.r")
            with r:
                assert r._is_owned()

    def test_shm_leak_ledger_catches_planted_leak(self):
        from ray_tpu_torch._private.ids import ObjectID
        with _Armed() as san:
            leaked = ObjectID.from_random()
            freed = ObjectID.from_random()
            san.ledger_alloc("arena", leaked, 4096)
            san.ledger_alloc("spill", freed, 128)
            san.ledger_free(freed)
            assert san.ledger_size() == 1
            leaks = san.shm_leaks(set())  # nothing has a refcount row
            assert len(leaks) == 1 and leaked.hex()[:16] in leaks[0]
            # a live refcount row means "not leaked, just still in use"
            assert san.shm_leaks({leaked.hex()}) == []

    def test_shm_ledger_keeps_first_record_across_spill(self):
        from ray_tpu_torch._private.ids import ObjectID
        with _Armed() as san:
            oid = ObjectID.from_random()
            san.ledger_alloc("arena", oid, 4096)
            san.ledger_alloc("spill", oid, 4096)  # migration, same object
            assert san.ledger_size() == 1
            san.ledger_free(oid)
            assert san.ledger_size() == 0

    def test_ref_leak_census(self):
        from ray_tpu_torch._private.ids import ObjectID

        class _Holder:  # weakref-able stand-in for a registered ref
            def __init__(self, oid):
                self._oid = oid

            def object_id(self):
                return self._oid

        with _Armed() as san:
            lost = ObjectID.from_random()
            held = ObjectID.from_random()
            holder = _Holder(held)
            san.track_ref(holder)
            snapshot = {lost: (1, 0, 0, False), held: (1, 0, 0, False)}
            leaks = san.ref_leaks(snapshot)
            assert len(leaks) == 1 and lost.hex()[:16] in leaks[0]
            # the census is weak: dropping the holder exposes the row
            del holder
            gc.collect()
            assert len(san.ref_leaks(snapshot)) == 2

    def test_external_pin_suppresses_ref_leak(self):
        from ray_tpu_torch._private.ids import ObjectID
        with _Armed() as san:
            oid = ObjectID.from_random()
            san.note_external_ref(oid)
            assert san.ref_leaks({oid: (1, 0, 0, False)}) == []
            san.drop_external_ref(oid)
            assert len(san.ref_leaks({oid: (1, 0, 0, False)})) == 1

    def test_wire_schema_flags_unknown_tag_and_bad_frame(self):
        with _Armed() as san:
            san.check_wire("head_to_daemon", ("no_such_tag", 1))
            san.check_wire("head_to_daemon", ["not", "a", "tuple"])
            v = san.wire_violations()
            assert any("no_such_tag" in x for x in v), v
            assert any("non-tagged frame" in x for x in v), v

    def test_wire_schema_allows_synthetic_and_assumed_tags(self):
        with _Armed() as san:
            san.check_wire("daemon_to_head", ("__died__", "cause"))
            san.check_wire("head_to_daemon", ("to_w", 1, 2, 3))
            assert san.wire_violations() == []

    def test_check_wire_is_noop_when_off(self):
        runtime_sanitizer.disarm()
        runtime_sanitizer.check_wire("head_to_daemon", ("garbage",))
        assert runtime_sanitizer.wire_violations() == []

    def test_clean_report_roundtrip(self):
        with _Armed() as san:
            report = san.report_at_shutdown({}, static_edges=set())
            assert san.clean(report) and san.last_report() is report

    def test_default_graph_is_the_static_pass(self):
        """With no graph passed, the witness diffs against the port's
        static lock graph: taking a static edge's locks in reverse order
        is an inversion."""
        d = "_private.runtime.node_daemon.NodeDaemon."
        with _Armed() as san:
            outer = san.wrap_lock(threading.Lock(), d + "_completion_lock")
            inner = san.wrap_lock(threading.Lock(), d + "_head_lock")
            with inner:
                with outer:
                    pass
            inversions, uncharted = san.lock_witness_violations()
            assert inversions == [
                f"runtime order {d}_head_lock -> {d}_completion_lock "
                f"(thread {threading.current_thread().name}) inverts "
                f"static edge {d}_completion_lock -> {d}_head_lock"]
            assert uncharted == []


# ---------------------------------------------------------------------------
# chip_smoke.py phase lint's own checks
# ---------------------------------------------------------------------------

class TestChipPhaseChecks:
    """Phase ``lint`` fails on what it must fail on: a dirty sanitizer
    report, and a lint that is not ok, skips a pass or keeps a stale
    suppression (a stand-in for the subprocess's report here)."""

    def test_report_problems(self):
        import chip_smoke

        clean = {"lock_inversions": [], "lock_uncharted": ["a -> b"],
                 "wire_violations": [], "shm_leaks": [], "ref_leaks": []}
        row, problems = chip_smoke.lint_report(runtime_sanitizer, clean)
        assert problems == [] and row["uncharted"] == 1
        for section in ("lock_inversions", "wire_violations", "shm_leaks",
                        "ref_leaks"):
            _, problems = chip_smoke.lint_report(
                runtime_sanitizer, dict(clean, **{section: ["x"]}))
            assert problems[0].startswith(section), problems
        assert chip_smoke.lint_report(runtime_sanitizer, None)[1]

    @pytest.mark.parametrize("report, problem", [
        ({"ok": False, "new": [{"key": "k"}]}, "lint: exit"),
        ({"ok": True, "durations_s": {"knobs": 1.0}}, "ran the passes"),
        ({"ok": True, "stale_suppressions": ["k"]}, "stale"),
    ])
    def test_static_problems(self, monkeypatch, report, problem):
        import chip_smoke

        full = {"ok": True, "new": [], "baselined": [],
                "stale_suppressions": [],
                "durations_s": dict.fromkeys(chip_smoke.LINT_PASSES, 1.0)}
        full.update(report)
        monkeypatch.setattr(chip_smoke.subprocess, "run",
                            lambda *a, **k: SimpleNamespace(
                                returncode=0 if full["ok"] else 1,
                                stdout=json.dumps(full), stderr=""))
        row, problems = chip_smoke.lint_static()
        assert row["static_lock_edges"] == 8
        assert len(problems) == 1 and problem in problems[0], problems

