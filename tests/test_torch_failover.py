"""The port's head failover: the cases of ``tests/test_failover.py`` on
``ray_tpu_torch``, plus the outbox and the lease journal driven through
both packages with the same sequences. As in the reference, the
subprocess head and the joining nodes start through the CLI
(``python -m ray_tpu_torch start --head`` / ``start --address``), and
the link-flap drill reads the node's state with ``util.state.list_nodes``.

Head-failover continuity: the sequenced daemon outbox, the lease
journal, exactly-once delivery across link flaps, and the seeded
head-kill soak.

Layers under test, smallest to largest:

- ``_Outbox`` unit mechanics (seq assignment, ack trim, stale acks,
  pending snapshots) with no cluster at all;
- head-side sequence DEDUP: a scripted replay stream into
  ``RemoteNodePool._demux_loop`` must dispatch each report exactly
  once and ack high-water marks;
- the GCS lease journal (journal/claim/done/replay) that failover
  reconciliation runs on;
- a seeded in-process link-flap drill (chaos ``head`` site, kind
  ``flap``): results stay bit-correct and side effects run once while
  every daemon link is repeatedly severed mid-run;
- the full soak: subprocess head with a journal, two remote nodes,
  a ray:// driver blocked in get(), the head SIGKILLs ITSELF at a
  seeded health-loop arrival, a fresh head replays the journal, the
  daemons rejoin with outbox replay, and the SAME client session
  resolves its pending get bit-correctly with no duplicate execution.
"""

import hashlib
import json
import os
import re
import subprocess
import sys
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import spawn_env
from ray_tpu_torch.util import state as util_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# _Outbox unit mechanics (no cluster)
# ---------------------------------------------------------------------------

class TestOutbox:
    def _box(self):
        from ray_tpu_torch._private.runtime.node_daemon import _Outbox
        return _Outbox()

    def test_seq_assignment_and_depth(self):
        box = self._box()
        assert box.depth() == 0 and box.last_seq == 0
        s1, d1 = box.append(("w", 0, ("done",)))
        s2, d2 = box.append(("pulled", b"x"))
        assert (s1, d1) == (1, 1)
        assert (s2, d2) == (2, 2)
        assert box.last_seq == 2

    def test_ack_trims_prefix_and_stale_ack_noop(self):
        box = self._box()
        for i in range(5):
            box.append(("w", i, ()))
        assert box.ack(3) == 3
        assert box.depth() == 2
        assert [s for s, _ in box.pending()] == [4, 5]
        # duplicate/stale acks are no-ops (replays re-ack old marks)
        assert box.ack(3) == 0
        assert box.ack(1) == 0
        assert box.depth() == 2
        # acks past the tail trim everything, and seq keeps advancing
        assert box.ack(99) == 2
        assert box.depth() == 0
        s, _ = box.append(("w", 9, ()))
        assert s == 6

    def test_pending_snapshot_is_ordered_and_stable(self):
        box = self._box()
        for i in range(4):
            box.append(("w", i, ()))
        box.ack(1)
        snap = box.pending()
        assert [s for s, _ in snap] == [2, 3, 4]
        # snapshot is a copy: later appends don't mutate it
        box.append(("w", 9, ()))
        assert [s for s, _ in snap] == [2, 3, 4]

    def test_meta_stays_local_and_leaves_with_its_ack(self):
        """A completion's lease note is not replayed (pending() is the
        wire's) and is dropped with the entry's ack."""
        box = self._box()
        box.append(("w", 0, ("done", b"t1")), {"tid": b"t1"})
        box.append(("pulled", b"x"))
        box.append(("w", 1, ("done", b"t2")), {"tid": b"t2"})
        assert box.pending() == [(1, ("w", 0, ("done", b"t1"))),
                                 (2, ("pulled", b"x")),
                                 (3, ("w", 1, ("done", b"t2")))]
        assert box.unacked_meta() == [{"tid": b"t1"}, {"tid": b"t2"}]
        box.ack(2)
        assert box.unacked_meta() == [{"tid": b"t2"}]
        box.ack(3)
        assert box.unacked_meta() == []


# ---------------------------------------------------------------------------
# head-side sequence dedup (scripted demux, no cluster)
# ---------------------------------------------------------------------------

class _ScriptedConn:
    """recv() pops a scripted message list, then EOFs; send() records."""

    def __init__(self, script):
        self.script = list(script)
        self.sent = []

    def recv(self):
        if not self.script:
            raise EOFError
        return self.script.pop(0)

    def send(self, msg):
        self.sent.append(msg)

    def close(self):
        pass


class TestHeadSeqDedup:
    def _pool(self, script):
        """Skeleton RemoteNodePool: just the demux/dedup state, with
        dispatch and loss handling stubbed out."""
        import threading as th

        from ray_tpu_torch._private.runtime.remote_pool import RemoteNodePool

        pool = RemoteNodePool.__new__(RemoteNodePool)
        pool._conn = _ScriptedConn(script)
        pool._seq_lock = th.Lock()
        pool._attach_gen = 0
        pool._last_seen_seq = 0
        pool.outbox_depth = 0
        pool.outbox_replayed = 0
        pool._conn_lock = th.Lock()
        pool._conn_dead = False
        pool._pending_sends = []
        dispatched = []
        pool._dispatch_daemon_msg = dispatched.append
        pool._on_daemon_lost = lambda gen=None: None
        return pool, dispatched

    def test_replay_is_deduped_exactly_once(self):
        # live 1,2 -> flap -> replay 1,2 (dupes) + 3 (new)
        script = [
            ("seq", 1, 1, False, ("w", 0, ("a",))),
            ("seq", 2, 2, False, ("w", 0, ("b",))),
            ("seq", 1, 3, True, ("w", 0, ("a",))),
            ("seq", 2, 2, True, ("w", 0, ("b",))),
            ("seq", 3, 1, True, ("w", 1, ("c",))),
        ]
        pool, dispatched = self._pool(script)
        pool._demux_loop()
        # every inner dispatched exactly once, in order
        assert [m[2] for m in dispatched] == [("a",), ("b",), ("c",)]
        # each envelope was acked at the running high-water mark
        acks = [m[1] for m in pool._conn.sent if m[0] == "ack"]
        assert acks == [1, 2, 2, 2, 3]
        # replayed envelopes counted (duplicates included: the counter
        # measures replay traffic, not unique messages)
        assert pool.outbox_replayed == 3
        assert pool._last_seen_seq == 3

    def test_adopting_pool_reads_nothing_until_dispatch_opens(self):
        """A pool adopting a rejoined daemon leaves the replay behind the
        hello unread until its workers and leases are adopted."""
        import threading as th

        script = [("seq", 1, 1, True, ("w", 0, ("done",)))]
        pool, dispatched = self._pool(script)
        pool._dispatch_open = th.Event()
        t = th.Thread(target=pool._demux_loop, daemon=True)
        t.start()
        t.join(timeout=0.3)
        assert t.is_alive() and dispatched == [] and len(
            pool._conn.script) == 1
        pool.open_dispatch()
        t.join(timeout=10)
        assert not t.is_alive()
        assert [m[2] for m in dispatched] == [("done",)]

    def test_direct_messages_bypass_sequencing(self):
        script = [
            ("seq", 1, 1, False, ("w", 0, ("a",))),
            ("clock", 123.0, 456.0),
            ("seq", 2, 1, False, ("w", 0, ("b",))),
        ]
        pool, dispatched = self._pool(script)
        pool._demux_loop()
        kinds = [m[0] for m in dispatched]
        assert kinds == ["w", "clock", "w"]
        assert pool._last_seen_seq == 2


# ---------------------------------------------------------------------------
# GCS lease journal (reconciliation substrate)
# ---------------------------------------------------------------------------

class TestLeaseJournal:
    def _svc(self, tmp_path, name="j"):
        from ray_tpu_torch._private.gcs import GcsJournal, GcsService
        return GcsService(None, journal=GcsJournal(str(tmp_path / name)))

    def test_lease_roundtrip_claim_once(self, tmp_path):
        svc = self._svc(tmp_path)
        assert svc.journal_enabled
        rec = {"name": "f", "attempt": 0, "returns": [b"r1"]}
        svc.journal_lease(b"t1", rec)
        assert svc.pending_leases() == {b"t1": rec}
        assert svc.claim_lease(b"t1") == rec
        assert svc.claim_lease(b"t1") is None  # claim-once
        svc._journal.close()

    def test_replay_restores_unresolved_leases_only(self, tmp_path):
        from ray_tpu_torch._private.gcs import GcsJournal, GcsService

        svc = self._svc(tmp_path)
        svc.journal_lease(b"t1", {"name": "done-before-crash",
                                  "attempt": 0})
        svc.journal_lease(b"t2", {"name": "inflight-at-crash",
                                  "attempt": 1})
        svc.journal_lease_done(b"t1")
        svc._journal.close()
        # head restart: only the unresolved lease is up for
        # reconciliation — resubmitting t1 would run it twice
        svc2 = GcsService(None, journal=GcsJournal(str(tmp_path / "j")))
        assert svc2.head_failovers == 1
        pend = svc2.pending_leases()
        assert set(pend) == {b"t2"}
        assert pend[b"t2"]["attempt"] == 1
        svc2._journal.close()

    def test_replayed_node_count_snapshots_pre_crash_membership(
            self, tmp_path):
        from ray_tpu_torch._private.gcs import GcsJournal, GcsService
        from ray_tpu_torch._private.ids import NodeID

        svc = self._svc(tmp_path)
        a, b = NodeID.from_random(), NodeID.from_random()
        svc.register_node(a, 1, {"CPU": 2}, kind="remote")
        svc.register_node(b, 2, {"CPU": 2}, kind="remote")
        svc.mark_node_dead(b, reason="test")
        svc._journal.close()
        svc2 = GcsService(None, journal=GcsJournal(str(tmp_path / "j")))
        # one remote node was alive pre-crash: the reconciler should
        # wait for exactly one rejoin before resubmitting leases
        assert svc2.replayed_node_count == 1
        # and a post-restart registration must NOT inflate the target
        svc2.register_node(NodeID.from_random(), 3, {"CPU": 2},
                           kind="remote")
        assert svc2.replayed_node_count == 1
        svc2._journal.close()

    def test_snapshot_compaction_carries_leases(self, tmp_path):
        from ray_tpu_torch._private.gcs import GcsJournal, GcsService

        svc = self._svc(tmp_path)
        svc.journal_lease(b"t9", {"name": "across-compaction",
                                  "attempt": 2})
        svc.compact_journal()
        svc._journal.close()
        svc2 = GcsService(None, journal=GcsJournal(str(tmp_path / "j")))
        assert set(svc2.pending_leases()) == {b"t9"}
        svc2._journal.close()


# ---------------------------------------------------------------------------
# seeded link-flap drill (in-process head, real daemon subprocess)
# ---------------------------------------------------------------------------

# exec-loaded (not module-level) so cloudpickle ships it BY VALUE: the
# daemon workers and a freshly restarted head cannot import this test
# module (same idiom as test_gcs_ft's Counter)
_TASK_SRC = """
def mark_and_hash(key, marks_path, sleep_s):
    import hashlib, os, time
    time.sleep(sleep_s)
    # O_APPEND: atomic for short writes -- the exactly-once receipt
    fd = os.open(marks_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND)
    try:
        os.write(fd, (key + "\\n").encode())
    finally:
        os.close(fd)
    return hashlib.sha256(key.encode()).hexdigest()
"""


def _load_task():
    ns: dict = {}
    exec(_TASK_SRC, ns)
    return ns["mark_and_hash"]


@pytest.mark.chaos
def test_link_flap_exactly_once(tmp_path):
    """Chaos ``head`` site, kind ``flap``: every remote daemon link is
    severed at seeded health-loop arrivals while tasks run. The outbox
    buffers reports through each blackout, rejoin replays them, and the
    head's sequence dedup keeps delivery exactly-once: results stay
    bit-correct and each task's side effect lands exactly once."""
    from ray_tpu_torch import chaos
    from ray_tpu_torch.cluster_utils import Cluster

    marks = str(tmp_path / "marks")
    cluster = None
    ray_tpu_torch.shutdown()
    try:
        cluster = Cluster(initialize_head=True,
                          head_node_args=dict(num_cpus=2, num_workers=2,
                                              scheduler="tensor",
                                              _system_config={
                                                  "sched_device": "cpu"}))
        node = cluster.add_node(num_cpus=2, resources={"flap": 2},
                                remote=True)
        cluster.wait_for_nodes(timeout=30)
        # seeded plan: sever every daemon link at four distinct
        # health-loop arrivals (~0.2s apart) while the batches run
        chaos.arm(chaos.FaultPlan(seed=11, faults=[
            ("head", 2, "flap"), ("head", 5, "flap"),
            ("head", 8, "flap"), ("head", 11, "flap")]))

        f = ray_tpu_torch.remote(_load_task()).options(resources={"flap": 1})
        keys = [f"flap-{i}" for i in range(12)]
        refs = [f.remote(k, marks, 0.3) for k in keys]
        vals = ray_tpu_torch.get(refs, timeout=120)

        expected = [hashlib.sha256(k.encode()).hexdigest() for k in keys]
        assert vals == expected  # bit-correct through the flaps
        with open(marks) as fh:
            lines = fh.read().split()
        assert sorted(lines) == sorted(keys), (
            f"side effects not exactly-once: {sorted(lines)}")
        fired = [x for x in util_state.list_faults()
                 if x["site"] == "head"]
        assert fired, "seeded plan injected no head flaps"
        # the node must come back ALIVE (grace window, not death) —
        # a late-scheduled flap may still be in its ~100ms rejoin
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            states = {n["state"] for n in util_state.list_nodes()
                      if n["node_id"] == node.node_id.hex()}
            if states == {"ALIVE"}:
                break
            time.sleep(0.2)
        assert states == {"ALIVE"}, f"node stuck in {states}"
        # and the resequenced link still carries fresh work
        assert ray_tpu_torch.get(f.remote("post-flap", marks, 0.0),
                           timeout=60) == hashlib.sha256(
                               b"post-flap").hexdigest()
    finally:
        chaos.disarm()
        if cluster is not None:
            cluster.shutdown()


# ---------------------------------------------------------------------------
# the seeded head-kill soak (subprocess head + 2 remote nodes + ray://)
# ---------------------------------------------------------------------------

def _start_head(journal, log_path, extra_env=None):
    env = spawn_env.child_env(extra=dict(
        {"RAY_TPU_TORCH_SCHED_DEVICE": "cpu"}, **(extra_env or {})))
    cmd = [sys.executable, "-m", "ray_tpu_torch", "start", "--head",
           "--num-cpus", "2", "--num-workers", "2",
           "--gcs-journal", journal]
    offset = (os.path.getsize(log_path) if os.path.exists(log_path)
              else 0)
    log = open(log_path, "a")
    proc = subprocess.Popen(cmd, env=env, stdout=log,
                            stderr=subprocess.STDOUT)
    address = None
    deadline = time.monotonic() + 90
    while time.monotonic() < deadline:
        with open(log_path) as f:
            f.seek(offset)
            tail = f.read()
        if proc.poll() is not None:
            raise RuntimeError("head exited during startup:\n"
                               + tail[-2000:])
        m = re.search(r"address='(ray://[^']+)'", tail)
        if m:
            address = m.group(1)
            break
        time.sleep(0.1)
    assert address, "head did not print a connect string"
    return proc, address


def _start_node(address, log_path, resources):
    env = spawn_env.child_env(
        extra={"RAY_TPU_TORCH_DAEMON_REJOIN_TIMEOUT_S": "60"})
    log = open(log_path, "a")
    return subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "start",
         "--address", address, "--num-cpus", "2",
         "--resources", json.dumps(resources)],
        env=env, stdout=log, stderr=subprocess.STDOUT)


@pytest.mark.chaos
def test_seeded_head_failover_soak(tmp_path):
    """The acceptance drill: tasks in flight on TWO remote nodes, the
    head SIGKILLs itself at a seeded chaos arrival, a fresh head
    replays the journal and reconciles leases, the daemons rejoin with
    outbox replay — and the SAME ray:// client session (no second
    client constructed) resolves its pending get() bit-correctly, with
    the side-effect file proving every task ran exactly once."""
    _failover_soak(tmp_path)


@pytest.mark.chaos
def test_head_failover_after_tasks_finish_in_the_blackout(tmp_path):
    """The soak with the fresh head started 12 s after the kill, so every
    task finishes while no head is up: its lease has left the worker's
    in-flight set and its completion waits in the daemon's outbox. The
    rejoin hello still reports the lease, the new head adopts it before
    it reads the replay, and no task runs twice (the reference's
    daemon reports running tasks only, and its new head runs all four
    again)."""
    _failover_soak(tmp_path, blackout_s=12.0)


def _failover_soak(tmp_path, blackout_s=0.0):
    """The soak's body; ``blackout_s``: how long after head #1's death
    head #2 starts."""
    journal = str(tmp_path / "gcs.journal")
    head_log = str(tmp_path / "head.log")
    marks = str(tmp_path / "marks")
    # seeded injection point: the 46th health-loop poll of the `head`
    # site (~9s of 0.2s ticks after the health loop starts). Same
    # seed + plan = same blackout point, run after run — late enough
    # that all four submits are journaled, early enough that every
    # task is still asleep on its node when the head dies.
    plan = {"seed": 7, "faults": [["head", 45, "kill"]]}
    head1, address = _start_head(
        journal, head_log,
        extra_env={"RAY_TPU_TORCH_CHAOS_PLAN": json.dumps(plan)})
    nodes, head2 = [], None
    relaunched, t = {}, None
    try:
        nodes.append(_start_node(address, str(tmp_path / "n1.log"),
                                 {"n1": 2}))
        nodes.append(_start_node(address, str(tmp_path / "n2.log"),
                                 {"n2": 2}))
        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(address=address)

        # wait until BOTH nodes' custom resources registered
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            res = ray_tpu_torch.cluster_resources()
            if res.get("n1") and res.get("n2"):
                break
            time.sleep(0.2)
        else:
            raise AssertionError(f"nodes never registered: "
                                 f"{ray_tpu_torch.cluster_resources()}")

        # 2 tasks per node, one per worker: ALL in flight when the head
        # dies (~9s in), all finishing (~15s) into daemon outboxes
        # while the head is down/restarting. Results of tasks that
        # FINISH before the kill would die with the old head's store —
        # keeping every task asleep across the blackout is the point.
        keys = [f"soak-{i}" for i in range(4)]
        f = ray_tpu_torch.remote(_load_task())
        refs = [f.options(resources={("n1" if i < 2 else "n2"): 1})
                .remote(keys[i], marks, 15.0) for i in range(4)]

        # restart the head on the SAME journal once chaos kills it —
        # WITHOUT the chaos plan, or head #2 would shoot itself too

        def _relaunch():
            head1.wait(timeout=120)
            time.sleep(blackout_s)
            relaunched["head"], relaunched["addr"] = _start_head(
                journal, head_log)

        t = threading.Thread(target=_relaunch, daemon=True)
        t.start()

        # the regression under test: THIS get is pending across the
        # head's death and resolves on the resumed session
        vals = ray_tpu_torch.get(refs, timeout=180)

        t.join(timeout=60)
        head2 = relaunched.get("head")
        assert head2 is not None, "head was never relaunched"
        assert relaunched["addr"] == address  # same endpoint + authkey
        assert head1.poll() is not None, "chaos never killed head #1"
        with open(head_log) as fh:
            log_text = fh.read()
        assert "chaos plan armed" in log_text

        expected = [hashlib.sha256(k.encode()).hexdigest() for k in keys]
        assert vals == expected, "results not bit-correct across failover"
        with open(marks) as fh:
            lines = fh.read().split()
        assert sorted(lines) == sorted(keys), (
            f"execution counter shows duplicate/lost runs: "
            f"{sorted(lines)}\n--- head log ---\n{log_text[-3000:]}")

        # the resumed session keeps working for NEW ops too
        assert ray_tpu_torch.get(
            f.options(resources={"n1": 1}).remote("post", marks, 0.0),
            timeout=60) == hashlib.sha256(b"post").hexdigest()
    finally:
        ray_tpu_torch.shutdown()
        # a head the relaunch thread starts after a failure above must
        # not outlive the test: stop head #1 (the thread then relaunches
        # at once), wait for the thread and stop what it started
        if head1.poll() is None:
            head1.kill()
        if t is not None:
            t.join(timeout=120)
        head2 = relaunched.get("head") or head2
        for p in [head1, head2] + nodes:
            if p is not None and p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()


# ---------------------------------------------------------------------------
# the same sequences through both packages
# ---------------------------------------------------------------------------

def test_outbox_matches_the_reference_on_seeded_sequences():
    """Seeded appends and acks (stale, duplicate and past-the-tail ones
    included) through the reference's _Outbox and the port's: every
    (seq, depth), ack count, depth and pending snapshot is equal."""
    import numpy as np

    from ray_tpu._private.runtime.node_daemon import _Outbox as RefOutbox
    from ray_tpu_torch._private.runtime.node_daemon import _Outbox

    rng = np.random.default_rng(5)
    ref, port = RefOutbox(), _Outbox()
    for step in range(400):
        if rng.random() < 0.6:
            msg = ("w", int(rng.integers(0, 4)), (step,))
            assert port.append(msg) == ref.append(msg)
        else:
            mark = int(rng.integers(0, ref.last_seq + 3))
            assert port.ack(mark) == ref.ack(mark)
        assert port.depth() == ref.depth()
        assert port.last_seq == ref.last_seq
        assert port.pending() == ref.pending()


def test_lease_journal_matches_the_reference(tmp_path):
    """Seeded journal / claim / done / compaction through both packages'
    GCS: after each restart (a replay of the journal) the pending
    leases, claims and failover counts are equal."""
    import numpy as np

    from ray_tpu._private.gcs import GcsJournal as RefJournal
    from ray_tpu._private.gcs import GcsService as RefService
    from ray_tpu_torch._private.gcs import GcsJournal, GcsService

    rng = np.random.default_rng(9)
    ref = RefService(None, journal=RefJournal(str(tmp_path / "r")))
    port = GcsService(None, journal=GcsJournal(str(tmp_path / "p")))
    for step in range(300):
        tid = bytes([int(rng.integers(0, 24))]) * 16
        op = rng.random()
        if op < 0.45:
            rec = {"name": f"t{step}", "attempt": int(rng.integers(0, 3)),
                   "returns": [tid[:8]]}
            ref.journal_lease(tid, rec)
            port.journal_lease(tid, rec)
        elif op < 0.7:
            assert port.claim_lease(tid) == ref.claim_lease(tid)
        elif op < 0.9:
            ref.journal_lease_done(tid)
            port.journal_lease_done(tid)
        elif op < 0.95:
            ref.compact_journal()
            port.compact_journal()
        else:
            ref._journal.close()
            port._journal.close()
            ref = RefService(None, journal=RefJournal(str(tmp_path / "r")))
            port = GcsService(None, journal=GcsJournal(str(tmp_path / "p")))
            assert port.head_failovers == ref.head_failovers
        assert port.pending_leases() == ref.pending_leases()
    ref._journal.close()
    port._journal.close()


def test_outbox_reports_reach_the_wire_in_sequence_order():
    """Many threads reporting at once (a daemon's per-worker readers, its
    pull threads): every ("seq", n, ...) envelope goes out in the order
    of n. The head drops any n at or below the highest it has seen, so
    an envelope overtaken on the wire is lost — a nested task's lease or
    completion report, and its caller hangs. The port takes the sequence
    number and sends under one hold of the link's lock; this drives
    NodeDaemon._send_head with a send slow enough to interleave."""
    import threading as th

    from ray_tpu_torch._private.runtime.node_daemon import (NodeDaemon,
                                                            _Outbox)

    class _SlowConn:
        def __init__(self):
            self.sent = []

        def send(self, msg):
            time.sleep(0.0005)
            self.sent.append(msg)

    daemon = NodeDaemon.__new__(NodeDaemon)
    daemon._outbox = _Outbox()
    daemon._head_lock = th.Lock()
    daemon._head = _SlowConn()

    def report(k):
        for i in range(50):
            daemon._send_head(("w", k, ("done", i)))

    threads = [th.Thread(target=report, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    seqs = [m[1] for m in daemon._head.sent if m[0] == "seq"]
    assert seqs == list(range(1, 401))
