"""Pass 3 — wire-protocol conformance.

ray_tpu_torch's control links are framed pickled tuples whose first element
is a string tag. Nothing ties a send site's shape to its recv-dispatch
branch except convention, so drift (a renamed tag, a new field, a
removed branch) fails silently at runtime as an ignored message or an
IndexError on a daemon thread. This pass makes the convention checkable:

- **send sites**: every literal ``("tag", …)`` tuple passed to a
  channel's send wrapper is collected as (tag, arity); wrapper deltas
  (``_log_request`` prepends a request id) and fixed-shape wrappers
  (``_remote_round(kind, payload)`` → 2-tuple) are modeled per channel.
- **recv dispatch**: in each dispatcher function we find the message
  variable (assigned from ``*.recv()`` / the wrapper's parameter), the
  tag variable (``kind = msg[0]``), then every ``== "tag"`` /
  ``in ("a", "b")`` branch, recording the deepest constant index into
  the message used in that branch and any exact tuple-unpacks.

Violations: a tag **sent but unhandled**, **handled but never sent**
(dead branch — or a sender that was deleted without its branch), and
**arity drift** (a branch indexing past every sent arity for its tag,
or an exact unpack length no sender produces).

Channels whose payloads are relayed opaquely (``to_w``/``to_ctrl``) or
produced dynamically (protocol error frames) are declared in
``assume_sent``/``assume_handled`` rather than silently skipped. The
byte-oriented peer-pull subprotocol (get/meta/ok/miss chunk streams) is
out of scope — it has its own length-prefixed framing and tests.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ray_tpu_torch._private.analysis._astutil import (
    find_function, parse_file)

PASS = "wire"


@dataclass
class SendSpec:
    file: str            # relpath under the scan root
    callee: str          # terminal name of the send wrapper
    #: "tuple_arg": first positional arg is a literal ("tag", ...) tuple;
    #: arity = len(tuple) + delta.
    #: "first_arg_tag": first positional arg is the tag string itself;
    #: the wrapper sends a tuple of fixed_arity elements.
    style: str = "tuple_arg"
    delta: int = 0
    fixed_arity: int = 2


@dataclass
class RecvSpec:
    file: str
    func: str            # "Class.method" or "func"


@dataclass
class ChannelSpec:
    name: str
    sends: Sequence[SendSpec]
    recvs: Sequence[RecvSpec]
    assume_sent: Set[str] = field(default_factory=set)
    assume_handled: Set[str] = field(default_factory=set)


#: the repo's real channel table (file paths relative to the package root)
DEFAULT_CHANNELS: List[ChannelSpec] = [
    ChannelSpec(
        name="head_to_daemon",
        sends=[
            SendSpec("_private/runtime/remote_pool.py", "_send_daemon"),
            SendSpec("_private/runtime/remote_pool.py", "_log_request",
                     delta=1),
            # node-death control frames originate head-side: the fence
            # on a rejoin-after-declared-dead readopt and the route
            # invalidation broadcast to every surviving daemon
            SendSpec("_private/worker.py", "_send_daemon"),
        ],
        recvs=[RecvSpec("_private/runtime/node_daemon.py",
                        "NodeDaemon.run")],
        # to_w/to_ctrl are built dynamically by _ProxyConn.send; error
        # frames come from protocol.mismatch_error at handshake time
        assume_sent={"to_w", "to_ctrl", "error"},
    ),
    ChannelSpec(
        name="daemon_to_head",
        # _send_head buffers report-class tags through the outbox and
        # wraps them in ("seq", n, depth, is_replay, inner) envelopes;
        # _send_head_raw is the direct socket write. Both end in
        # _send_locked, the write under an already-held _head_lock:
        # the seq envelope (numbered and sent in one hold), the outbox
        # replay and the clock handshake call it directly
        sends=[SendSpec("_private/runtime/node_daemon.py",
                        "_send_head"),
               SendSpec("_private/runtime/node_daemon.py",
                        "_send_head_raw"),
               SendSpec("_private/runtime/node_daemon.py",
                        "_send_locked")],
        recvs=[RecvSpec("_private/runtime/remote_pool.py",
                        "RemoteNodePool._demux_loop"),
               RecvSpec("_private/runtime/remote_pool.py",
                        "RemoteNodePool._dispatch_daemon_msg")],
    ),
    ChannelSpec(
        name="owner_to_worker",
        sends=[
            SendSpec("_private/runtime/process_pool.py", "send"),
            # control-ring writer: ("env", envelope) rides a shm slot
            # when it fits, the pipe verbatim otherwise — one schema
            # covers both transports
            SendSpec("_private/runtime/process_pool.py", "_ring_send"),
            SendSpec("actor.py", "_remote_round",
                     style="first_arg_tag", fixed_arity=2),
        ],
        recvs=[
            RecvSpec("_private/runtime/worker_process.py",
                     "_WorkerRunner.run"),
            RecvSpec("_private/runtime/worker_process.py",
                     "_WorkerRunner.rpc"),
            RecvSpec("_private/runtime/worker_process.py",
                     "_WorkerRunner._ctrl_loop"),
            RecvSpec("_private/runtime/worker_process.py",
                     "_WorkerRunner._run_nested"),
            # the node daemon decodes a bookkeeping copy of every lease
            # frame it relays head->worker — including the remote lease
            # envelope ("env", blob), which extends the batched
            # path to remote pools — so its dispatcher is a second recv
            # of this channel and drifts are caught on both decoders
            RecvSpec("_private/runtime/node_daemon.py",
                     "NodeDaemon._register_lease_msg"),
        ],
        # "reply" is also DISPATCHED by the worker's rpc() wait loop —
        # arity there is checked like any branch; node_daemon relays
        # head payloads through _to_worker opaquely (dynamic msg)
        # ("p2p", local, p2p) two-level adverts are injected by the
        # daemon's _intercept/_apply_resview through _to_worker
        # (dynamic msg var, not a literal send site)
        assume_sent={"p2p"},
    ),
    ChannelSpec(
        name="worker_to_owner",
        sends=[
            SendSpec("_private/runtime/worker_process.py", "send"),
            SendSpec("_private/runtime/worker_process.py", "_emit"),
            # completion-ring writer: ("cenv", envelope) on the shm
            # ring (the pipe fallback re-sends the buffered originals,
            # already covered by the send/_emit specs above)
            SendSpec("_private/runtime/worker_process.py", "_ring_emit"),
        ],
        recvs=[
            RecvSpec("_private/runtime/process_pool.py",
                     "ProcessWorkerPool._demux_loop"),
            RecvSpec("_private/runtime/process_pool.py",
                     "ProcessWorkerPool._handle_worker_msg"),
            RecvSpec("_private/runtime/process_pool.py",
                     "ProcessWorkerPool._handle_ring_msg"),
        ],
        # the daemon's _intercept peeks at done/err tails in transit
        # but the authoritative dispatcher is the owner pool
    ),
    ChannelSpec(
        name="peer_actor_lane",
        # daemon<->daemon actor-call lane riding the peer object plane:
        # _lane_send is the single framed-send point for the caller
        # side (("acall", envelope)), the executing side (("ares", tid,
        # status, data, timing)), and the resource-view gossip frames
        # (("rview", view): daemons re-share the head's
        # freshest view so local admission survives a slow/rejoining
        # head; _peer_serve adopts on epoch match + strictly newer v)
        sends=[SendSpec("_private/runtime/node_daemon.py",
                        "_lane_send")],
        recvs=[RecvSpec("_private/runtime/node_daemon.py",
                        "NodeDaemon._peer_serve"),
               RecvSpec("_private/runtime/node_daemon.py",
                        "NodeDaemon._lane_reader")],
        # "get" belongs to the byte-oriented peer-pull subprotocol
        # (chunked conn.send frames, out of scope per module docstring);
        # "ares" is validated inline by _lane_reader's guard clause and
        # unpacked in _on_ares, which the branch collector cannot see
        assume_sent={"get"},
        assume_handled={"ares"},
    ),
]


@dataclass
class FrameVarSpec:
    """One function that builds or reads a dict-shaped frame through a
    variable: ``var = {...literal...}`` / ``var["k"] = v`` on the
    producer side, ``var.get("k")`` / ``var["k"]`` on the consumer
    side. ``var`` matches a local name (``view``) or an attribute's
    terminal name (``_resview`` matches ``self._resview``)."""
    file: str
    func: str            # "Class.method" or "func"
    var: str             # local name or attribute terminal name


@dataclass
class FrameFieldSpec:
    """Dict-shaped frame riding an already-checked channel. The
    tag+arity pass above sees ``("rview", view)`` as a healthy 2-tuple
    no matter what keys ``view`` carries, so field drift — a consumer
    reading a key no producer writes (silently None forever), or a
    producer shipping a key nothing reads (dead payload) — needs its
    own producer/consumer table."""
    name: str
    producers: Sequence[FrameVarSpec]
    consumers: Sequence[FrameVarSpec]
    #: keys consumers may read that no modeled producer writes
    #: (injected in transit by relays the table does not model)
    assume_produced: Set[str] = field(default_factory=set)
    #: keys producers write that no modeled consumer reads
    assume_read: Set[str] = field(default_factory=set)


#: dict-shaped frame field tables (file paths relative to the package root)
DEFAULT_FRAME_FIELDS: List[FrameFieldSpec] = [
    FrameFieldSpec(
        # the head's resource-view push (head_to_daemon "resview"
        # frames) and the daemons' peer gossip re-share of the same
        # dict (peer_actor_lane "rview" frames). The "wm" row is the
        # QoS top-spilled-tier watermark: written only when the plane
        # is on (qos=False frames stay byte-for-byte pre-QoS), read by
        # local admission so a low-tier nested task cannot locally
        # dispatch past a spilled high-tier one.
        name="resview",
        producers=[
            FrameVarSpec("_private/worker.py",
                         "Worker._resview_push_loop", "view"),
            # gossip re-shares the head's dict verbatim plus an origin
            # stamp for ghost-view eviction
            FrameVarSpec("_private/runtime/node_daemon.py",
                         "NodeDaemon._gossip_loop", "view"),
        ],
        consumers=[
            FrameVarSpec("_private/runtime/node_daemon.py",
                         "NodeDaemon._apply_resview", "view"),
            FrameVarSpec("_private/runtime/node_daemon.py",
                         "NodeDaemon._maybe_local_submit", "view"),
            FrameVarSpec("_private/runtime/node_daemon.py",
                         "NodeDaemon._gossip_loop", "view"),
            # p2p caller side reads the node index off the stored view
            # through the attribute receiver (self._resview)
            FrameVarSpec("_private/runtime/node_daemon.py",
                         "NodeDaemon._maybe_p2p_call", "_resview"),
        ],
    ),
]


@dataclass
class OpChannelSpec:
    """ray:// op-mode channel: ``_rpc("op", *payload)`` client calls
    against ``_op_<name>(self, session, *payload)`` server methods."""
    name: str
    client_file: str
    rpc_callees: Sequence[str]
    server_file: str
    server_class: str
    op_prefix: str = "_op_"
    assume_sent: Set[str] = field(default_factory=set)


DEFAULT_OP_CHANNELS: List[OpChannelSpec] = [
    OpChannelSpec(
        name="ray_client",
        client_file="_private/client.py",
        rpc_callees=("_rpc", "_send_oneway"),
        server_file="_private/client.py",
        server_class="ClientServer",
    ),
]


# ---------------------------------------------------------------------------
# send-site extraction
# ---------------------------------------------------------------------------

def _callee_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def collect_sends(tree: ast.Module,
                  specs: Sequence[SendSpec]) -> Dict[str, Set[int]]:
    """tag -> set of sent arities, over one file's send specs."""
    by_callee = {s.callee: s for s in specs}
    out: Dict[str, Set[int]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        spec = by_callee.get(_callee_name(node))
        if spec is None:
            continue
        first = node.args[0]
        if spec.style == "first_arg_tag":
            if (isinstance(first, ast.Constant)
                    and isinstance(first.value, str)):
                out.setdefault(first.value, set()).add(spec.fixed_arity)
            continue
        if (isinstance(first, ast.Tuple) and first.elts
                and isinstance(first.elts[0], ast.Constant)
                and isinstance(first.elts[0].value, str)):
            out.setdefault(first.elts[0].value, set()).add(
                len(first.elts) + spec.delta)
    return out


# ---------------------------------------------------------------------------
# recv-dispatch extraction
# ---------------------------------------------------------------------------

@dataclass
class Handled:
    max_index: int = 0
    unpack_lens: Set[int] = field(default_factory=set)
    line: int = 0


def _recv_msg_vars(fn: ast.FunctionDef) -> Set[str]:
    """Names bound from a ``*.recv*()`` call, plus a ``msg`` parameter
    (wrapper dispatchers like _handle_worker_msg take the tuple as an
    argument)."""
    out: Set[str] = set()
    for arg in fn.args.args:
        if arg.arg in ("msg", "wmsg"):
            out.add(arg.arg)
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)):
            name = _callee_name(node.value)
            if name and "recv" in name:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        out.add(tgt.id)
        # msg = self._inbox.pop(0) — the worker run-loop's second source
        if (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)
                and _callee_name(node.value) == "pop"):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "msg":
                    out.add(tgt.id)
    return out


def _kind_vars(fn: ast.FunctionDef, msg_vars: Set[str]) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Subscript)
                and isinstance(node.value.value, ast.Name)
                and node.value.value.id in msg_vars
                and isinstance(node.value.slice, ast.Constant)
                and node.value.slice.value == 0):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
    return out


def _branch_tags(test: ast.AST, msg_vars: Set[str],
                 kind_vars: Set[str]) -> List[str]:
    """Tags selected by an if-test, [] when the test is not a tag
    dispatch."""
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.Or):
        tags: List[str] = []
        for v in test.values:
            tags.extend(_branch_tags(v, msg_vars, kind_vars))
        return tags
    if not isinstance(test, ast.Compare) or len(test.ops) != 1:
        return []
    left = test.left
    is_kind = (isinstance(left, ast.Name) and left.id in kind_vars) or (
        isinstance(left, ast.Subscript)
        and isinstance(left.value, ast.Name)
        and left.value.id in msg_vars
        and isinstance(left.slice, ast.Constant)
        and left.slice.value == 0)
    if not is_kind:
        return []
    op = test.ops[0]
    comp = test.comparators[0]
    if isinstance(op, ast.Eq):
        if isinstance(comp, ast.Constant) and isinstance(comp.value, str):
            return [comp.value]
    elif isinstance(op, ast.In) and isinstance(comp, (ast.Tuple,
                                                      ast.List,
                                                      ast.Set)):
        return [e.value for e in comp.elts
                if isinstance(e, ast.Constant)
                and isinstance(e.value, str)]
    return []


def _max_msg_index(body: Sequence[ast.stmt],
                   msg_vars: Set[str]) -> Tuple[int, Set[int]]:
    """Deepest constant integer subscript into a message var inside a
    branch body, plus any exact tuple-unpack lengths."""
    max_idx = 0
    unpacks: Set[int] = set()
    for stmt in body:
        for node in ast.walk(stmt):
            if (isinstance(node, ast.Subscript)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in msg_vars
                    and isinstance(node.slice, ast.Constant)
                    and isinstance(node.slice.value, int)):
                max_idx = max(max_idx, node.slice.value)
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in msg_vars):
                for tgt in node.targets:
                    if isinstance(tgt, (ast.Tuple, ast.List)) and not any(
                            isinstance(e, ast.Starred) for e in tgt.elts):
                        unpacks.add(len(tgt.elts))
    return max_idx, unpacks


def collect_handlers(tree: ast.Module,
                     spec: RecvSpec) -> Dict[str, Handled]:
    out: Dict[str, Handled] = {}
    for fn in find_function(tree, spec.func):
        msg_vars = _recv_msg_vars(fn)
        if not msg_vars:
            continue
        kind_vars = _kind_vars(fn, msg_vars)
        for node in ast.walk(fn):
            if not isinstance(node, ast.If):
                continue
            tags = _branch_tags(node.test, msg_vars, kind_vars)
            if not tags:
                continue
            max_idx, unpacks = _max_msg_index(node.body, msg_vars)
            for tag in tags:
                h = out.setdefault(tag, Handled(line=node.lineno))
                h.max_index = max(h.max_index, max_idx)
                h.unpack_lens |= unpacks
    return out


# ---------------------------------------------------------------------------
# channel checking
# ---------------------------------------------------------------------------

def check_channel(channel: ChannelSpec, root: str,
                  make_finding) -> List:
    import os
    findings = []
    sent: Dict[str, Set[int]] = {}
    for spec in {s.file for s in channel.sends}:
        tree = parse_file(os.path.normpath(os.path.join(root, spec)))
        if tree is None:
            continue
        file_specs = [s for s in channel.sends if s.file == spec]
        for tag, arities in collect_sends(tree, file_specs).items():
            sent.setdefault(tag, set()).update(arities)
    handled: Dict[str, Handled] = {}
    for spec in channel.recvs:
        tree = parse_file(os.path.normpath(os.path.join(root, spec.file)))
        if tree is None:
            continue
        for tag, h in collect_handlers(tree, spec).items():
            cur = handled.setdefault(tag, Handled(line=h.line))
            cur.max_index = max(cur.max_index, h.max_index)
            cur.unpack_lens |= h.unpack_lens

    recv_file = channel.recvs[0].file if channel.recvs else ""
    for tag in sorted(set(sent) - set(handled) - channel.assume_handled):
        findings.append(make_finding(
            f"{PASS}:sent-unhandled:{channel.name}:{tag}",
            f"[{channel.name}] tag {tag!r} is sent but no recv-dispatch "
            f"branch handles it", recv_file, 0))
    for tag in sorted(set(handled) - set(sent) - channel.assume_sent):
        findings.append(make_finding(
            f"{PASS}:handled-unsent:{channel.name}:{tag}",
            f"[{channel.name}] dispatch branch for tag {tag!r} exists "
            f"but no send site produces it", recv_file,
            handled[tag].line))
    for tag in sorted(set(sent) & set(handled)):
        arities = sent[tag]
        h = handled[tag]
        if h.max_index >= max(arities):
            findings.append(make_finding(
                f"{PASS}:arity:{channel.name}:{tag}",
                f"[{channel.name}] branch for {tag!r} indexes "
                f"msg[{h.max_index}] but senders send at most "
                f"{max(arities)} elements", recv_file, h.line))
        for ln in sorted(h.unpack_lens):
            if ln not in arities:
                findings.append(make_finding(
                    f"{PASS}:arity:{channel.name}:{tag}:unpack{ln}",
                    f"[{channel.name}] branch for {tag!r} unpacks "
                    f"exactly {ln} elements but senders send "
                    f"{sorted(arities)}", recv_file, h.line))
    return findings


def _frame_var_matches(node: ast.AST, var: str) -> bool:
    return ((isinstance(node, ast.Name) and node.id == var)
            or (isinstance(node, ast.Attribute) and node.attr == var))


def collect_fields_produced(tree: ast.Module,
                            spec: FrameVarSpec) -> Set[str]:
    """String keys the function writes into its frame var: dict-literal
    assignments (``var = {"k": ...}``) and key stores
    (``var["k"] = ...``)."""
    out: Set[str] = set()
    for fn in find_function(tree, spec.func):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                if (_frame_var_matches(tgt, spec.var)
                        and isinstance(node.value, ast.Dict)):
                    out.update(k.value for k in node.value.keys
                               if isinstance(k, ast.Constant)
                               and isinstance(k.value, str))
                if (isinstance(tgt, ast.Subscript)
                        and _frame_var_matches(tgt.value, spec.var)
                        and isinstance(tgt.slice, ast.Constant)
                        and isinstance(tgt.slice.value, str)):
                    out.add(tgt.slice.value)
    return out


def collect_fields_read(tree: ast.Module,
                        spec: FrameVarSpec) -> Dict[str, int]:
    """key -> first line where the function reads it from the frame
    var, via ``var.get("k")`` or a ``var["k"]`` load."""
    out: Dict[str, int] = {}
    for fn in find_function(tree, spec.func):
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "get"
                    and _frame_var_matches(node.func.value, spec.var)
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                out.setdefault(node.args[0].value, node.lineno)
            if (isinstance(node, ast.Subscript)
                    and isinstance(node.ctx, ast.Load)
                    and _frame_var_matches(node.value, spec.var)
                    and isinstance(node.slice, ast.Constant)
                    and isinstance(node.slice.value, str)):
                out.setdefault(node.slice.value, node.lineno)
    return out


def check_frame_fields(table: FrameFieldSpec, root: str,
                       make_finding) -> List:
    import os
    findings = []
    produced: Set[str] = set()
    for spec in table.producers:
        tree = parse_file(os.path.normpath(os.path.join(root, spec.file)))
        if tree is None:
            continue
        produced |= collect_fields_produced(tree, spec)
    read: Dict[str, int] = {}
    read_file = table.consumers[0].file if table.consumers else ""
    for spec in table.consumers:
        tree = parse_file(os.path.normpath(os.path.join(root, spec.file)))
        if tree is None:
            continue
        for key, line in collect_fields_read(tree, spec).items():
            read.setdefault(key, line)
    if not produced or not read:
        return findings  # a moved/renamed function: nothing to compare
    for key in sorted(set(read) - produced - table.assume_produced):
        findings.append(make_finding(
            f"{PASS}:field-unproduced:{table.name}:{key}",
            f"[{table.name}] consumers read frame field {key!r} but no "
            f"producer writes it (silently None forever)", read_file,
            read[key]))
    for key in sorted(produced - set(read) - table.assume_read):
        findings.append(make_finding(
            f"{PASS}:field-unread:{table.name}:{key}",
            f"[{table.name}] producers ship frame field {key!r} but no "
            f"consumer reads it (dead payload)", read_file, 0))
    return findings


def check_op_channel(channel: OpChannelSpec, root: str,
                     make_finding) -> List:
    import os
    findings = []
    client_tree = parse_file(os.path.normpath(
        os.path.join(root, channel.client_file)))
    server_tree = parse_file(os.path.normpath(
        os.path.join(root, channel.server_file)))
    if client_tree is None or server_tree is None:
        return findings

    #: op -> set of payload-arg counts at call sites
    sent: Dict[str, Set[int]] = {}
    callees = set(channel.rpc_callees)
    for node in ast.walk(client_tree):
        if (isinstance(node, ast.Call) and node.args
                and _callee_name(node) in callees
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            sent.setdefault(node.args[0].value, set()).add(
                len(node.args) - 1)

    #: op -> (required_payload, max_payload or None for *args, line)
    defined: Dict[str, Tuple[int, Optional[int], int]] = {}
    for node in server_tree.body:
        if not (isinstance(node, ast.ClassDef)
                and node.name == channel.server_class):
            continue
        for sub in node.body:
            if (isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and sub.name.startswith(channel.op_prefix)):
                op = sub.name[len(channel.op_prefix):]
                # params minus (self, session)
                n = len(sub.args.args) - 2
                required = n - len(sub.args.defaults)
                maximum = None if sub.args.vararg else n
                defined[op] = (required, maximum, sub.lineno)

    for op in sorted(set(sent) - set(defined)):
        findings.append(make_finding(
            f"{PASS}:op-undefined:{channel.name}:{op}",
            f"[{channel.name}] client sends op {op!r} but the server "
            f"defines no {channel.op_prefix}{op}", channel.server_file,
            0))
    for op in sorted(set(defined) - set(sent) - channel.assume_sent):
        findings.append(make_finding(
            f"{PASS}:op-unsent:{channel.name}:{op}",
            f"[{channel.name}] server defines "
            f"{channel.op_prefix}{op} but the client never sends it",
            channel.server_file, defined[op][2]))
    for op in sorted(set(sent) & set(defined)):
        required, maximum, line = defined[op]
        for n in sorted(sent[op]):
            if n < required or (maximum is not None and n > maximum):
                findings.append(make_finding(
                    f"{PASS}:op-arity:{channel.name}:{op}:{n}",
                    f"[{channel.name}] op {op!r} called with {n} "
                    f"payload args but {channel.op_prefix}{op} takes "
                    f"{required}..{maximum}", channel.server_file,
                    line))
    return findings


def analyze(root: str, make_finding,
            channels: Optional[Sequence[ChannelSpec]] = None,
            op_channels: Optional[Sequence[OpChannelSpec]] = None,
            frame_fields: Optional[Sequence[FrameFieldSpec]] = None
            ) -> List:
    findings = []
    for ch in (DEFAULT_CHANNELS if channels is None else channels):
        findings.extend(check_channel(ch, root, make_finding))
    for och in (DEFAULT_OP_CHANNELS if op_channels is None
                else op_channels):
        findings.extend(check_op_channel(och, root, make_finding))
    for ff in (DEFAULT_FRAME_FIELDS if frame_fields is None
               else frame_fields):
        findings.extend(check_frame_fields(ff, root, make_finding))
    return findings
