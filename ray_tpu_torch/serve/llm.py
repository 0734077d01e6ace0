"""LLM serving deployments: monolithic and disaggregated pools.

Reference surface: the reference framework's LLM serving integration
(serve + vLLM-style engine: each replica hosts one engine; requests
stream through the router into the engine's continuous-batching loop).
Here each Serve replica owns an InferenceEngine
(models/inference.py — paged KV cache + the hand-written CUDA paged
attention kernel on the card), so
router-level scaling (replicas) composes with engine-level batching
(slots): two independent throughput axes, as in the reference stack.

    import ray_tpu_torch as ray
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import build_llm_app

    app = build_llm_app(params, model_cfg, engine_cfg)   # on the card
    handle = serve.run(app)
    tokens = ray.get(handle.generate.remote([1, 2, 3], 16))

Every deployment here takes ``device`` and hands it to its engine:
None means the CUDA device (and raises on a host without one), "cpu"
runs the engine's plain PyTorch path (the tests). A replica never
falls back to the CPU. In thread mode the replicas receive the
caller's parameter tensors themselves, so bf16 weights already on the
card are shared by every replica, not copied.

Traffic scale disaggregates the pools (run_disagg_llm): PREFILL
replicas run the prompt pass and export the session's KV as host
tensors through the object plane (thread mode: ``put`` keeps the
tensors by reference); DECODE replicas upload them straight into
their continuous batch. TTFT becomes
`prefill + one page handoff` instead of queueing behind long decodes,
the first token streams to the client straight off the handoff, and
the router's KV-page directory routes follow-up turns back to the
replica already holding the session's KV (serve/core.py,
cache-affinity routing). A mid-stream decode-replica loss RESUMES:
greedy decoding is deterministic, so re-prefilling prompt + the
already-delivered tokens continues the stream bit-identically with
zero double-delivered tokens.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import ray_tpu_torch
from ray_tpu_torch import exceptions as rex
from ray_tpu_torch.models.inference import InferenceConfig, InferenceEngine
from ray_tpu_torch.serve import core
from ray_tpu_torch.serve.core import Application, AutoscalingConfig, deployment


@deployment(name="llm")
class LLMDeployment:
    """One engine per replica; generate() joins the replica's
    continuous batch and returns the generated token list."""

    def __init__(self, params: Any, model_cfg: Any,
                 engine_cfg: Optional[InferenceConfig] = None,
                 device=None):
        self._engine = InferenceEngine(params, model_cfg,
                                       engine_cfg or InferenceConfig(),
                                       device=device)
        self._streams: Dict[str, Any] = {}

    def generate(self, prompt: Sequence[int],
                 max_new_tokens: Optional[int] = None,
                 timeout: float = 600.0) -> List[int]:
        """timeout bounds queue-wait + generation on this replica (a
        full continuous batch admits the request only when a slot
        frees)."""
        return self._engine.generate(list(prompt), max_new_tokens,
                                     timeout=timeout)

    # -- token streaming ------------------------------------------------
    # Across the replica boundary (actor calls return by value), the
    # stream surfaces as a poll protocol: start_stream() opens one,
    # next_tokens() drains whatever has arrived since the last poll —
    # the SSE-emission shape of the reference's serve.llm streaming.
    # In-process callers can take the engine's TokenStream directly.

    _STREAM_TTL_S = 600.0

    def _sweep_streams(self) -> None:
        """Drop streams nobody has polled within the TTL — a client
        that started a stream and disconnected must not pin its
        TokenStream (and buffered tokens) for the replica's lifetime."""
        now = time.monotonic()
        for sid, (stream, last) in list(self._streams.items()):
            if now - last > self._STREAM_TTL_S:
                self._streams.pop(sid, None)

    def _register_stream(self, stream) -> str:
        import uuid

        sid = uuid.uuid4().hex
        self._streams[sid] = (stream, time.monotonic())
        return sid

    def start_stream(self, prompt: Sequence[int],
                     max_new_tokens: Optional[int] = None) -> str:
        self._sweep_streams()
        stream = self._engine.submit_stream(list(prompt), max_new_tokens)
        return self._register_stream(stream)

    def next_tokens(self, stream_id: str,
                    timeout: float = 60.0) -> Dict[str, Any]:
        """Block until at least one token (or completion) is available,
        then drain everything currently buffered. Returns
        {"tokens": [...], "done": bool}."""
        import queue as _q

        # sweep here too: a poll-only workload (clients that joined
        # streams started elsewhere) must still evict other clients'
        # abandoned streams
        self._sweep_streams()
        entry = self._streams.get(stream_id)
        if entry is None:
            raise KeyError(f"unknown stream {stream_id!r}")
        stream = entry[0]
        self._streams[stream_id] = (stream, time.monotonic())
        from ray_tpu_torch.models.inference import _STREAM_END

        tokens: List[int] = []
        done = False
        try:
            item = stream._q.get(timeout=timeout)
            while True:
                if isinstance(item, BaseException):
                    # a dead stream must not keep polling as alive
                    self._streams.pop(stream_id, None)
                    raise item
                if item is None or item is _STREAM_END:
                    done = True
                    break
                tokens.extend(item)
                item = stream._q.get_nowait()
        except _q.Empty:
            pass
        if done:
            self._streams.pop(stream_id, None)
        return {"tokens": tokens, "done": done}

    def engine_stats(self) -> Dict[str, Any]:
        return self._engine.stats()

    def shutdown(self) -> None:
        """Explicit retirement hook: serve core calls this (via the
        replica's shutdown_replica) before killing a retired replica —
        the engine loop and its in-flight futures release
        deterministically instead of riding __del__."""
        self._streams.clear()
        self._engine.shutdown()

    def __del__(self):
        # backstop only; the explicit shutdown() hook is the real path
        try:
            self._engine.shutdown()
        except Exception:
            pass


def build_llm_app(params: Any, model_cfg: Any,
                  engine_cfg: Optional[InferenceConfig] = None,
                  num_replicas: int = 1, device=None) -> Application:
    return LLMDeployment.options(num_replicas=num_replicas).bind(
        params, model_cfg, engine_cfg, device)


# ----------------------------------------------------------------------
# disaggregated prefill / decode pools
# ----------------------------------------------------------------------

@deployment(name="llm_prefill")
class PrefillDeployment:
    """Prompt passes only. prefill() exports the session's KV into the
    object plane and returns a SMALL handoff record — the bulky K/V
    host tensors ride the object store (thread mode: by reference),
    never the router."""

    def __init__(self, params: Any, model_cfg: Any,
                 engine_cfg: Optional[InferenceConfig] = None,
                 device=None):
        self._engine = InferenceEngine(params, model_cfg,
                                       engine_cfg or InferenceConfig(),
                                       mode="prefill", device=device)
        self.prefills = 0

    def prefill(self, prompt: Sequence[int],
                max_new_tokens: Optional[int] = None) -> Dict[str, Any]:
        out = self._engine.prefill_export(list(prompt), max_new_tokens)
        self.prefills += 1
        kv_ref = ray_tpu_torch.put({"k": out.pop("k"), "v": out.pop("v")})
        out["kv_ref"] = kv_ref
        return out

    def engine_stats(self) -> Dict[str, Any]:
        stats = self._engine.stats()
        stats["prefills"] = self.prefills
        return stats

    def shutdown(self) -> None:
        self._engine.shutdown()


@deployment(name="llm_decode")
class DecodeDeployment(LLMDeployment._cls):  # the undecorated class
    """Continuous batch only: streams join via imported KV handoffs.
    A bounded per-session KV cache backs cache-affinity routing — a
    follow-up turn that re-sends a cached session's exact prompt
    replays from here with ZERO prefill work and zero page transfer."""

    def __init__(self, params: Any, model_cfg: Any,
                 engine_cfg: Optional[InferenceConfig] = None,
                 device=None):
        import collections

        self._engine = InferenceEngine(params, model_cfg,
                                       engine_cfg or InferenceConfig(),
                                       mode="decode", device=device)
        self._streams: Dict[str, Any] = {}
        self._kv_cache: "collections.OrderedDict" = \
            collections.OrderedDict()
        self.kv_imports = 0
        self.cached_replays = 0

    def _cache_kv(self, session_id: str, kv: Dict[str, Any]) -> None:
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        try:
            cap = int(GLOBAL_CONFIG.serve_kv_cache_sessions)
        except Exception:
            cap = 16
        if cap <= 0:
            return
        self._kv_cache[session_id] = kv
        self._kv_cache.move_to_end(session_id)
        while len(self._kv_cache) > cap:
            self._kv_cache.popitem(last=False)

    def start_stream_from_kv(self, handoff: Dict[str, Any],
                             max_new_tokens: Optional[int] = None,
                             emit_first: bool = True,
                             session_id: Optional[str] = None) -> str:
        """Join the batch from a prefill handoff. ``emit_first=False``
        when the ingress driver already streamed the first token
        straight off the handoff (the disaggregated TTFT path)."""
        self._sweep_streams()
        kv = dict(handoff)
        ref = kv.pop("kv_ref", None)
        if ref is not None:
            kv.update(ray_tpu_torch.get(ref, timeout=60.0))
        self.kv_imports += 1
        stream = self._engine.submit_stream_from_kv(
            kv, max_new_tokens, emit_first=emit_first)
        if session_id is not None:
            self._cache_kv(session_id, kv)
        return self._register_stream(stream)

    def start_stream_cached(self, session_id: str, prompt: Sequence[int],
                            max_new_tokens: Optional[int] = None
                            ) -> Optional[Dict[str, Any]]:
        """Exact-prompt session replay (regeneration / retry): when the
        session's cached KV matches the prompt, the stream opens with
        no prefill pool involvement at all. Returns {"sid", "max_new"}
        or None on a cache miss (caller falls back to the prefill
        pool, keeping the session pinned here for page locality)."""
        self._sweep_streams()
        entry = self._kv_cache.get(session_id)
        if entry is None or entry.get("prompt") != list(prompt):
            return None
        self._kv_cache.move_to_end(session_id)
        resolved = (max_new_tokens if max_new_tokens is not None
                    else entry.get("max_new")
                    or self._engine.cfg.max_new_tokens)
        stream = self._engine.submit_stream_from_kv(
            entry, resolved, emit_first=True)
        self.cached_replays += 1
        return {"sid": self._register_stream(stream),
                "max_new": int(resolved)}

    def engine_stats(self) -> Dict[str, Any]:
        stats = self._engine.stats()
        stats["kv_imports"] = self.kv_imports
        stats["cached_replays"] = self.cached_replays
        stats["kv_cache_sessions"] = len(self._kv_cache)
        return stats


def disagg_stream_frames(prompt: Sequence[int],
                         max_new_tokens: Optional[int] = None,
                         session_id: Optional[str] = None,
                         prefill_name: str = "llm_prefill",
                         decode_name: str = "llm_decode",
                         start_timeout: float = 120.0,
                         poll_timeout: float = 120.0,
                         max_resumes: int = 3):
    """Token-burst frames over the disaggregated pools — the split-pool
    sibling of core._sticky_stream_frames, and the serving plane's
    SECOND admission point.

    Path: shed-or-admit -> cache-affinity route -> (cached replay |
    prefill-pool export -> first token to the client straight off the
    handoff -> decode-pool import) -> sticky polls. A decode replica
    dying mid-stream RESUMES: re-prefill prompt + delivered tokens for
    the remaining budget on a fresh replica — greedy determinism makes
    the continuation bit-identical, and only undelivered tokens are
    ever yielded."""
    prompt = list(prompt)
    pre_state = core.get_app_handle(prefill_name)._state()
    dec_state = core.get_app_handle(decode_name)._state()
    core.check_admission(dec_state)
    core.metrics.count("streams")
    t0 = time.monotonic()

    status, affine_replica, _ = core.kv_directory.lookup(
        session_id, dec_state)
    if status == "hit":
        core.metrics.count("affinity_hit")
    elif status in ("promoted", "gone") or (
            session_id is not None
            and core.kv_directory.known(session_id)):
        # a first-ever turn is not a follow-up: it cannot hit, so it
        # does not count against the affinity hit-rate
        core.metrics.count("affinity_miss")

    delivered: List[int] = []
    # total tokens the CLIENT gets; resolved by the first open when
    # the caller left it None
    total: Optional[int] = (int(max_new_tokens)
                            if max_new_tokens is not None else None)
    token: Optional[str] = None  # sticky session of the OPEN stream
    sid: Optional[str] = None
    resumes = 0

    def _record_directory(kv_ref) -> None:
        if session_id is not None and token is not None:
            replica = dec_state.sticky_replica(token)
            if replica is not None:
                core.kv_directory.record(session_id, decode_name,
                                         replica, kv_ref)

    try:
        # -- open on the affinity replica from its session KV cache --
        if status == "hit":
            try:
                ref, token = dec_state.submit_sticky(
                    "start_stream_cached",
                    (session_id, prompt, max_new_tokens), {},
                    prefer=affine_replica)
                opened = ray_tpu_torch.get(ref, timeout=start_timeout)
            except (rex.RayTpuError, rex.ActorError):
                opened = None
                if token is not None:
                    dec_state.end_sticky(token)
                    token = None
            if opened is not None:
                sid = opened["sid"]
                total = int(opened["max_new"])

        while True:
            try:
                if sid is None:
                    # -- prefill-pool path (fresh start or resume) --
                    want = (None if total is None
                            else total - len(delivered))
                    handoff = ray_tpu_torch.get(
                        pre_state.submit(
                            "prefill", (prompt + delivered, want), {}),
                        timeout=start_timeout)
                    if total is None:
                        total = int(handoff["max_new"])
                    first = int(handoff["first_token"])
                    core.metrics.count("kv_bytes",
                                       int(handoff.get("kv_bytes", 0)))
                    # the client's first token comes straight off the
                    # handoff — TTFT never waits for a decode slot
                    if not delivered:
                        core.metrics.record_ttft(time.monotonic() - t0)
                    delivered.append(first)
                    done = len(delivered) >= total
                    yield {"tokens": [first], "done": done}
                    if done:
                        return
                    # the stream's own budget INCLUDES the handoff
                    # token (emit_first=False: it is already with the
                    # client, the stream yields only what follows)
                    open_args = ("start_stream_from_kv",
                                 (handoff, int(handoff["max_new"]),
                                  False, session_id), {})
                    if token is not None:
                        ref, _ = dec_state.submit_sticky(
                            *open_args, session=token)
                    else:
                        ref, token = dec_state.submit_sticky(
                            *open_args, prefer=affine_replica)
                    sid = ray_tpu_torch.get(ref, timeout=start_timeout)
                    _record_directory(handoff.get("kv_ref"))

                # -- sticky poll loop -----------------------------------
                while True:
                    ref, _ = dec_state.submit_sticky(
                        "next_tokens", (sid,), {}, session=token)
                    r = ray_tpu_torch.get(ref, timeout=poll_timeout)
                    if not delivered and r.get("tokens"):
                        core.metrics.record_ttft(time.monotonic() - t0)
                    delivered.extend(r.get("tokens") or ())
                    yield r
                    if r.get("done"):
                        return
            except (rex.RayTpuError, rex.ActorError):
                # mid-stream replica loss: resume via re-prefill of
                # prompt + delivered (session resumption — greedy
                # determinism continues bit-identically, so the client
                # never sees a duplicated or divergent token)
                resumes += 1
                if resumes > max_resumes:
                    raise
                core.metrics.count("resumed")
                if token is not None:
                    dec_state.end_sticky(token)
                token = None
                sid = None
                affine_replica = None
                if session_id is not None:
                    core.kv_directory.drop(session_id)
                if total is not None and len(delivered) >= total:
                    # every token was delivered; only the terminal
                    # frame was lost with the replica
                    yield {"tokens": [], "done": True}
                    return
                time.sleep(0.1 * resumes)  # let the respawn land
    finally:
        if token is not None:
            dec_state.end_sticky(token)


class DisaggLLMHandle:
    """Driver-side facade over the two pools (the disaggregated
    sibling of the ingress DeploymentHandle)."""

    def __init__(self, prefill_name: str = "llm_prefill",
                 decode_name: str = "llm_decode"):
        self.prefill_name = prefill_name
        self.decode_name = decode_name

    def stream_frames(self, prompt: Sequence[int],
                      max_new_tokens: Optional[int] = None,
                      session_id: Optional[str] = None, **kw):
        return disagg_stream_frames(
            prompt, max_new_tokens, session_id=session_id,
            prefill_name=self.prefill_name,
            decode_name=self.decode_name, **kw)

    def generate(self, prompt: Sequence[int],
                 max_new_tokens: Optional[int] = None,
                 session_id: Optional[str] = None, **kw) -> List[int]:
        out: List[int] = []
        for frame in self.stream_frames(prompt, max_new_tokens,
                                        session_id=session_id, **kw):
            out.extend(frame.get("tokens") or ())
        return out


def run_disagg_llm(params: Any, model_cfg: Any,
                   engine_cfg: Optional[InferenceConfig] = None,
                   prefill_replicas: int = 1, decode_replicas: int = 1,
                   prefill_autoscaling: Optional[AutoscalingConfig] = None,
                   decode_autoscaling: Optional[AutoscalingConfig] = None,
                   name_prefix: str = "llm",
                   device=None) -> DisaggLLMHandle:
    """Deploy the split pools and register the stream driver under
    ``{name_prefix}`` so POST /{name_prefix}/stream (SSE) and gRPC
    PredictStream serve the disaggregated path. The pools autoscale
    INDEPENDENTLY: pass metric="ttft" autoscaling for the prefill pool
    (TTFT pressure means the prompt pass is the bottleneck) and
    metric="sessions" for the decode pool (open streams hold batch
    slots between polls)."""
    prefill_name = f"{name_prefix}_prefill"
    decode_name = f"{name_prefix}_decode"
    core.run(PrefillDeployment.options(
        name=prefill_name, num_replicas=prefill_replicas,
        autoscaling_config=prefill_autoscaling).bind(
            params, model_cfg, engine_cfg, device))
    core.run(DecodeDeployment.options(
        name=decode_name, num_replicas=decode_replicas,
        autoscaling_config=decode_autoscaling).bind(
            params, model_cfg, engine_cfg, device))
    handle = DisaggLLMHandle(prefill_name, decode_name)
    core.register_stream_driver(
        name_prefix,
        lambda prompt, max_new: handle.stream_frames(prompt, max_new))
    return handle
