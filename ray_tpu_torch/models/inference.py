"""LLM inference engine: paged KV cache + continuous batching, in PyTorch.

Counterpart of ``ray_tpu/models/inference.py``. Fixed decode slots share
one paged KV cache; each sequence owns a list of pages, and all
raggedness lives in page tables and sequence lengths. Every decode step
runs the paged-attention kernel (ops/paged_attention.py, CUDA on the
card) once per layer. New requests join between decode chunks as
finished ones free their slots.

PyTorch runs eagerly, so the reference's jitted programs become plain
calls and its donated buffers become IN-PLACE updates: the KV pages and
the device-resident token feedback vector are written in place, and the
functions that do so say so. ``decode_chunk``'s ``lax.scan`` is a Python
loop whose argmax feedback stays on the device.

Weights are the flagship transformer's (models/transformer.py), as a
flat "/"-keyed dict with flax's layouts (``params_from_jax`` or
``init_params``).

    engine = InferenceEngine(params, model_cfg, InferenceConfig(...))
    fut = engine.submit([1, 2, 3], max_new_tokens=16)
    tokens = fut.result()

The engine runs on the CUDA device unless ``device`` names another; with
no CUDA device and no ``device`` it raises rather than run on the CPU.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import queue
import threading
from concurrent.futures import Future
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models.transformer import TransformerConfig, _rms_norm, _rope
from ray_tpu_torch.ops.paged_attention import (append_token_kv,
                                               paged_attention,
                                               write_prefill_kv)

Params = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    batch_size: int = 4            # concurrent decode slots
    page_size: int = 16
    max_pages_per_seq: int = 16    # max context = page_size * this
    num_pages: int = 128           # total physical pages (all slots)
    prefill_buckets: Tuple[int, ...] = (16, 32, 64, 128)
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # max greedy steps per decode chunk; admission happens between
    # chunks. Idle slots' dummy appends land in the reserved parking
    # page, so chunks may exceed page_size.
    decode_chunk: int = 32

    @property
    def max_context(self) -> int:
        return self.page_size * self.max_pages_per_seq


# ----------------------------------------------------------------------
# functional forward over the flat param dict
# ----------------------------------------------------------------------

_rms = _rms_norm


def _sub(params: Params, prefix: str) -> Dict[str, torch.Tensor]:
    """The params under ``prefix/``, keyed relative to it."""
    pre = prefix + "/"
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def _mlp(p: Params, x, dtype):
    h = (F.silu(x @ p["MLP_0/w_gate"].to(dtype))
         * (x @ p["MLP_0/w_up"].to(dtype)))
    return h @ p["MLP_0/w_down"].to(dtype)


def _prefill_layer(p: Params, cfg: TransformerConfig, x, positions):
    """Full causal attention for one layer over [N,S,Dm] (plain einsum, no
    kernel, as the reference); returns (x_out, k [N,S,KV,D],
    v [N,S,KV,D])."""
    dt = cfg.dtype
    h = _rms(x, p["RMSNorm_0/scale"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, p["Attention_0/wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", h, p["Attention_0/wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", h, p["Attention_0/wv"].to(dt))
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    rep = cfg.n_heads // cfg.n_kv_heads
    kr = torch.repeat_interleave(k, rep, dim=2)
    vr = torch.repeat_interleave(v, rep, dim=2)
    s = x.shape[1]
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                 device=x.device))[None, None]
    scores = torch.einsum("bshk,bthk->bhst", q, kr) / math.sqrt(cfg.head_dim)
    scores = scores.to(torch.float32).masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(dt)
    attn = torch.einsum("bhst,bthk->bshk", probs, vr)
    x = x + torch.einsum("bshk,hkd->bsd", attn, p["Attention_0/wo"].to(dt))
    x = x + _mlp(p, _rms(x, p["RMSNorm_1/scale"], cfg.norm_eps), dt)
    return x, k, v


def _decode_layer(p: Params, cfg: TransformerConfig, x, positions, k_pages,
                  v_pages, page_table, seq_lens):
    """Single-token decode for one layer over [B,Dm] against the paged
    cache. Appends this token's K/V to ``k_pages``/``v_pages`` IN PLACE.
    seq_lens = cache length BEFORE the token (int32). Returns x_out."""
    dt = cfg.dtype
    h = _rms(x, p["RMSNorm_0/scale"], cfg.norm_eps)
    q = torch.einsum("bd,dhk->bhk", h, p["Attention_0/wq"].to(dt))
    k = torch.einsum("bd,dhk->bhk", h, p["Attention_0/wk"].to(dt))
    v = torch.einsum("bd,dhk->bhk", h, p["Attention_0/wv"].to(dt))
    # rope over a length-1 "sequence" per slot
    q = _rope(q[:, None], positions[:, None], cfg.rope_theta)[:, 0]
    k = _rope(k[:, None], positions[:, None], cfg.rope_theta)[:, 0]
    append_token_kv(k_pages, v_pages, k, v, page_table, seq_lens)
    out = paged_attention(q, k_pages, v_pages, page_table, seq_lens + 1)
    x = x + torch.einsum("bhk,hkd->bd", out.to(dt),
                         p["Attention_0/wo"].to(dt))
    x = x + _mlp(p, _rms(x, p["RMSNorm_1/scale"], cfg.norm_eps), dt)
    return x


def prefill_batch(params: Params, cfg: TransformerConfig,
                  tokens: torch.Tensor):
    """tokens [N,S] (padded to a bucket) -> (logits [N,S,V] f32,
    k_seq/v_seq [L,N,S,KV,D]) — N prompts prefill in one pass."""
    embed = params["embedding"].to(cfg.dtype)
    x = embed[tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, k, v = _prefill_layer(_sub(params, f"layer_{i}"), cfg, x,
                                 positions)
        ks.append(k)
        vs.append(v)
    x = _rms(x, params["final_norm/scale"], cfg.norm_eps)
    logits = torch.einsum("bsd,vd->bsv", x, embed)
    return logits.to(torch.float32), torch.stack(ks), torch.stack(vs)


def prefill(params: Params, cfg: TransformerConfig, tokens: torch.Tensor):
    """tokens [1,S] (padded to a bucket) -> (logits [S,V] f32,
    k_seq/v_seq [L,S,KV,D])."""
    logits, ks, vs = prefill_batch(params, cfg, tokens)
    return logits[0], ks[:, 0], vs[:, 0]


def decode_step(params: Params, cfg: TransformerConfig,
                tokens: torch.Tensor, k_pages: Sequence[torch.Tensor],
                v_pages: Sequence[torch.Tensor], page_table: torch.Tensor,
                seq_lens: torch.Tensor) -> torch.Tensor:
    """One continuous-batching step: tokens [B] (last emitted or last
    prompt token per slot), cache = per-layer sequences of [P,KV,page,D]
    tensors, each updated IN PLACE with this token's K/V. page_table
    [B,MP] and seq_lens [B] are int32. Returns next_logits [B,V] f32."""
    embed = params["embedding"].to(cfg.dtype)
    x = embed[tokens]                             # [B, Dm]
    positions = seq_lens                          # this token's position
    for i in range(cfg.n_layers):
        x = _decode_layer(_sub(params, f"layer_{i}"), cfg, x, positions,
                          k_pages[i], v_pages[i], page_table, seq_lens)
    x = _rms(x, params["final_norm/scale"], cfg.norm_eps)
    logits = torch.einsum("bd,vd->bv", x, embed)
    return logits.to(torch.float32)


def decode_chunk(params: Params, cfg: TransformerConfig,
                 tokens: torch.Tensor, k_pages: Sequence[torch.Tensor],
                 v_pages: Sequence[torch.Tensor], page_table: torch.Tensor,
                 seq_lens: torch.Tensor, *, n_steps: int):
    """n_steps greedy decode steps with argmax feedback on the device.
    Returns (tokens [n_steps, B] int32, next_tokens [B], next_lens [B]),
    all device tensors, so chunks chain without a host round trip; the
    pages are updated in place. argmax takes the FIRST maximum on ties,
    as jnp.argmax does."""
    toks, lens, outs = tokens, seq_lens, []
    for _ in range(n_steps):
        logits = decode_step(params, cfg, toks, k_pages, v_pages,
                             page_table, lens)
        toks = torch.argmax(logits, dim=-1).to(torch.int32)
        outs.append(toks)
        lens = lens + 1
    return torch.stack(outs), toks, lens


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------

_STREAM_END = object()


class TokenStream:
    """Iterator over tokens as the engine produces them (per sync
    burst), plus the final-list future for callers that want both."""

    def __init__(self, future: Future):
        self._q: "queue.Queue" = queue.Queue()
        self.future = future

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is _STREAM_END:
                return
            if isinstance(item, BaseException):
                raise item
            yield from item  # one burst's new tokens

    def result(self, timeout: Optional[float] = None) -> List[int]:
        return self.future.result(timeout)


class _Request:
    __slots__ = ("prompt", "max_new", "future", "out", "emitted", "stream",
                 "streamed", "kv")

    def __init__(self, prompt: List[int], max_new: int):
        self.prompt = prompt
        self.max_new = max_new
        self.future: Future = Future()
        self.out: List[int] = []   # tokens synced to host
        self.emitted = 0           # tokens produced on device (>= len(out))
        self.stream: Optional[TokenStream] = None
        self.streamed = 0          # tokens already pushed to the stream
        # disaggregated handoff: (k [L,S,KV,D], v, first_token) host
        # tensors from a prefill engine's export; admission imports the
        # pages instead of running the prompt pass
        self.kv: Optional[Tuple[Any, Any, int]] = None


class _Slot:
    __slots__ = ("req", "pages", "seq_len")

    def __init__(self):
        self.req: Optional[_Request] = None
        self.pages: List[int] = []
        self.seq_len = 0


def _resolve_device(device) -> torch.device:
    """``None`` means the current CUDA device, and raises without one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "InferenceEngine runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "path on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class InferenceEngine:
    """Continuous-batching decode loop over a paged KV cache.

    ``mode`` disaggregates the engine for split-pool serving:

    - ``"both"`` (default): prompt passes and the continuous decode
      batch in one engine.
    - ``"prefill"``: prompt passes only. No paged cache, no loop thread;
      ``prefill_export`` runs the bucketed prompt pass synchronously and
      hands the K/V + first token to the caller.
    - ``"decode"``: the continuous batch only. Requests join via
      ``submit_stream_from_kv`` (imported K/V); plain ``submit`` is
      rejected so a misrouted prompt fails loudly.

    Every tensor lives on ``device`` (default: the CUDA device; raises if
    there is none). The loop thread allocates on that explicit device and
    never relies on the thread's current device.
    """

    def __init__(self, params: Params, model_cfg: TransformerConfig,
                 cfg: InferenceConfig = InferenceConfig(),
                 mode: str = "both", device=None):
        if mode not in ("both", "prefill", "decode"):
            raise ValueError(f"unknown engine mode {mode!r}")
        self.device = _resolve_device(device)
        # cast once to the compute dtype (the reference casts per use —
        # numerically the same); norm scales stay f32 as the reference
        # uses them uncast
        self.params = {
            k: v.to(device=self.device,
                    dtype=(torch.float32 if k.endswith("/scale")
                           else model_cfg.dtype))
            for k, v in params.items()}
        self.mcfg = model_cfg
        self.cfg = cfg
        self.mode = mode
        self.num_steps = 0        # decode chunks dispatched
        self.decode_steps = 0     # decode steps (sum of chunk sizes)
        self.max_concurrent = 0
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._lock = threading.Lock()
        self._shutdown = False
        if mode == "prefill":
            # prompt passes only: everything decode-shaped is absent
            self._slots: List[_Slot] = []
            self._free_pages: List[int] = []
            self._thread = None
            return
        L = model_cfg.n_layers
        KV, D = model_cfg.n_kv_heads, model_cfg.head_dim
        shape = (cfg.num_pages, KV, cfg.page_size, D)
        # per-layer page tensors, written in place by prefill, import and
        # every decode step
        self._k_pages = [torch.zeros(shape, dtype=model_cfg.dtype,
                                     device=self.device) for _ in range(L)]
        self._v_pages = [torch.zeros(shape, dtype=model_cfg.dtype,
                                     device=self.device) for _ in range(L)]
        # the LAST physical page is the parking page for idle decode
        # slots (their dummy K/V appends land there), never allocated
        self._free_pages = list(range(cfg.num_pages - 1))
        self._slots = [_Slot() for _ in range(cfg.batch_size)]
        self._wake = threading.Event()
        # decode chunk sizes 1, 2, 4, ... decode_chunk; the loop picks the
        # smallest chunk covering the tightest remaining budget
        self._chunk_sizes = []
        n = 1
        while n <= max(1, cfg.decode_chunk):
            self._chunk_sizes.append(n)
            n *= 2
        # device-resident token feedback vector [batch_size], updated in
        # place: admission writes each prefill's next token into it
        # without a host read
        self._dev_toks = torch.zeros(cfg.batch_size, dtype=torch.int32,
                                     device=self.device)
        # prefill next-tokens awaiting the next burst's combined fetch:
        # (device tensor [N], [(slot, row)])
        self._pending_firsts: List[Tuple[torch.Tensor,
                                         List[Tuple[_Slot, int]]]] = []
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ray_tpu_torch_llm_engine")
        self._thread.start()

    # -- API -----------------------------------------------------------
    def _validate(self, prompt: Sequence[int],
                  max_new_tokens: Optional[int]) -> int:
        if not prompt:
            raise ValueError("empty prompt")
        max_new = (self.cfg.max_new_tokens if max_new_tokens is None
                   else max_new_tokens)
        if max_new <= 0:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        if len(prompt) + max_new > self.cfg.max_context:
            raise ValueError(
                f"prompt({len(prompt)}) + max_new({max_new}) exceeds the "
                f"engine's max context {self.cfg.max_context}")
        if len(prompt) > max(self.cfg.prefill_buckets):
            raise ValueError(
                f"prompt longer than the largest prefill bucket "
                f"{max(self.cfg.prefill_buckets)}")
        return max_new

    def _check_mode(self, wants: str) -> None:
        if self.mode not in ("both", wants):
            raise RuntimeError(
                f"engine is in {self.mode!r} mode; this entry point "
                f"needs {wants!r}")

    def _bucket(self, plen: int) -> int:
        return next(b for b in sorted(self.cfg.prefill_buckets) if b >= plen)

    def _enqueue(self, req: _Request) -> None:
        self._queue.put(req)
        self._wake.set()

    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None) -> Future:
        """Returns a Future resolving to the GENERATED token list."""
        if self.mode != "both":
            raise RuntimeError(
                f"engine is in {self.mode!r} mode; plain submit needs "
                f"the monolithic engine (prefill_export / "
                f"submit_stream_from_kv are the split-pool entry points)")
        req = _Request(list(prompt), self._validate(prompt, max_new_tokens))
        self._enqueue(req)
        return req.future

    def submit_stream(self, prompt: Sequence[int],
                      max_new_tokens: Optional[int] = None) -> TokenStream:
        """Streaming variant: tokens arrive on the returned iterator as
        each device sync lands (burst granularity), ending at EOS /
        budget; .result() still yields the final list."""
        if self.mode != "both":
            raise RuntimeError(
                f"engine is in {self.mode!r} mode; plain submit_stream "
                f"needs the monolithic engine")
        req = _Request(list(prompt), self._validate(prompt, max_new_tokens))
        req.stream = TokenStream(req.future)
        self._enqueue(req)
        return req.stream

    # -- disaggregated prefill/decode handoff --------------------------
    @torch.no_grad()
    def prefill_export(self, prompt: Sequence[int],
                       max_new_tokens: Optional[int] = None
                       ) -> Dict[str, Any]:
        """Run the prompt pass and export the session's K/V as host
        tensors — the prefill-pool half of disaggregated serving.

        Returns ``{"prompt", "prompt_len", "first_token", "k", "v",
        "kv_bytes", "max_new"}`` where k/v are CPU tensors [L, prompt_len,
        KV, D] in the model dtype (page-layout-free: the importing engine
        writes them into ITS pages). The first token is the argmax at the
        last prompt position."""
        self._check_mode("prefill")
        max_new = self._validate(prompt, max_new_tokens)
        plen = len(prompt)
        toks = torch.zeros((1, self._bucket(plen)), dtype=torch.int32)
        toks[0, :plen] = torch.as_tensor(list(prompt), dtype=torch.int32)
        logits, k_seq, v_seq = prefill(self.params, self.mcfg,
                                       toks.to(self.device))
        first = int(torch.argmax(logits[plen - 1]))
        k = k_seq[:, :plen].cpu()
        v = v_seq[:, :plen].cpu()
        return {"prompt": list(prompt), "prompt_len": plen,
                "first_token": first, "k": k, "v": v,
                "kv_bytes": int(k.nbytes + v.nbytes), "max_new": max_new}

    def submit_stream_from_kv(self, kv: Dict[str, Any],
                              max_new_tokens: Optional[int] = None,
                              emit_first: bool = True) -> TokenStream:
        """Join the continuous batch from an exported K/V handoff
        (``prefill_export`` dict) instead of a prompt pass. The first
        token is already known; with ``emit_first=False`` the stream
        treats it as already delivered and yields only later tokens."""
        self._check_mode("decode")
        prompt = list(kv["prompt"])
        max_new = self._validate(
            prompt, kv.get("max_new") if max_new_tokens is None
            else max_new_tokens)
        req = _Request(prompt, max_new)
        req.kv = (kv["k"], kv["v"], int(kv["first_token"]))
        req.stream = TokenStream(req.future)
        if not emit_first:
            req.streamed = 1
        self._enqueue(req)
        return req.stream

    def generate(self, prompt: Sequence[int],
                 max_new_tokens: Optional[int] = None,
                 timeout: float = 600.0) -> List[int]:
        return self.submit(prompt, max_new_tokens).result(timeout)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "mode": self.mode,
                "num_steps": self.num_steps,
                "decode_steps": self.decode_steps,
                "max_concurrent": self.max_concurrent,
                "free_pages": len(self._free_pages),
                "active": sum(s.req is not None for s in self._slots),
                "queued": self._queue.qsize(),
            }

    def shutdown(self) -> None:
        self._shutdown = True
        if self._thread is None:      # prefill-only engine: no loop
            return
        self._wake.set()
        self._thread.join(timeout=30.0)
        self._fail_outstanding(RuntimeError("engine shut down"))

    def _fail_outstanding(self, exc: BaseException) -> None:
        """Resolve every in-flight and queued Future exceptionally — a
        dead engine must never leave callers blocking to timeout."""
        def _fail(req: _Request) -> None:
            if not req.future.done():
                req.future.set_exception(exc)
            if req.stream is not None:
                req.stream._q.put(exc)

        self._pending_firsts = []
        for s in self._slots:
            req, s.req = s.req, None
            if req is not None:
                with self._lock:
                    self._free_pages.extend(s.pages)
                s.pages = []
                s.seq_len = 0
                _fail(req)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            _fail(req)

    # -- internals ------------------------------------------------------
    @property
    def _parking_page(self) -> int:
        return self.cfg.num_pages - 1

    def _pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.cfg.page_size)

    def _try_admit(self) -> None:
        """Admit every admissible queued request, then prefill them in
        batched passes grouped per prompt bucket. The next tokens land in
        the device feedback vector and reach the host with the next
        burst's combined fetch."""
        admits: List[Tuple[_Slot, _Request, List[int]]] = []
        imports: List[Tuple[_Slot, _Request, List[int]]] = []
        while True:
            free_slot = next((s for s in self._slots if s.req is None),
                             None)
            if free_slot is None or self._queue.empty():
                break
            req = self._queue.queue[0]
            need = self._pages_needed(len(req.prompt) + req.max_new)
            with self._lock:
                if need > len(self._free_pages):
                    break  # head-of-line blocks until pages free
                self._queue.get_nowait()
                pages = [self._free_pages.pop() for _ in range(need)]
            free_slot.req = req
            free_slot.pages = pages
            free_slot.seq_len = len(req.prompt)
            req.emitted = 1
            (imports if req.kv is not None else admits).append(
                (free_slot, req, pages))
        for slot, req, pages in imports:
            self._import_one(slot, req, pages)
        by_bucket: Dict[int, List[Tuple[_Slot, _Request, List[int]]]] = {}
        for slot, req, pages in admits:
            by_bucket.setdefault(self._bucket(len(req.prompt)), []).append(
                (slot, req, pages))
        for bucket, group in by_bucket.items():
            self._prefill_group(bucket, group)

    def _prefill_group(self, bucket: int, group: List[tuple]) -> None:
        """One batched prompt pass over the group's prompts, padded to the
        bucket. Unlike the reference's fixed-shape program this runs only
        the real rows, so every feedback-vector write has a real slot."""
        page = self.cfg.page_size
        n_prog = -(-bucket // page)
        n = len(group)
        toks = np.zeros((n, bucket), np.int32)
        page_lists = np.zeros((n, n_prog), np.int32)
        slots = np.zeros(n, np.int64)
        plens = np.zeros(n, np.int64)
        rows: List[Tuple[_Slot, int]] = []
        for r, (slot, req, pages) in enumerate(group):
            plen = len(req.prompt)
            toks[r, :plen] = req.prompt
            # the pass writes n_prog pages per row: the sequence's own
            # where allocated (slots past the prompt are DON'T-CARE —
            # appends overwrite them, attention masks by seq_len), the
            # parking page past its allocation
            page_lists[r] = (pages + [self._parking_page] * n_prog)[:n_prog]
            slots[r] = self._slots.index(slot)
            plens[r] = plen
            rows.append((slot, r))
        dev = self.device
        logits, k_seq, v_seq = prefill_batch(
            self.params, self.mcfg, torch.from_numpy(toks).to(dev))
        dev_pages = torch.from_numpy(page_lists).to(dev).reshape(-1)
        span = n_prog * page
        for i in range(self.mcfg.n_layers):
            k, v = k_seq[i], v_seq[i]                 # [n, bucket, KV, D]
            if span != bucket:
                pad = k.new_zeros((n, span - bucket) + k.shape[2:])
                k, v = torch.cat([k, pad], 1), torch.cat([v, pad], 1)
            write_prefill_kv(self._k_pages[i], self._v_pages[i],
                             k.reshape((n * span,) + k.shape[2:]),
                             v.reshape((n * span,) + v.shape[2:]),
                             dev_pages)
        last = torch.from_numpy(plens - 1).to(dev)
        row_logits = logits[torch.arange(n, device=dev), last]     # [N,V]
        nxt = torch.argmax(row_logits, dim=-1).to(torch.int32)
        self._dev_toks[torch.from_numpy(slots).to(dev)] = nxt
        self._pending_firsts.append((nxt, rows))

    def _import_one(self, slot: _Slot, req: _Request,
                    pages: List[int]) -> None:
        """Admit one K/V handoff: write the exported sequence into this
        engine's pages and the known first token into the device feedback
        vector. The request joins the next burst as if it had prefilled
        here."""
        k, v, first = req.kv
        req.kv = None  # drop the host copy as soon as it's uploaded
        plen = len(req.prompt)
        dt = self.mcfg.dtype
        k = torch.as_tensor(k).to(device=self.device, dtype=dt)
        v = torch.as_tensor(v).to(device=self.device, dtype=dt)
        dev_pages = torch.as_tensor(pages[:self._pages_needed(plen)],
                                    dtype=torch.int64, device=self.device)
        for i in range(self.mcfg.n_layers):
            write_prefill_kv(self._k_pages[i], self._v_pages[i], k[i], v[i],
                             dev_pages)
        self._dev_toks[self._slots.index(slot)] = first
        req.out = [first]
        self._maybe_finish(slot)  # max_new == 1 finishes at admission
        self._push_stream(req)

    def _push_stream(self, req: _Request) -> None:
        if req.stream is None:
            return
        new = req.out[req.streamed:]
        if new:
            req.stream._q.put(new)
        req.streamed += len(new)
        if req.future.done():
            req.stream._q.put(_STREAM_END)

    def _maybe_finish(self, slot: _Slot) -> None:
        req = slot.req
        # budget first: covering-chunk overshoot may have produced
        # tokens past max_new, and an EOS in that overrun region must
        # not be honored (the caller asked for at most max_new)
        budget = req.out[:req.max_new]
        if self.cfg.eos_id is not None and self.cfg.eos_id in budget:
            req.out = budget[:budget.index(self.cfg.eos_id) + 1]
            done = True
        else:
            done = len(req.out) >= req.max_new
            if done:
                req.out = budget
        if done:
            with self._lock:
                self._free_pages.extend(slot.pages)
            slot.req = None
            slot.pages = []
            slot.seq_len = 0
            req.future.set_result(req.out)

    def _loop(self) -> None:
        with torch.no_grad():
            while not self._shutdown:
                try:
                    self._loop_once()
                except Exception as e:  # noqa: BLE001
                    # a failed step (a kernel error, OOM) must not kill the
                    # engine thread with futures parked
                    logging.getLogger(__name__).exception(
                        "inference engine step failed")
                    self._fail_outstanding(e)

    def _loop_once(self) -> None:
        self._try_admit()
        active = [s for s in self._slots if s.req is not None]
        if not active:
            self._wake.wait(timeout=0.05)
            self._wake.clear()
            return
        self.max_concurrent = max(self.max_concurrent, len(active))
        cfg = self.cfg
        # lens + page table upload once per burst (host bookkeeping is
        # authoritative for both); the TOKEN feedback vector stays on the
        # device across bursts. Idle slots decode dummy tokens whose K/V
        # appends land in the parking page; their outputs are discarded.
        # Unallocated table entries also point at the parking page, so
        # budget-overrun appends land there instead of in a live page.
        table = np.full((cfg.batch_size, cfg.max_pages_per_seq),
                        self._parking_page, np.int32)
        lens = np.zeros(cfg.batch_size, np.int32)
        for i, s in enumerate(self._slots):
            if s.req is not None:
                lens[i] = s.seq_len
                table[i, :len(s.pages)] = s.pages
        dev_table = torch.from_numpy(table).to(self.device)
        dev_lens = torch.from_numpy(lens).to(self.device)
        dev_toks = self._dev_toks

        # a burst: chunks back to back without reading results, then ONE
        # fetch — or one chunk per burst when EOS detection needs values
        inflight = {id(s): 0 for s in active}
        pending: List[Tuple[torch.Tensor, int]] = []
        while True:
            remaining = min(s.req.max_new - s.req.emitted - inflight[id(s)]
                            for s in active)
            if remaining <= 0 or len(pending) >= 4:
                break
            # smallest chunk COVERING the remaining budget when one exists
            # (the overrun trims at finish; its appends land in
            # parking-paged table slots)
            covering = [c for c in self._chunk_sizes if c >= remaining]
            chunk = min(covering) if covering else self._chunk_sizes[-1]
            outs, dev_toks, dev_lens = decode_chunk(
                self.params, self.mcfg, dev_toks, self._k_pages,
                self._v_pages, dev_table, dev_lens, n_steps=chunk)
            self.num_steps += 1
            self.decode_steps += chunk
            pending.append((outs, chunk))
            for s in active:
                inflight[id(s)] += chunk
                s.seq_len += chunk
            if cfg.eos_id is not None:
                break
        self._dev_toks = dev_toks

        # ONE fetch per burst: chunk outputs + pending prefill first
        # tokens, concatenated on the device and read together
        firsts, self._pending_firsts = self._pending_firsts, []
        parts = [outs.reshape(-1) for outs, _ in pending]
        parts.extend(arr for arr, _rows in firsts)
        if not parts:
            return
        flat = torch.cat(parts).cpu().numpy()
        # first tokens sit after this burst's chunk rows
        off = sum(c * cfg.batch_size for _, c in pending)
        for arr, rows in firsts:
            for slot, r in rows:
                if slot.req is not None:
                    slot.req.out.insert(0, int(flat[off + r]))
            off += len(arr)
        pos = 0
        for _outs, chunk in pending:
            arr = flat[pos:pos + chunk * cfg.batch_size].reshape(
                chunk, cfg.batch_size)
            pos += chunk * cfg.batch_size
            for i, s in enumerate(self._slots):
                if s.req is None or id(s) not in inflight:
                    continue
                s.req.out.extend(int(t) for t in arr[:, i])
        for s in active:
            if s.req is not None:
                s.req.emitted = len(s.req.out)
        for s in active:
            req = s.req
            if req is None:
                continue
            self._maybe_finish(s)   # may trim EOS overrun + finish
            self._push_stream(req)
