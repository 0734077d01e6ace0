#!/usr/bin/env python3
"""Smoke run of ray_tpu_torch on one NVIDIA GPU: build, check, serve.

    python3 chip_smoke.py     # one card; exits 0 only if every phase passed

Phases, each printing one JSON line:

  1. build   — compile every CUDA kernel of the port from ray_tpu_torch/ops/csrc
               with nvcc (sm_90a), into ray_tpu_torch/_build/.
  2. device  — the card as nvidia-smi reports it (name, power limit).
  3. kernel  — each kernel against its plain PyTorch version at the serving
               shapes (64 sequences, 8 query / 4 KV heads, head_dim 128, page 16,
               16 pages per sequence, 1024 pages, bf16 and f32 pages), with its
               time, the plain version's, one PyTorch library call's as a yardstick,
               and the least time the card could take (the bound).
  4. engine  — the serving engine at the full width of the serving model
               (vocab 32000, d_model 1024, 8 layers, 127M parameters, bf16,
               random weights from a seed): 64 requests x 128 new tokens, a warm
               round and a timed round. The launch counters are zeroed just
               before the timed round; every layer of every decode step must have
               launched the paged-attention kernel. A third round runs under
               torch.profiler: device time by kernel and the device's busy share.
  5. parity  — the same width in f32 (TF32 off): the engine's greedy tokens must
               equal the full-context model's, re-run each step without the
               kernel; a mismatch passes only at a true near-tie (top-2 gap
               below 1e-3).

Then the kernel table as one JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Without a CUDA device, or without the
ray_tpu_torch package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, dense bf16
# tensor-core rate, f32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

SERVE = dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=8,
             n_kv_heads=4, d_ff=2816, max_seq_len=2048)
SLOTS, PAGE, MAX_PAGES, NUM_PAGES, NEW_TOKENS = 64, 16, 16, 1024, 128


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, n_iter: int) -> float:
    """Mean device time of fn(i) over n_iter calls, by CUDA events."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n_iter):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def phase_kernel(torch, dev):
    """Paged attention: kernel vs plain version at the serving shapes, over
    one cache per layer (8 x 16 MiB per K or V), cycled as the decode step
    does, so timings do not sit in L2."""
    from ray_tpu_torch.ops import paged_attention as pa

    B, H, KV, D, MP, P, L = SLOTS, 8, 4, 128, MAX_PAGES, NUM_PAGES, 8
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.randperm(P, generator=g, device=dev).reshape(B, MP).to(
        torch.int32).contiguous()
    lens = torch.cat([
        torch.tensor([0, 1, 16, 17, MP * PAGE], device=dev),
        torch.randint(0, MP * PAGE + 1, (B - 5,), generator=g, device=dev),
    ]).to(torch.int32)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((B, H, D), generator=g, device=dev).to(dtype)
        kps = [torch.randn((P, KV, PAGE, D), generator=g, device=dev).to(dtype)
               for _ in range(L)]
        vps = [torch.randn((P, KV, PAGE, D), generator=g, device=dev).to(dtype)
               for _ in range(L)]
        err = 0.0
        for i in range(L):
            ker = pa.paged_attention(q, kps[i], vps[i], table, lens)
            ref = pa.paged_attention_reference(q, kps[i], vps[i], table, lens)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(ker).all()):
                raise AssertionError(f"kernel output not finite ({dtype})")
            err = max(err, float((ker - ref).abs().max()))
        # both read the same values and accumulate in f32: only the order
        # of the sums differs
        if err > 1e-4:
            raise AssertionError(f"paged_attention kernel vs plain: max abs "
                                 f"err {err} > 1e-4 ({dtype})")
        name = str(dtype).replace("torch.", "")
        row = {"dtype": name, "max_abs_err": err}
        row["ms"] = cuda_ms(torch, lambda i: pa.paged_attention(
            q, kps[i % L], vps[i % L], table, lens), 200)
        row["plain_ms"] = cuda_ms(torch, lambda i: pa.paged_attention_reference(
            q, kps[i % L], vps[i % L], table, lens), 20)
        # yardstick only (the port never calls it): one SDPA call over the
        # KV already gathered per sequence and repeated to every head
        T = MP * PAGE
        mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[
            :, None, None, :]
        gathered = []
        for i in range(L):
            kg, vg = (x[table.long()].permute(0, 2, 1, 3, 4).reshape(
                B, KV, T, D).repeat_interleave(H // KV, 1)
                for x in (kps[i], vps[i]))
            gathered.append((kg, vg))
        qs = q[:, :, None, :]
        row["library_ms"] = cuda_ms(
            torch, lambda i: torch.nn.functional.scaled_dot_product_attention(
                qs, *gathered[i % L], attn_mask=mask), 200)
        del gathered
        valid = int(lens.clamp(max=T).sum())
        nbytes = (q.nbytes + B * H * D * 4 + table.nbytes + lens.nbytes
                  + 2 * valid * KV * D * q.element_size())
        flops = 4 * valid * H * D
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[name] * 1e3
        row.update(bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=nbytes, flops=flops)
        rows[name] = row
        emit({"phase": "kernel", "name": "paged_decode_attention", **row})
    return rows


def phase_engine(torch):
    """The main path: the engine at full width, bf16. Returns the
    paged-attention launches of the timed round."""
    from ray_tpu_torch.models.inference import (InferenceConfig,
                                                InferenceEngine)
    from ray_tpu_torch.models.transformer import (TransformerConfig,
                                                  init_params, param_count)
    from ray_tpu_torch.ops import paged_attention as pa

    mcfg = TransformerConfig(dtype=torch.bfloat16, **SERVE)
    params = init_params(mcfg, torch.Generator(device="cuda").manual_seed(0))
    icfg = InferenceConfig(batch_size=SLOTS, page_size=PAGE,
                           max_pages_per_seq=MAX_PAGES, num_pages=NUM_PAGES,
                           prefill_buckets=(16,), max_new_tokens=NEW_TOKENS)
    engine = InferenceEngine(params, mcfg, icfg)
    prompts = [[i + 1] * 4 for i in range(SLOTS)]
    try:
        for f in [engine.submit(p, NEW_TOKENS) for p in prompts]:
            f.result(timeout=600)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the main path: counters from zero, then one timed round
        pa.paged_attention.launches = 0
        steps0 = engine.decode_steps
        t0 = time.perf_counter()
        outs = [f.result(timeout=600)
                for f in [engine.submit(p, NEW_TOKENS) for p in prompts]]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = pa.paged_attention.launches
        steps = engine.decode_steps - steps0
        breakdown = profile_round(torch, engine, prompts)
    finally:
        engine.shutdown()
    if launches == 0 or launches != mcfg.n_layers * steps:
        raise AssertionError(f"paged_attention launches {launches} != "
                             f"{mcfg.n_layers} layers x {steps} decode steps")
    bad = [o for o in outs if len(o) != NEW_TOKENS
           or not all(0 <= t < mcfg.vocab_size for t in o)]
    if bad:
        raise AssertionError(f"{len(bad)} malformed generations")
    total = sum(len(o) for o in outs)
    row = {"phase": "engine", "requests": SLOTS, "new_tokens": NEW_TOKENS,
           "n_params": param_count(params), "tokens": total, "seconds": dt,
           "tokens_per_s": total / dt, "decode_steps": steps,
           "ms_per_decode_step": dt / steps * 1e3,
           "paged_attention_launches": launches,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "distinct_generations": len({tuple(o) for o in outs}),
           # the profiled round does the timed round's work; its wall time
           # is inflated by the profiler, so the share uses the timed wall
           "device_busy_share": breakdown["device_busy_us"] / (dt * 1e6),
           "profile": breakdown}
    emit(row)
    return launches


def profile_round(torch, engine, prompts):
    """One more round under torch.profiler: device time by kernel name and
    the device's busy share of the round's wall time."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for f in [engine.submit(p, NEW_TOKENS) for p in prompts]:
            f.result(timeout=600)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.device_time_total if hasattr(e, "device_time_total")
             else e.cuda_time_total, e.count) for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
    kernel_us = sum(r[1] for r in rows if not r[0].startswith("aten::")
                    and not r[0].startswith("cuda"))
    top = sorted((r for r in rows if not r[0].startswith("aten::")),
                 key=lambda r: -r[1])[:12]
    return {"wall_us": wall_us, "device_busy_us": kernel_us,
            "top": [{"name": k[:80], "device_us": t, "count": c}
                    for k, t, c in top]}


def phase_parity(torch):
    """f32 greedy parity: the engine (through the kernel) vs the
    full-context model (no kernel), re-run at every step."""
    from ray_tpu_torch.models.inference import (InferenceConfig,
                                                InferenceEngine)
    from ray_tpu_torch.models.transformer import (TransformerConfig,
                                                  init_params,
                                                  model_from_params)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mcfg = TransformerConfig(dtype=torch.float32, **SERVE)
    params = init_params(mcfg, torch.Generator(device="cuda").manual_seed(1))
    n_new = 16
    prompts = [[1, 2, 3, 4], [5] * 4, [17, 300, 9000, 31999, 12], [7]]
    engine = InferenceEngine(params, mcfg, InferenceConfig(
        batch_size=4, page_size=PAGE, max_pages_per_seq=MAX_PAGES,
        num_pages=128, prefill_buckets=(16,), max_new_tokens=n_new))
    try:
        got = [f.result(timeout=600)
               for f in [engine.submit(p, n_new) for p in prompts]]
    finally:
        engine.shutdown()
    model = model_from_params(mcfg, params)
    compared, ties = 0, []
    with torch.no_grad():
        for prompt, out in zip(prompts, got):
            toks = list(prompt)
            for step in range(n_new):
                logits = model(torch.tensor([toks], device="cuda"))[0, -1]
                want = int(torch.argmax(logits))
                compared += 1
                if out[step] != want:
                    top2 = torch.topk(logits, 2).values
                    gap = float(top2[0] - top2[1])
                    if gap >= 1e-3:
                        raise AssertionError(
                            f"greedy mismatch for prompt {prompt} at step "
                            f"{step}: engine {out[step]}, model {want}, "
                            f"top-2 gap {gap}")
                    ties.append({"prompt": prompt, "step": step, "gap": gap})
                    break  # the continuations diverge after a near-tie
                toks.append(want)
    emit({"phase": "parity", "dtype": "float32", "prompts": len(prompts),
          "tokens_compared": compared, "near_ties": ties})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from ray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {n: str(p.relative_to(Path(__file__).resolve().parent))
                        for n, p in libs.items()},
          "ptxas": {n: _build.register_report(n) for n in libs}})

    smi = nvidia_smi()
    dev = torch.device("cuda", torch.cuda.current_device())
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(dev),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    kernel_rows = phase_kernel(torch, dev)
    launches = phase_engine(torch)
    phase_parity(torch)

    main_row = kernel_rows["bfloat16"]
    emit({"kernels": [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:76",
        "launches": launches, "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
