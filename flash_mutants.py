#!/usr/bin/env python3
"""Mutation check of chip_smoke.py's attention checks, on one NVIDIA GPU.

    python3 flash_mutants.py     # one card
    python3 flash_mutants.py split_stride split_boundary   # those, and sound

Copies ray_tpu_torch and chip_smoke.py once per variant (those named on
the command line and "sound", or all of MUTANTS) into
ray_tpu_torch/_build/mutants/<variant>/ (listed in .gitignore), breaks each
copy in one place (MUTANTS), builds every copy's paged, flash and ring
kernels at once, and runs chip_smoke's paged attention checks, flash kernel
checks and ring block checks (no timing) and its train_parity phase on
each copy, one subprocess at a time.
"sound" is the unbroken source, run the same way. Prints one JSON line per
variant: which checks rejected it, and the worst reading of each output.
Exits 0 when the sound copy passes every check and every broken copy is
rejected by at least one.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "ray_tpu_torch" / "_build" / "mutants"
CSRC = "ray_tpu_torch/ops/csrc/"
TILES = CSRC + "mma_tiles.cuh"        # the f32 kernels' routines, the mask
SM90 = CSRC + "attention_fwd_sm90.cuh"   # the bf16 forwards (2 and 3a)
BWD = CSRC + "attention_bwd_sm90.cuh"    # the bf16 backward (3c and 3b)
PAGED = CSRC + "paged_attention.cu"      # kernel 1: split and merge
RING = CSRC + "ring_attention.cu"        # kernel 2: entries, epilogues
# copies built at once (each runs one nvcc per head width's library)
BUILD_COPIES = 2

# variant: (what it breaks, file, text, replacement)
MUTANTS = {
    "sound": ("nothing", None, None, None),
    "mask_bulk": (
        "queries at global position 1024 and on also see the next key "
        "(every kernel: the bf16 and f32 forwards, dQ, dK/dV)",
        TILES, "(!causal || key <= query)",
        "(!causal || key <= query + (query >= 1024))"),
    "dk_lead": (
        "the bf16 dK/dV kernel's dK += dS^T Q reads Q's second head_dim box "
        "16 KB on (a 128-row box's size) instead of 8 KB (a 64-row box's): "
        "the next stage's Q, or dO",
        BWD, "value_tile(dk, dsa, sm.q[stage][0], kSmallBoxBytes);",
        "value_tile(dk, dsa, sm.q[stage][0], kBoxBytes);"),
    "lse_row": (
        "the bf16 dK/dV kernel reads lse at its key row, not at the query "
        "column",
        BWD, "*reinterpret_cast<const float2*>(lse + 8 * n + 2 * t);",
        "make_float2(lse[warp * 16 + g], lse[warp * 16 + g]);"),
    "p_high": (
        "every bf16 operand packed from registers is 1% high: the forwards' "
        "P in P V (o 1% high; lse, m and l right) and the backward's P, dS "
        "(pack_p, shared)",
        SM90, "__floats2bfloat162_rn(p0, p1)",
        "__floats2bfloat162_rn(p0 * 1.01f, p1 * 1.01f)"),
    "dq_bulk": (
        "the bf16 dQ kernel's P is 2% low in query rows from 1024 on",
        BWD, "da[i] = pack_p(p0 * (dp[2 * i] - dr), p1 * (dp[2 * i + 1] - dr));",
        "const float bulk = (hi ? row_hi : row_lo) < 1024 ? 1.f : 0.98f;\n"
        "          da[i] = pack_p(bulk * p0 * (dp[2 * i] - dr),\n"
        "                         bulk * p1 * (dp[2 * i + 1] - dr));"),
    "dq256_v_slot": (
        "the bf16 dQ kernel at head_dim 256 multiplies dS by the V tile's "
        "slot of its three-slot ring, not by K's",
        BWD, "value_tile(dq[ch], dsa, sm.kv[ks][2 * ch], kSmallBoxBytes);",
        "value_tile(dq[ch], dsa, sm.kv[vs][2 * ch], kSmallBoxBytes);"),
    "dkv256_pt_lane": (
        "the bf16 dK/dV kernel at head_dim 256: warpgroup 1 takes P^T from "
        "the hand-off at the column of another thread (the key 1 row on)",
        BWD, "const float pe = sm.pt[4 * n + e][w];",
        "const float pe = sm.pt[4 * n + e][w ^ 4];"),
    "dkv256_half_swap": (
        "the bf16 dK/dV kernel at head_dim 256 writes each column half of "
        "dK and dV at the other half's columns",
        BWD, "store_rows(out + 128 * ch, pr.ss, acc[ch], key_lo, key_hi, t, "
             "pr.S,",
        "store_rows(out + 128 * (ch ^ 1), pr.ss, acc[ch], key_lo, key_hi, "
        "t, pr.S,"),
    "split_stride": (
        "kernel 2's split kernel steps 8 rows by 1024 bytes at every width: "
        "4 and 2 row groups too far at head_dim 16 and 32",
        SM90, "static constexpr uint32_t kGroupBytes = 8 * kRowBytes;",
        "static constexpr uint32_t kGroupBytes = 8 * 128;"),
    "split_no_rescale": (
        "kernel 2's split merge sums the splits' o and l without rescaling "
        "each to the row's largest m",
        SM90, "mj[j] > 0.5f * kNegInf ? fast_exp2((mj[j] - m) * c) : 0.f;",
        "mj[j] > 0.5f * kNegInf ? 1.f : 0.f;"),
    "split_boundary": (
        "kernel 2's split kernel ends each split one key tile late: the "
        "first tile of the next split is counted twice",
        SM90, "const int kt1 = (split + 1) * kt_end / splits;",
        "const int kt1 = min(kt_end, (split + 1) * kt_end / splits + 1);"),
    "split_gqa_mod": (
        "kernel 2's split kernel maps query head h to KV head h % Hkv, not "
        "h / (H / Hkv)",
        SM90, "h = bh % pr.H, hk = h / pr.rep;",
        "h = bh % pr.H, hk = h % (pr.H / pr.rep);"),
    "split_dead_rows": (
        "kernel 2's split kernel drops the guard of rows that have seen no "
        "key: p = 2^0 = 1 for each of their masked columns",
        SM90, "const float mc_lo = m_lo > 0.5f * kNegInf ? m_lo * c : 0.f;",
        "const float mc_lo = m_lo * c;"),
    "swap_dkdv": (
        "the autograd Function returns dv as k's gradient and dk as v's",
        "ray_tpu_torch/ops/flash.py", "return dq, dk, dv, None",
        "return dq, dv, dk, None"),
    "dead_rows": (
        "the 128-query template (3a, kernel 2's long shards) drops the guard "
        "of rows that have seen no key: p = exp(0) = 1 for each of their "
        "masked columns",
        SM90, "const bool live_lo = m_lo > 0.5f * kNegInf;\n"
              "  const bool live_hi = m_hi > 0.5f * kNegInf;",
        "const bool live_lo = true;\n  const bool live_hi = true;"),
    "gqa_mod": (
        "the 128-query template maps query head h to KV head h % Hkv, not "
        "h / (H / Hkv)",
        SM90, "const int hk = h / pr.rep;",
        "const int hk = h % (pr.H / pr.rep);"),
    "paged_merge_last": (
        "kernel 1's merge leaves out the last split of every row",
        PAGED, "for (int s = 0; s < S; ++s) {",
        "for (int s = 0; s < S - 1; ++s) {"),
    "paged_tail": (
        "kernel 1's tail mask lets one token past seq_len through (within "
        "the pages it loaded)",
        PAGED, "const int n_tok = min(len - start, n_pages * page);",
        "const int n_tok = min(len - start + 1, n_pages * page);"),
    "paged_gqa_mod": (
        "kernel 1 maps query head j to KV head j % KV, not j / G",
        PAGED, "auto head = [&](int g) { return kvh * G + g; };",
        "auto head = [&](int g) { return kvh + g * KV; };"),
    "paged_table_late": (
        "kernel 1 reads the page table one logical page late (the last "
        "entry of the row for the last page)",
        PAGED, "? page_table[(size_t)b * MP + first + lane]",
        "? page_table[(size_t)b * MP + min(first + lane + 1, MP - 1)]"),
    # the head widths below their class (ops/head_dims.py)
    "paged_scale_class": (
        "kernel 1 below its class scales q by 1 / sqrt of the class width, "
        "not of the true head_dim",
        PAGED, "1.4426950408889634f / sqrtf((float)d);",
        "1.4426950408889634f / sqrtf((float)D);"),
    "paged_rowwise_tail": (
        "kernel 1's value-by-value tile load (a K/V tile that is not whole "
        "16-byte units) skips the values of the last partial unit of 8",
        PAGED, "for (int e = tid; e < tile; e += kThreads) {",
        "for (int e = tid; e < tile / 8 * 8; e += kThreads) {"),
    "ring_scale_class": (
        "kernel 2 in bf16 below its class scales the scores by 1 / sqrt of "
        "the class width, not of the true head_dim",
        RING, "1.0f / sqrtf((float)D)};",
        "1.0f / sqrtf((float)kHeadDim)};"),
    "ring_store_past": (
        "kernel 2's bf16 epilogue below its class stores the padded "
        "columns past the true head_dim: their zeros over the next row's "
        "first columns (each (batch, head)'s last row excepted, which would "
        "write past the tensor)",
        RING, "if (col < d) p[0] = x0;",
        "if (col < d || row + 1 < Tq) p[0] = x0;"),
    "split_map_class": (
        "the split kernel's q and K maps below its class describe the class "
        "width: each row's boxes read on into the next row's columns, so "
        "the padded columns of q k multiply non-zero values",
        SM90, "kSplitRows, cols, F::kCols);\n  if (rc == 0) {\n"
        "    rc = encode_map(&k_map, k, B, Hkv, pr.Tk, sk[0], sk[1], sk[2], "
        "F::kKeys,\n                    cols, F::kCols);",
        "kSplitRows, D, F::kCols);\n  if (rc == 0) {\n"
        "    rc = encode_map(&k_map, k, B, Hkv, pr.Tk, sk[0], sk[1], sk[2], "
        "F::kKeys,\n                    D, F::kCols);"),
    "template_map_class": (
        "the 128-query template's q and K maps below its class describe the "
        "class width (kernel 2 at splits 0; 3a passes its own width)",
        SM90, "kRows,\n                      cols);\n  if (rc == 0) {\n"
        "    rc = encode_map(&k_map, k, B, Hkv, pr.Tk, sk[0], sk[1], sk[2], "
        "keys,\n                    cols);",
        "kRows,\n                      D);\n  if (rc == 0) {\n"
        "    rc = encode_map(&k_map, k, B, Hkv, pr.Tk, sk[0], sk[1], sk[2], "
        "keys,\n                    D);"),
}


def make_copy(name: str) -> Path:
    _what, rel, text, repl = MUTANTS[name]
    dst = WORK / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "ray_tpu_torch", dst / "ray_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    if rel is not None:
        path = dst / rel
        src = path.read_text()
        if src.count(text) != 1:
            raise SystemExit(f"{name}: {text!r} occurs {src.count(text)} "
                             f"times in {rel}")
        path.write_text(src.replace(text, repl))
    return dst


def child(root: str) -> int:
    """In a copy: the paged attention checks, the flash kernel checks, the
    ring block checks and train_parity, each caught."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from ray_tpu_torch.ops import flash

    if not Path(flash.__file__).resolve().is_relative_to(Path(root)):
        raise SystemExit(f"imported {flash.__file__}, not the copy {root}")
    dev = torch.device("cuda", torch.cuda.current_device())
    verdict = {}
    for check, fn in (
            ("paged_kernel", lambda: chip_smoke.phase_kernel(torch, dev,
                                                             timed=False)),
            ("kernel", lambda: chip_smoke.phase_flash_kernel(torch, dev,
                                                             timed=False)),
            ("ring_kernel", lambda: chip_smoke.phase_ring_kernel(
                torch, dev, timed=False)),
            ("train_parity", lambda: chip_smoke.phase_train_parity(torch))):
        try:
            fn()
            verdict[check] = "passed"
        except AssertionError as e:
            verdict[check] = f"rejected: {e}"
    print(json.dumps({"verdict": verdict}), flush=True)
    return 0


def width(obj) -> str:
    """' d<head_dim>' for a line that names its head width, else ''."""
    return f" d{obj['head_dim']}" if "head_dim" in obj else ""


def summary(name: str, out: str) -> dict:
    """One line: the verdicts and the worst reading of each output."""
    row = {"variant": name, "breaks": MUTANTS[name][0], "paged_kernel": {},
           "kernel": {}, "ring_kernel": {}, "train_parity": {}}
    for line in out.splitlines():
        if not line.startswith("{"):
            continue
        obj = json.loads(line)
        if "verdict" in obj:
            row["verdict"] = obj["verdict"]
        elif obj.get("name") == "paged_decode_attention":
            key = (obj["shape"] + width(obj)
                   + (f" {obj['dtype']}" if "dtype" in obj else ""))
            row["paged_kernel"][key] = {k: obj[k] for k in (
                "max_abs_err", "failed", "deterministic",
                "graph_bit_identical") if k in obj}
            if "failed" in obj:
                row["paged_kernel"][key]["failed"] = len(obj["failed"])
        elif obj.get("name") == "ring_block_attention":
            key = f"{obj['block']} {obj['dtype']}{width(obj)}"
            row["ring_kernel"][key] = {
                "dead_rows_exact": obj["dead_rows_exact"], "ok": obj["ok"],
                **{r["output"]: [r["err_over_bound"], r["rel_l2"]]
                   for r in obj["outputs"]}}
        elif obj.get("phase") == "kernel":
            for r in obj["outputs"]:
                key = (f"{obj['name']}.{r['output']} {obj['dtype']}"
                       f"{'' if obj['causal'] else ' non-causal'}"
                       f"{' ' + obj['shape'] if 'shape' in obj else ''}"
                       f"{width(obj)}")
                row["kernel"][key] = {k: r[k] for k in (
                    "max_abs_err", "err_over_bound", "rel_l2", "ok")}
        elif obj.get("phase") == "train_parity":
            row["train_parity"][obj["dtype"] + width(obj)] = {
                k: obj[k] for k in (
                "loss_diff", "grad_norm_rel_diff", "worst_leaf",
                "worst_leaf_rel_l2", "ok")}
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_mutants: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    names = ["sound"] + [n for n in (sys.argv[1:] or MUTANTS) if n != "sound"]
    unknown = set(names) - set(MUTANTS)
    if unknown:
        print(f"flash_mutants: no variant {sorted(unknown)}", file=sys.stderr)
        return 1
    roots = {name: make_copy(name) for name in names}
    # every head width's library of the attention kernels
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from ray_tpu_torch.ops import _build; "
             "_build.build_all([n for n in _build.sources() "
             "if n.split('_d')[0] in ('paged_attention', 'flash_attention', "
             "'ring_attention')])")
    # BUILD_COPIES copies at a time: each starts one nvcc a library (12)
    copies = list(roots.values())
    for i in range(0, len(copies), BUILD_COPIES):
        procs = [subprocess.Popen([sys.executable, "-c", build, str(r)])
                 for r in copies[i:i + BUILD_COPIES]]
        if any([p.wait() for p in procs]):
            return 1
    ok = True
    for name, root in roots.items():
        proc = subprocess.run([sys.executable, __file__, "--child",
                               str(root)], capture_output=True, text=True,
                              timeout=900)
        row = summary(name, proc.stdout)
        row["rc"] = proc.returncode
        if proc.returncode:
            row["stderr"] = proc.stderr[-2000:]
        print(json.dumps(row), flush=True)
        verdict = row.get("verdict", {})
        rejected = any(v != "passed" for v in verdict.values())
        ok &= bool(verdict) and rejected == (name != "sound")
    shutil.rmtree(WORK, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2]))
    sys.exit(main())
