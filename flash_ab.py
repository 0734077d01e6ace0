#!/usr/bin/env python3
"""Attention kernels of two source trees, side by side on one NVIDIA GPU.

    python3 flash_ab.py PARENT_DIR CHANGE_DIR            # flash backward
    python3 flash_ab.py PARENT_DIR CHANGE_DIR --ring     # kernel 2
    python3 flash_ab.py PARENT_DIR CHANGE_DIR --ring --cells
    python3 flash_ab.py PARENT_DIR CHANGE_DIR --sass     # SASS alone

Each directory is a checkout of this repository, for example a commit
unpacked with `git archive` into a directory that .gitignore lists. For
each tree, in a subprocess of its own, building that tree's libraries under
its own ray_tpu_torch/_build and hashing the SASS of each instance named
below with the file's anonymous-namespace name taken out (it differs with
the source's text):
- by default, the head_dim-128 flash library: each backward instance's
  SASS, and flash_bwd_dq and flash_bwd_dkv timed by CUDA events at the
  train path's shape ([16, 16, 2047, 128], bf16, causal), five readings of
  20 launches each;
- with --ring, kernel 2's libraries and the flash libraries at 128 and
  256: the SASS of kernel 2's 128-query template at 128 and of the flash
  forward (3a) at 128 and 256; kernel 2 (block_attention, bf16, each
  tree's own launch) on the full block of each width's ring path
  (chip_smoke.ring_path_shapes), five readings each of the device time by
  replays of 20 calls captured in one CUDA graph and of the eager time,
  and in a tree that has the launch plan (ring_attention.block_plan) two
  graph readings of each launch of chip_smoke.ring_launches at the widths
  but 128; with --cells also the cells that run those kernels, once a
  run: chip_smoke's phase train (the step ms at 128 and at 8 x 256) and
  phase ring (the forward ms at each width).
- with --sass, no timing: every attention library's instances of SASS_ALL
  (kernel 1's split and merge kernels at each width, kernel 2's template
  and split kernel at each width, the flash forward at 128 and 256), one
  run a tree.
The trees run parent, change, change, parent, parent, change (--sass:
parent, change). Prints one JSON line a run, then a summary: whether each
instance's SASS is the same in both trees (an instance the parent has),
and each side's range of readings. Exits 1 without a card.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ORDER = ("parent", "change", "change", "parent", "parent", "change")
READINGS, LAUNCHES = 5, 20
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_[0-9]+_\w+?_cu_[0-9a-f]+")
# --ring: {library: the instances whose SASS is compared}: kernel 2's
# 128-query template at 128, the flash forward (3a) at 128 and 256
RING_SASS = {"ring_attention": "attention_fwd_kernel",
             "flash_attention": "attention_fwd_kernel",
             "flash_attention_d256": "attention_fwd_kernel"}
# --sass: {source: the kernels of each of its libraries whose instances'
# SASS is compared}
SASS_ALL = {"paged_attention": ("paged_decode_split_kernel",
                                "paged_decode_merge_kernel"),
            "ring_attention": ("attention_fwd_kernel",
                               "attention_fwd_split_kernel"),
            "flash_attention": ("attention_fwd_kernel",)}


def sass_hashes(lib, match: str) -> dict:
    """{instance: hash of its SASS (instructions and encodings, runs of
    blanks as one)} of a library's kernels whose name holds
    `match` (and not the split kernel's name, which holds no `match` of the
    template's: attention_fwd_split_kernel)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    hashes = {}
    for func in sass.split("Function : ")[1:]:
        # cuobjdump pads each line to the library's longest instruction:
        # the instructions and their encodings, not the padding, are hashed
        func = re.sub(r"[ \t]+", " ", ANON.sub("", func))
        name = func.split("\n", 1)[0].strip()
        if match in name:
            hashes[name] = hashlib.sha256(func.encode()).hexdigest()[:16]
    return hashes


def sass_child(root: str) -> int:
    """--sass in one tree: the SASS of SASS_ALL's kernels in every width's
    library."""
    sys.path.insert(0, root)
    from ray_tpu_torch.ops import _build

    here = Path(_build.__file__).resolve()
    if not here.is_relative_to(Path(root).resolve()):
        raise SystemExit(f"imported {here}, not the tree {root}")
    names = [n for n in _build.sources() if n.split("_d")[0] in SASS_ALL]
    libs = _build.build_all(names)
    hashes = {f"{lib}/{k}": v for lib in names
              for match in SASS_ALL[lib.split("_d")[0]]
              for k, v in sass_hashes(libs[lib], match).items()}
    print(json.dumps({"sass": hashes, "ms": {}}), flush=True)
    return 0


def ring_child(root: str, cells: bool) -> int:
    """--ring in one tree: SASS of RING_SASS, kernel 2's times a width,
    with cells the cells' times."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import ring_attention as ra

    if not Path(ra.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise SystemExit(f"imported {ra.__file__}, not the tree {root}")
    libs = _build.build_all([n for n in _build.sources()
                             if n.split("_d")[0] in ("ring_attention",
                                                     "flash_attention")])
    hashes = {}
    for lib, match in RING_SASS.items():
        hashes.update({f"{lib}/{k}": v
                       for k, v in sass_hashes(libs[lib], match).items()})
    dev = torch.device("cuda", 0)
    times = {}
    for D, (H, KV, T) in sorted(chip_smoke.ring_path_shapes().items()):
        g = torch.Generator(device=dev).manual_seed(3)
        q, k, v = chip_smoke.ring_inputs(torch, dev, g, 1, H, KV, T, T, D,
                                         torch.bfloat16)
        q_off, k_off = chip_smoke.ring_blocks(T)["full"]

        def call():
            return ra.block_attention(q, k, v, q_off, k_off)

        times[f"d{D}_graph"] = [
            chip_smoke.graph_ms(torch, [call] * LAUNCHES)[0]
            for _ in range(READINGS)]
        times[f"d{D}_eager"] = [
            chip_smoke.cuda_ms(torch, lambda i: call(), LAUNCHES)
            for _ in range(READINGS)]
        if hasattr(ra, "block_plan") and D != chip_smoke.FLASH_D:
            for n in chip_smoke.ring_launches(D):
                times[f"d{D}_graph_splits{n}"] = [chip_smoke.graph_ms(
                    torch, [lambda n=n: ra.block_attention(
                        q, k, v, q_off, k_off, True, n)] * LAUNCHES)[0]
                    for _ in range(2)]
        del q, k, v
        torch.cuda.empty_cache()
    # the cells, their lines kept off this process's output
    out = io.StringIO()
    if cells:
        with contextlib.redirect_stdout(out):
            chip_smoke.phase_train(torch)
            chip_smoke.phase_ring(torch, dev)
    for line in out.getvalue().splitlines():
        row = json.loads(line) if line.startswith("{") else {}
        if row.get("phase") == "train" and "step_ms" in row:
            times[f"train_d{row['head_dim']}_step"] = [row["step_ms"]]
        elif row.get("phase") == "ring" and "tokens_per_s" in row:
            times[f"ring_d{row['head_dim']}_forward"] = [row["ms"]]
    print(json.dumps({"sass": hashes, "ms": times}), flush=True)
    return 0


def child(root: str) -> int:
    sys.path.insert(0, root)
    import torch

    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash as fl

    if not Path(fl.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise SystemExit(f"imported {fl.__file__}, not the tree {root}")
    lib = _build.build_all(["flash_attention"])["flash_attention"]
    hashes = sass_hashes(lib, "attention_bwd")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v, do = (torch.randn((16, 2047, 16, 128), generator=g, device=dev)
                   .to(torch.bfloat16).transpose(1, 2) for _ in range(4))
    o, lse = fl.flash_fwd(q, k, v)
    di = (o.float() * do.float()).sum(-1).contiguous()

    def ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(LAUNCHES):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / LAUNCHES

    times = {
        "flash_bwd_dq": [ms(lambda: fl.flash_bwd_dq(q, k, v, do, lse, di))
                         for _ in range(READINGS)],
        "flash_bwd_dkv": [ms(lambda: fl.flash_bwd_dkv(q, k, v, do, lse, di))
                          for _ in range(READINGS)]}
    print(json.dumps({"sass": hashes, "ms": times}), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    trees = dict(zip(("parent", "change"), sys.argv[1:3]))
    mode = ["--ring-child"] if "--ring" in sys.argv[3:] else ["--child"]
    order = ORDER
    if "--sass" in sys.argv[3:]:
        mode, order = ["--sass-child"], ("parent", "change")
    if "--cells" in sys.argv[3:]:
        mode.append("--cells")
    runs = {"parent": [], "change": []}
    for side in order:
        proc = subprocess.run([sys.executable, __file__, *mode,
                               trees[side]], capture_output=True, text=True,
                              timeout=900)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[side].append(row)
        print(json.dumps({"side": side, "tree": trees[side], **row}),
              flush=True)
    sass = {side: runs[side][0]["sass"] for side in runs}
    summary = {
        "same_sass": {name: sass["change"].get(name) == h
                      for name, h in sass["parent"].items()},
        "ms": {kernel: {side: [min(x for r in runs[side]
                                   for x in r["ms"].get(kernel, [])),
                               max(x for r in runs[side]
                                   for x in r["ms"].get(kernel, []))]
                        for side in runs
                        if kernel in runs[side][0]["ms"]}
               for kernel in {**runs["parent"][0]["ms"],
                              **runs["change"][0]["ms"]}}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2]))
    if sys.argv[1:2] == ["--sass-child"]:
        sys.exit(sass_child(sys.argv[2]))
    if sys.argv[1:2] == ["--ring-child"]:
        sys.exit(ring_child(sys.argv[-1], "--cells" in sys.argv[2:-1]))
    sys.exit(main())
