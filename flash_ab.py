#!/usr/bin/env python3
"""The bf16 flash backward (kernels 3c, 3b) of two source trees, side by
side on one NVIDIA GPU.

    python3 flash_ab.py PARENT_DIR CHANGE_DIR

Each directory is a checkout of this repository, for example a commit
unpacked with `git archive` into a directory that .gitignore lists. For
each tree, in a subprocess of its own: builds that tree's head_dim-128
flash library (under its own ray_tpu_torch/_build), hashes the SASS of
each backward instance with the file's anonymous-namespace name taken
out (it differs with the source's text), and times flash_bwd_dq and
flash_bwd_dkv by CUDA events at the train path's shape ([16, 16, 2047,
128], bf16, causal): five readings of 20 launches each. The trees run
parent, change, change, parent, parent, change. Prints one JSON line a
run, then a summary: whether each instance's SASS is the same in both
trees, and each side's range of readings. Exits 1 without a card.
"""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ORDER = ("parent", "change", "change", "parent", "parent", "change")
READINGS, LAUNCHES = 5, 20
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_[0-9]+_flash_attention_cu_[0-9a-f]+")


def child(root: str) -> int:
    sys.path.insert(0, root)
    import torch

    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash as fl

    if not Path(fl.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise SystemExit(f"imported {fl.__file__}, not the tree {root}")
    lib = _build.build_all(["flash_attention"])["flash_attention"]
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    hashes = {}
    for func in sass.split("Function : ")[1:]:
        func = ANON.sub("", func)
        name = func.split("\n", 1)[0].strip()
        if "attention_bwd" in name:
            hashes[name] = hashlib.sha256(func.encode()).hexdigest()[:16]
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
    runs = {"parent": [], "change": []}
    for side in ORDER:
        proc = subprocess.run([sys.executable, __file__, "--child",
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
                                   for x in r["ms"][kernel]),
                               max(x for r in runs[side]
                                   for x in r["ms"][kernel])]
                        for side in runs}
               for kernel in ("flash_bwd_dq", "flash_bwd_dkv")}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2]))
    sys.exit(main())
