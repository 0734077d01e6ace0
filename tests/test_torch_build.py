"""ray_tpu_torch.ops._build: the nvcc build of the port's CUDA kernels.

The real compiler runs only on the machine with the card (chip_smoke.py);
here a stand-in ``nvcc`` script checks the command line, the cache by
source hash, the concurrent build and the error report.
"""

import shutil
import stat

import pytest

from ray_tpu_torch.ops import _build

# an entry point as ptxas names it (nvcc 12.9, sm_90a)
MANGLED = ("_ZN51_GLOBAL__N__e929ddf8_18_paged_attention_cu_ad584a0a19"
           "paged_decode_kernelI13__nv_bfloat16Li128EEEvPKT_S4_S4_PKiS6_"
           "Pfiiiif")


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    out = tmp_path / "_build"
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    return out


def test_every_source_has_a_hashed_target(build_dir):
    srcs = _build.sources()
    assert "paged_attention" in srcs
    t = _build.target("paged_attention")
    assert t.parent == build_dir and t.name.startswith("paged_attention-")
    assert t == _build.target("paged_attention")


def test_build_all_runs_nvcc_once_per_stale_source(tmp_path, build_dir,
                                                   monkeypatch):
    calls = tmp_path / "calls"
    # writes the -o target, logs its arguments and a ptxas-style report
    nvcc = _fake_nvcc(tmp_path, f"""
echo "$@" >> {calls}
while [ "$1" != "-o" ]; do shift; done
: > "$2"
echo "ptxas info    : Compiling entry function '{MANGLED}' for 'sm_90a'" >&2
echo "ptxas info    : Function properties for {MANGLED}" >&2
echo "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" >&2
echo "ptxas info    : Used 96 registers, used 1 barriers" >&2
""")
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    out = _build.build_all()
    assert set(out) == set(_build.sources())
    assert all(p.exists() for p in out.values())
    args = calls.read_text().splitlines()
    assert len(args) == len(out)
    assert all("arch=compute_90a,code=sm_90a" in a and "-shared" in a
               for a in args)
    assert _build.build_all() == out          # cached: nvcc not run again
    assert len(calls.read_text().splitlines()) == len(out)
    report = _build.register_report("paged_attention")
    name = ("paged_decode_kernel<__nv_bfloat16, 128>"
            if shutil.which("c++filt") else MANGLED)
    assert report == {name: "0 bytes stack frame, 0 bytes spill stores, 0 "
                            "bytes spill loads; Used 96 registers, used 1 "
                            "barriers"}


def test_build_failure_raises_with_nvcc_stderr(tmp_path, build_dir,
                                               monkeypatch):
    nvcc = _fake_nvcc(tmp_path, 'echo "error: bad kernel" >&2\nexit 2\n')
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build_all(["paged_attention"])
    assert not _build.target("paged_attention").exists()
