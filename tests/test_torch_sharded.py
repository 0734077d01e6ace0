"""The port's multi-process device runtime against ray_tpu's, on the CPU.

Every rank test starts real processes (4, or 2 for the reference's
two-process case) that join one ``torch.distributed`` gloo group through
``ray_tpu_torch.parallel.distributed.init_multihost`` (rendezvous by a
``file://`` path under the test's ``tmp_path``, so no two xdist workers
collide) and run a body that imports torch and the port only; each rank
checks that no jax, flax or ray_tpu module is loaded. Every spawn has a
deadline: a rank that hangs or dies fails the test. The parent computes
the expected values, with numpy here and with JAX on the virtual CPU mesh
(tests/conftest.py) in the other ``test_torch_sharded_*`` files, from the
same seeded numpy inputs.

Here: each collective (``allreduce`` sum / mean / max / min,
``allgather``, ``reducescatter``, ``broadcast``, ``barrier``,
``send_recv``, ``all_to_all``), forward and gradient, against numpy; the
reference's two-process global-mesh reduction (112.0);
``logical_sharding`` against the reference's ``NamedSharding`` specs; and
``python -m ray_tpu_torch start --jax-*`` joining a group.
"""

import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_DEADLINE_S = 240.0
BANNED = ("jax", "flax", "ray_tpu")

_PRELUDE = '''
import faulthandler, os, sys
# a rank that hangs prints every thread's stack and exits before the
# parent's deadline, so the failure shows where it stopped
faulthandler.dump_traceback_later({hang_s!r}, exit=True)
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
from ray_tpu_torch.parallel import distributed
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
distributed.init_multihost("file://" + os.path.join(tmp, "rendezvous"),
                           world, rank, device="cpu", timeout_s=100)
INPUTS = dict(np.load(os.path.join(tmp, "inputs.npz")))
'''

_EPILOGUE = '''
out = main(rank, world, INPUTS)
out["banned_modules"] = sorted(m for m in sys.modules
                               if m.split(".")[0] in {banned!r})
torch.save(out, os.path.join(tmp, "out%d.pt" % rank))
distributed.shutdown_multihost()
'''


def rank_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO, **extra)
    return env


def run_ranks(tmp_path, body, inputs=None, world=4,
              deadline_s=RANK_DEADLINE_S):
    """Runs ``body`` (source defining ``main(rank, world, inputs) ->
    dict``) in ``world`` rank processes; returns their dicts by rank.
    Fails if a rank exits non-zero, misses the deadline, or loaded jax,
    flax or ray_tpu."""
    src = (textwrap.dedent(_PRELUDE).format(repo=REPO, hang_s=deadline_s - 15)
           + textwrap.dedent(body)
           + textwrap.dedent(_EPILOGUE).format(banned=BANNED))
    script = tmp_path / "rank_main.py"
    script.write_text(src)
    np.savez(tmp_path / "inputs.npz", **(inputs or {"_": np.zeros(1)}))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=rank_env(), cwd=str(tmp_path)) for r in range(world)]
    end = time.monotonic() + deadline_s
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(
                    timeout=max(1.0, end - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.fail(f"a rank missed the {deadline_s} s deadline:\n"
                            + "\n".join(q.communicate()[0] for q in procs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    outs = [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
            for r in range(world)]
    for r, out in enumerate(outs):
        assert out.pop("banned_modules") == [], f"rank {r} loaded them"
    return outs


# ----------------------------------------------------------------------
# collectives against numpy
# ----------------------------------------------------------------------

_COLLECTIVES = '''
from ray_tpu_torch.parallel import collectives as C
from ray_tpu_torch.parallel.mesh import MeshConfig, use_mesh

OPS = {
    "allreduce_sum": lambda x, g: C.allreduce(x, g, "sum"),
    "allreduce_mean": lambda x, g: C.allreduce(x, g, "mean"),
    "allgather_0": lambda x, g: C.allgather(x, g, axis=0),
    "allgather_1": lambda x, g: C.allgather(x, g, axis=1),
    "allgather_untiled": lambda x, g: C.allgather(x, g, axis=1, tiled=False),
    "reducescatter_0": lambda x, g: C.reducescatter(x, g, axis=0),
    "reducescatter_1": lambda x, g: C.reducescatter(x, g, axis=1),
    "broadcast_1": lambda x, g: C.broadcast(x, g, root=1),
    "send_recv_1": lambda x, g: C.send_recv(x, g, 1),
    "send_recv_-1": lambda x, g: C.send_recv(x, g, -1),
    "send_recv_3": lambda x, g: C.send_recv(x, g, 3),
    "all_to_all": lambda x, g: C.all_to_all(x, g, 0, 0),
}
NO_GRAD = {
    "allreduce_max": lambda x, g: C.allreduce(x, g, "max"),
    "allreduce_min": lambda x, g: C.allreduce(x, g, "min"),
}

def main(rank, world, inputs):
    out = {}
    meshes = {"tensor": distributed.global_mesh(MeshConfig(data=2, tensor=2)),
              "seq": distributed.global_mesh(MeshConfig(seq=4))}
    C.reset_stats()
    for axis, mesh in meshes.items():
        with use_mesh(mesh):
            g = C.CollectiveGroup(axis)
            out[axis + "/group"] = (g.world_size(), g.rank())
            out[axis + "/barrier"] = C.barrier(axis)
            for name, op in {**OPS, **NO_GRAD}.items():
                if axis == "tensor" and name == "all_to_all":
                    continue
                x = torch.from_numpy(inputs["x"][rank]).requires_grad_(True)
                y = op(x, g)
                out[f"{axis}/{name}/y"] = y.detach().numpy()
                if name in OPS:
                    w = torch.from_numpy(inputs["w%d" % y.dim()][rank]
                                         [tuple(slice(0, s) for s in y.shape)])
                    (y * w).sum().backward()
                    out[f"{axis}/{name}/grad"] = x.grad.numpy()
                else:
                    out[f"{axis}/{name}/requires_grad"] = y.requires_grad
    out["stats"] = C.stats()
    return out
'''

X_SHAPE = (4, 8)


def _members(axis, rank):
    """The ranks of ``rank``'s group on ``axis`` in coordinate order, for
    the meshes of _COLLECTIVES (data=2 x tensor=2, and seq=4)."""
    if axis == "tensor":
        return [rank - rank % 2, rank - rank % 2 + 1]
    return [0, 1, 2, 3]


def _expected(name, xs, ws, members, me):
    """(y, dL/dx) on member ``me`` for L = sum over members of <w_j, y_j>."""
    n = len(members)
    x = [xs[m] for m in members]
    i = members.index(me)

    def w(j, y_shape):
        return ws[len(y_shape)][members[j]][tuple(slice(0, s)
                                                    for s in y_shape)]

    if name.startswith("allreduce_"):
        how = name.split("_")[1]
        y = {"sum": np.sum, "mean": np.mean, "max": np.max,
             "min": np.min}[how](x, axis=0)
        g = sum(w(j, y.shape) for j in range(n))
        return y, (g / n if how == "mean" else g)
    if name.startswith("allgather_"):
        axis = 1 if name != "allgather_0" else 0
        if name == "allgather_untiled":
            y = np.stack(x, axis=1)
            return y, sum(np.take(w(j, y.shape), i, axis=1)
                          for j in range(n))
        y = np.concatenate(x, axis=axis)
        return y, sum(np.split(w(j, y.shape), n, axis=axis)[i]
                      for j in range(n))
    if name.startswith("reducescatter_"):
        axis = int(name[-1])
        y = np.split(np.sum(x, axis=0), n, axis=axis)[i]
        return y, np.concatenate([w(j, y.shape) for j in range(n)],
                                 axis=axis)
    if name == "broadcast_1":
        y = x[1]
        return y, (sum(w(j, y.shape) for j in range(n)) if i == 1
                   else np.zeros_like(y))
    if name.startswith("send_recv_"):
        s = int(name.split("_")[-1])
        y = x[(i - s) % n]
        return y, w((i + s) % n, y.shape)
    if name == "all_to_all":
        y = np.stack([x[j][i] for j in range(n)])
        return y, np.stack([w(j, y.shape)[i] for j in range(n)])
    raise KeyError(name)


COLLECTIVE_CASES = [(axis, name) for axis in ("tensor", "seq") for name in (
    "allreduce_sum", "allreduce_mean", "allreduce_max", "allreduce_min",
    "allgather_0", "allgather_1", "allgather_untiled", "reducescatter_0",
    "reducescatter_1", "broadcast_1", "send_recv_1", "send_recv_-1",
    "send_recv_3", "all_to_all")
    # an untiled all_to_all splits x's 4 rows into one per member: seq only
    if not (axis == "tensor" and name == "all_to_all")]


@pytest.fixture(scope="module")
def collective_run(tmp_path_factory):
    rng = np.random.default_rng(11)
    inputs = {"x": rng.normal(size=(4,) + X_SHAPE).astype(np.float32),
              "w2": rng.normal(size=(4, 16, 32)).astype(np.float32),
              "w3": rng.normal(size=(4, 4, 4, 8)).astype(np.float32)}
    outs = run_ranks(tmp_path_factory.mktemp("collectives"), _COLLECTIVES,
                     inputs)
    return inputs, outs


@pytest.mark.parametrize("axis, name", COLLECTIVE_CASES)
def test_collective_matches_numpy(collective_run, axis, name):
    inputs, outs = collective_run
    xs = inputs["x"]
    ws = {2: inputs["w2"], 3: inputs["w3"]}
    for rank, out in enumerate(outs):
        members = _members(axis, rank)
        y, g = _expected(name, xs, ws, members, rank)
        np.testing.assert_allclose(out[f"{axis}/{name}/y"], y, rtol=1e-6,
                                   atol=1e-6, err_msg=f"rank {rank}")
        if f"{axis}/{name}/grad" in out:
            np.testing.assert_allclose(out[f"{axis}/{name}/grad"], g,
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {rank} gradient")
        else:
            assert out[f"{axis}/{name}/requires_grad"] is False


def test_groups_barrier_and_byte_counts(collective_run):
    _inputs, outs = collective_run
    for rank, out in enumerate(outs):
        assert out["tensor/group"] == (2, rank % 2)
        assert out["seq/group"] == (4, rank)
        assert out["tensor/barrier"] == 2 and out["seq/barrier"] == 4
        st = out["stats"]
        # every op moved bytes, and nothing went through the host on the CPU
        assert set(st["bytes"]) == {"allreduce", "allgather",
                                    "reducescatter", "broadcast",
                                    "send_recv", "all_to_all"}
        assert all(v > 0 for v in st["bytes"].values())
        assert st["host_bytes"] == 0
        # one send_recv a shift, forward and backward, on both meshes
        assert st["calls"]["send_recv"] == 2 * 3 * 2


# ----------------------------------------------------------------------
# the reference's two-process global mesh
# ----------------------------------------------------------------------

_GLOBAL_MESH = '''
from ray_tpu_torch.parallel import collectives as C
from ray_tpu_torch.parallel.mesh import use_mesh

def main(rank, world, inputs):
    assert distributed.is_initialized()
    mesh = distributed.global_mesh()
    # one global array row-sharded over EVERY mesh axis jointly (8 rows of
    # value row_index); the reduction must see every rank's shard
    x = torch.tensor([[float(r)] * 4 for r in range(8)])
    local = C.local_block(x, (tuple(mesh.axis_names), None), mesh)
    total = local.sum()
    with use_mesh(mesh):
        for axis in mesh.axis_names:
            total = C.allreduce(total, axis)
    return {"shape": mesh.shape, "rows": local[:, 0].tolist(),
            "total": float(total), "backend": distributed.backend(),
            "device": str(distributed.device())}
'''


def test_two_process_global_mesh(tmp_path):
    outs = run_ranks(tmp_path, _GLOBAL_MESH, world=2)
    from ray_tpu.parallel import mesh as jmesh

    want = dict(jmesh.MeshConfig.for_devices(2).axis_sizes())
    for rank, out in enumerate(outs):
        assert out["shape"] == want
        assert out["rows"] == [4.0 * rank + i for i in range(4)]
        # 4 * (0 + 1 + ... + 7), the reference's 112.0
        assert out["total"] == 112.0
        assert out["backend"] == "gloo" and out["device"] == "cpu"


def test_init_multihost_without_a_coordinator_returns_false(monkeypatch):
    from ray_tpu_torch.parallel import distributed

    monkeypatch.delenv("RAY_TPU_JAX_COORDINATOR", raising=False)
    assert distributed.init_multihost() is False
    assert not distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_multihost"):
        distributed.device()


def test_backend_rule():
    from ray_tpu_torch.parallel import distributed

    assert distributed.backend_for(torch.device("cpu"), 4) == "gloo"
    assert distributed._init_method("h:1") == "tcp://h:1"
    assert distributed._init_method("file:///x") == "file:///x"


# ----------------------------------------------------------------------
# logical shardings against the reference's
# ----------------------------------------------------------------------

LOGICAL = [("vocab", "embed"), ("embed", "heads", "head_dim"),
           ("heads", "head_dim", "embed"), ("experts", "embed", "mlp"),
           ("batch", "act_seq", "act_embed"), ("act_embed",), (None, "mlp")]


@pytest.mark.parametrize("axes", LOGICAL)
def test_logical_sharding_matches_reference_spec(axes):
    jax = pytest.importorskip("jax")
    from torch.distributed.tensor import Replicate, Shard

    from ray_tpu.parallel import mesh as jmesh
    from ray_tpu_torch.parallel import mesh as tmesh

    jm = jmesh.make_mesh(jmesh.MeshConfig(data=2, fsdp=2, tensor=2),
                         jax.devices()[:8])
    want = jmesh.logical_sharding(jm, axes).spec
    tm = tmesh.make_mesh(tmesh.MeshConfig(data=2, fsdp=2, tensor=2),
                         ["cpu"] * 8)
    got = tmesh.logical_sharding(tm, axes)
    assert tuple(got.spec) == tuple(want) + (None,) * (len(axes) - len(want))
    for i, name in enumerate(tm.axis_names):
        dims = [d for d, e in enumerate(got.spec) if name in got.axes(d)]
        assert got.placements[i] == (Shard(dims[0]) if dims else Replicate())


# ----------------------------------------------------------------------
# the CLI's rank flags
# ----------------------------------------------------------------------

def test_cli_start_joins_the_process_group(tmp_path):
    """``start --head --jax-coordinator ... --jax-num-processes 2
    --jax-process-id r`` in two processes: both join one group (the join
    blocks until both arrive), then each runs its head until SIGTERM."""
    coord = "file://" + str(tmp_path / "rendezvous")
    env = rank_env(RAY_TPU_TORCH_DIST_DEVICE="cpu",
                   RAY_TPU_TORCH_SCHED_DEVICE="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "start", "--head",
         "--num-workers", "1", "--jax-coordinator", coord,
         "--jax-num-processes", "2", "--jax-process-id", str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp_path)) for r in range(2)]
    lines = {0: [], 1: []}
    readers = [threading.Thread(
        target=lambda r=r, p=p: lines[r].extend(p.stdout), daemon=True)
        for r, p in enumerate(procs)]
    for t in readers:
        t.start()
    try:
        end = time.monotonic() + RANK_DEADLINE_S
        while not all(any("head started" in ln for ln in lines[r])
                      for r in lines):
            assert time.monotonic() < end, f"no heads in time: {lines}"
            assert all(p.poll() is None for p in procs), lines
            time.sleep(0.2)
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            p.wait(timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for t in readers:
        t.join(10)
    for r, p in enumerate(procs):
        assert p.returncode == 0, lines[r]
        assert any(f"rank {r} of 2 joined (gloo on cpu)" in ln
                   for ln in lines[r]), lines[r]
