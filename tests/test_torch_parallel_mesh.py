"""ray_tpu_torch.parallel.mesh against ray_tpu.parallel.mesh, on the CPU:
the same axis names, configurations, default decompositions and logical
rules; a mesh of torch devices shaped like JAX's; the per-context mesh
stack."""

import contextvars
import dataclasses
import threading

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from ray_tpu.parallel import mesh as jmesh  # noqa: E402
from ray_tpu_torch.parallel import mesh as tmesh  # noqa: E402

CONFIGS = [dict(), dict(seq=4), dict(fsdp=2, seq=2, tensor=2),
           dict(data=2, fsdp=2, pipe=1, expert=2)]


def test_axis_names_match():
    for name in ("AXIS_DATA", "AXIS_FSDP", "AXIS_TENSOR", "AXIS_SEQ",
                 "AXIS_PIPE", "AXIS_EXPERT"):
        assert getattr(tmesh, name) == getattr(jmesh, name)


@pytest.mark.parametrize("cfg", CONFIGS)
def test_mesh_config_matches(cfg):
    t, j = tmesh.MeshConfig(**cfg), jmesh.MeshConfig(**cfg)
    assert t.axis_sizes() == j.axis_sizes()
    assert t.num_devices == j.num_devices


@pytest.mark.parametrize("n", range(1, 17))
def test_for_devices_matches(n):
    assert (dataclasses.asdict(tmesh.MeshConfig.for_devices(n))
            == dataclasses.asdict(jmesh.MeshConfig.for_devices(n)))


def test_default_logical_rules_match():
    assert tmesh.default_logical_rules() == jmesh.default_logical_rules()


@pytest.mark.parametrize("cfg", CONFIGS[:3])
def test_make_mesh_shape_matches_jax(cfg):
    n = tmesh.MeshConfig(**cfg).num_devices
    got = tmesh.make_mesh(tmesh.MeshConfig(**cfg), ["cpu"] * n)
    want = jmesh.make_mesh(jmesh.MeshConfig(**cfg), jax.devices()[:n])
    assert got.shape == dict(want.shape)
    assert list(got.shape) == list(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert got.devices.shape == want.devices.shape
    assert all(d == torch.device("cpu") for d in got.devices.ravel())


def test_make_mesh_defaults_and_repeated_devices():
    mesh = tmesh.make_mesh(devices=["cpu"] * 8)
    assert mesh.shape == dict(tmesh.MeshConfig.for_devices(8).axis_sizes())
    seq = tmesh.make_mesh(tmesh.MeshConfig(seq=4), [torch.device("cpu")] * 4)
    assert seq.shape["seq"] == 4 and seq.devices.size == 4


def test_make_mesh_rejects_a_count_mismatch():
    with pytest.raises(ValueError, match="needs 4 devices, got 3"):
        tmesh.make_mesh(tmesh.MeshConfig(seq=4), ["cpu"] * 3)


def test_make_mesh_without_devices_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default devices are valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh(tmesh.MeshConfig())


def test_use_mesh_nests():
    a = tmesh.make_mesh(tmesh.MeshConfig(seq=2), ["cpu"] * 2)
    b = tmesh.make_mesh(tmesh.MeshConfig(), ["cpu"])
    assert tmesh.current_mesh() is None
    with tmesh.use_mesh(a) as entered:
        assert entered is a and tmesh.current_mesh() is a
        with tmesh.use_mesh(b):
            assert tmesh.current_mesh() is b
        assert tmesh.current_mesh() is a
    assert tmesh.current_mesh() is None


def test_use_mesh_is_per_context():
    """Another thread, or another context, does not see this context's
    mesh, and its own mesh does not leak back."""
    a = tmesh.make_mesh(tmesh.MeshConfig(seq=2), ["cpu"] * 2)
    b = tmesh.make_mesh(tmesh.MeshConfig(), ["cpu"])
    seen = {}

    def other():
        seen["before"] = tmesh.current_mesh()
        with tmesh.use_mesh(b):
            seen["inside"] = tmesh.current_mesh()

    with tmesh.use_mesh(a):
        t = threading.Thread(target=other)
        t.start()
        t.join()
        assert tmesh.current_mesh() is a
        contextvars.Context().run(other)
        assert tmesh.current_mesh() is a
    assert seen == {"before": None, "inside": b}
