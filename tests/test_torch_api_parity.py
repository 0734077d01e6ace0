"""Top-level names of the JAX package that the port carries too, on the CPU.

``dag.bind_function`` and ``dag.bind_method`` (``ray_tpu/dag/__init__.py``)
build the nodes ``.bind()`` builds: in each package the same DAG built
both ways gives equal results, interpreted and compiled, and equal to the
other package's. ``protocol.make_hello`` (``ray_tpu/_private/protocol.py``)
gives the versioned tuple hello that ``split_hello`` parses back, in both
packages, with the same version and fields.
"""

import importlib

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _init(pkg):
    ray = importlib.import_module(pkg)
    ray.shutdown()
    if pkg == "ray_tpu_torch":
        ray.init(num_workers=4, scheduler="tensor",
                 _system_config={"sched_device": "cpu"})
    else:
        ray.init(num_workers=4, scheduler="tensor")
    return ray, importlib.import_module(f"{pkg}.dag")


def _results(pkg):
    """One DAG (an actor method between two functions) built with .bind()
    and with bind_function / bind_method: (interpreted, compiled) of
    each."""
    ray, dag_mod = _init(pkg)
    try:
        @ray.remote
        def double(x):
            return x * 2

        @ray.remote
        def post(y, bias=0):
            return y + bias

        @ray.remote
        class Model:
            def __init__(self, w):
                self.w = w

            def forward(self, x):
                return x * self.w

        m = Model.remote(3)
        with dag_mod.InputNode() as inp:
            by_bind = post.bind(m.forward.bind(double.bind(inp)), bias=5)
        with dag_mod.InputNode() as inp:
            by_fn = dag_mod.bind_function(
                post, dag_mod.bind_method(
                    m.forward, dag_mod.bind_function(double, inp)), bias=5)
        assert type(by_fn) is type(by_bind)
        assert type(by_fn._args[0]) is type(by_bind._args[0])
        assert by_fn._kwargs == by_bind._kwargs == {"bias": 5}
        out = {name: (d.execute(4), d.experimental_compile().execute(7))
               for name, d in (("bind", by_bind), ("functions", by_fn))}
        ray.kill(m)
        return out
    finally:
        ray.shutdown()


def test_bind_functions_build_the_same_dag_in_both_packages():
    got = {pkg: _results(pkg) for pkg in PACKAGES}
    for pkg, out in got.items():
        assert out["functions"] == out["bind"] == (29, 47), pkg
    assert got["ray_tpu_torch"] == got["ray_tpu"]


@pytest.mark.parametrize("fields", [(), (3, "task"), ("node", b"\x01", 7)])
def test_make_hello_round_trips_in_both_packages(fields):
    versions = set()
    for pkg in PACKAGES:
        protocol = importlib.import_module(f"{pkg}._private.protocol")
        hello = protocol.make_hello(*fields)
        assert hello[0] == "hello"
        version, back = protocol.split_hello(hello)
        assert version == protocol.PROTOCOL_VERSION and back == fields
        versions.add(version)
    assert len(versions) == 1
