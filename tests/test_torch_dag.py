"""ray_tpu_torch.dag on the CPU: tests/test_dag_snapshot_dashboard.py's
TestCompiledDag cases on the port's runtime (thread mode, the scheduler's
device path on the host), each compiled result equal to the interpreted
one. The reference's fusion case becomes the port's rule on the host: the
CUDA-graph path takes CUDA tensors only, so "auto" runs CPU tensors on the
direct path and "always" refuses them; the capture itself runs on the card
(chip_smoke.py, phase dag)."""

import time

import pytest

torch = pytest.importorskip("torch")

import ray_tpu_torch as ray  # noqa: E402
from ray_tpu_torch.dag import (DAGCaptureError, InputNode,  # noqa: E402
                               MultiOutputNode)


@pytest.fixture
def rt():
    ray.shutdown()
    ray.init(num_workers=4, scheduler="tensor",
             _system_config={"sched_device": "cpu"})
    yield ray
    ray.shutdown()


class TestCompiledDag:
    def test_interpreted_execution(self, rt):
        @ray.remote
        def double(x):
            return x * 2

        @ray.remote
        def inc(x):
            return x + 1

        with InputNode() as inp:
            dag = inc.bind(double.bind(inp))
        assert dag.execute(20) == 41
        assert dag.experimental_compile().execute(20) == 41

    def test_compiled_pure_function_chain_fuses(self, rt):
        """On the host the chain runs on the direct path under "auto" (no
        CUDA input, no capture), and "always" refuses the CPU input."""
        @ray.remote
        def scale(x):
            return x * 2.0

        @ray.remote
        def shift(x):
            return x + 1.0

        with InputNode() as inp:
            dag = shift.bind(scale.bind(inp))
        compiled = dag.experimental_compile()
        x = torch.ones(4)
        assert not compiled.fuses((x,))
        out = compiled.execute(x)
        assert float(out.sum()) == 12.0
        assert torch.equal(out, dag.execute(x))
        assert compiled._graphs == {}   # nothing captured
        always = dag.experimental_compile(fuse_jit="always")
        with pytest.raises(ValueError, match="CUDA tensor"):
            always.execute(x)
        with pytest.raises(ValueError, match="fuse_jit"):
            dag.experimental_compile(fuse_jit="sometimes")

    def test_compiled_fallback_for_non_jax(self, rt):
        @ray.remote
        def stringify(x):
            return f"<{x}>"

        with InputNode() as inp:
            dag = stringify.bind(inp)
        compiled = dag.experimental_compile()
        assert not compiled.fuses((7,))
        assert compiled.execute(7) == "<7>" == dag.execute(7)

    def test_compiled_actor_chain(self, rt):
        @ray.remote
        class Model:
            def __init__(self, w):
                self.w = w

            def forward(self, x):
                return x * self.w

        @ray.remote
        def post(y):
            return y + 5

        m = Model.remote(3)
        with InputNode() as inp:
            dag = post.bind(m.forward.bind(inp))
        compiled = dag.experimental_compile()
        assert compiled.execute(4) == 17
        assert dag.execute(4) == 17  # interpreted path agrees
        with pytest.raises(ValueError, match="all-function"):
            dag.experimental_compile(fuse_jit="always")
        ray.kill(m)

    def test_diamond_executes_shared_node_once(self, rt):
        calls = []

        @ray.remote
        def base(x):
            calls.append(1)
            return x + 1

        @ray.remote
        def left(x):
            return x * 2

        @ray.remote
        def right(x):
            return x * 3

        @ray.remote
        def join(a, b):
            return a + b

        with InputNode() as inp:
            shared = base.bind(inp)
            dag = join.bind(left.bind(shared), right.bind(shared))
        # (x+1)*2 + (x+1)*3 with base evaluated ONCE
        assert dag.execute(4) == 25
        assert len(calls) == 1
        assert dag.experimental_compile().execute(4) == 25
        assert len(calls) == 2

    def test_multi_output_node(self, rt):
        @ray.remote
        def double(x):
            return x * 2

        @ray.remote
        def square(x):
            return x * x

        with InputNode() as inp:
            dag = MultiOutputNode([double.bind(inp), square.bind(inp)])
        assert dag.execute(5) == [10, 25]
        compiled = dag.experimental_compile()
        assert list(compiled.execute(6)) == [12, 36] == dag.execute(6)

    def test_compiled_faster_than_interpreted(self, rt):
        """The point of compilation: repeated small calls skip per-call
        scheduling/store overhead (reference: aDAG's pitch)."""
        @ray.remote
        def f(x):
            return x + 1

        with InputNode() as inp:
            dag = f.bind(f.bind(f.bind(inp)))
        compiled = dag.experimental_compile(fuse_jit="never")
        for _ in range(5):  # warm both paths
            dag.execute(0)
            compiled.execute(0)
        t0 = time.perf_counter()
        for _ in range(50):
            dag.execute(0)
        interp = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(50):
            assert compiled.execute(0) == 3
        comp = time.perf_counter() - t0
        assert comp < interp, (comp, interp)


def test_a_node_that_fails_under_capture_is_named(rt):
    """The capture path's error names the node that failed (the reference
    falls back silently; the port raises). Driven here without a card
    through the fused path's node loop, as it runs inside a capture."""
    @ray.remote
    def fine(x):
        return x + 1

    @ray.remote
    def syncs_the_host(x):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    with InputNode() as inp:
        dag = syncs_the_host.bind(fine.bind(inp))
    compiled = dag.experimental_compile()
    with pytest.raises(DAGCaptureError, match="syncs_the_host"):
        compiled._run((torch.ones(2),), capturing=True)
    # outside a capture the node's own error comes through unchanged
    with pytest.raises(RuntimeError, match="not permitted") as info:
        compiled._run((torch.ones(2),), capturing=False)
    assert not isinstance(info.value, DAGCaptureError)


def test_bind_builds_nodes(rt):
    @ray.remote
    def f(x):
        return x

    @ray.remote
    class A:
        def m(self, x):
            return x

    from ray_tpu_torch.dag import ActorMethodNode, FunctionNode

    a = A.remote()
    assert isinstance(f.bind(1), FunctionNode)
    assert isinstance(a.m.bind(1), ActorMethodNode)
    assert a.m.bind(1).name == "m"
    ray.kill(a)
