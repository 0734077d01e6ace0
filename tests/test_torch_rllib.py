"""ray_tpu_torch.rllib's pieces against ray_tpu.rllib's, on the CPU.

The same seeded numpy inputs go through the reference and the port:

- exact: the envs' rollouts, the connectors (the parallel-Welford merge
  included) and GAE, whose port copies are numpy;
- f32 1e-5: DiscreteMLP / GaussianMLP apply, logp_entropy and kl on the
  reference's ``PRNGKey`` init loaded through ``params_from_jax``;
- the optimizers (``rllib/optim.py``) against optax's transforms at a
  global norm above the clip and at an RMSprop ``nu`` near 0, where
  ``clip_grad_norm_`` and ``torch.optim.RMSprop`` miss the bound;
- a runner's 32-step x 4-env rollout from the same params and seeds,
  action for action, except at a stated near-tie;
- the frame (device rule, checkpoints, host params to runners) and
  BASELINE config 5's ``perf.rl_rollout_throughput`` on the port's
  runtime in thread mode, every assignment through the scheduler's
  device path on the host (``sched_backend`` "cuda", ``sched_device``
  "cpu").

The algorithms' updates and learning tests are in
tests/test_torch_rllib_algos.py, Train in tests/test_torch_train.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import ray_tpu_torch as ray  # noqa: E402
from ray_tpu.rllib import connectors as jconn  # noqa: E402
from ray_tpu.rllib import core as jcore  # noqa: E402
from ray_tpu.rllib import env as jenv  # noqa: E402
from ray_tpu.rllib import ppo as jppo  # noqa: E402
from ray_tpu_torch import rllib as R  # noqa: E402
from ray_tpu_torch.rllib import connectors as tconn  # noqa: E402
from ray_tpu_torch.rllib import core as tcore  # noqa: E402
from ray_tpu_torch.rllib import env as tenv  # noqa: E402
from ray_tpu_torch.rllib import optim as topt  # noqa: E402
from ray_tpu_torch.rllib import ppo as tppo  # noqa: E402

CPU = dict(device="cpu")
F32 = 1e-5          # the f32 bound of every float comparison here
# a runner's action may differ from the reference's only where its two
# best Gumbel-perturbed logits lie closer than this
NEAR_TIE = 1e-5


@pytest.fixture(scope="module")
def rt():
    ray.shutdown()
    ray.init(num_workers=8, scheduler="tensor",
             _system_config={"sched_backend": "cuda",
                             "sched_device": "cpu"})
    yield ray
    ray.shutdown()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=F32):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# == envs and connectors: exact =============================================

@pytest.mark.parametrize("kind", ["cartpole", "pendulum"])
def test_env_rollouts_bit_identical(kind):
    """300 steps of random actions from each seed: every observation,
    reward and done equal to the reference's, bit for bit."""
    make = {"cartpole": (jenv.CartPoleEnv, tenv.CartPoleEnv),
            "pendulum": (jenv.PendulumEnv, tenv.PendulumEnv)}[kind]
    for seed in (0, 7, 123):
        ja, ta = make[0](seed), make[1](seed)
        np.testing.assert_array_equal(ja.reset(), ta.reset())
        acts = np.random.default_rng(seed)
        for _ in range(300):
            a = (int(acts.integers(0, 2)) if kind == "cartpole"
                 else acts.uniform(-3, 3, size=1).astype(np.float32))
            jo, jr, jd = ja.step(a)
            to, tr, td = ta.step(a)
            np.testing.assert_array_equal(jo, to)
            assert (jr, jd) == (tr, td)
            if jd:
                np.testing.assert_array_equal(ja.reset(), ta.reset())


def test_welford_merge_exact():
    """observe / merge / transform of ObsNormalizer over 4 runners'
    chunks, and a pipeline's observe_and_transform: equal to the
    reference's to the bit (the same numpy arithmetic)."""
    rng = np.random.default_rng(0)
    chunks = [rng.normal(3.0, 2.0, (50, 4)) for _ in range(4)]
    jn, tn = jconn.ObsNormalizer(), tconn.ObsNormalizer()
    js = [jn.observe(c, jn.init_state()) for c in chunks]
    ts = [tn.observe(c, tn.init_state()) for c in chunks]
    jm, tm = jn.merge(js), tn.merge(ts)
    assert jm[0] == tm[0]
    np.testing.assert_array_equal(jm[1], tm[1])
    np.testing.assert_array_equal(jm[2], tm[2])
    np.testing.assert_array_equal(jn.transform(chunks[0], jm),
                                  tn.transform(chunks[0], tm))
    # the merge of parallel streams is the single stream's, exactly as
    # the reference's test holds it (1e-10)
    st = tn.init_state()
    for c in chunks:
        st = tn.observe(c, st)
    assert abs(st[0] - tm[0]) < 1e-9
    np.testing.assert_allclose(st[1], tm[1], rtol=1e-10)
    np.testing.assert_allclose(st[2], tm[2], rtol=1e-10)
    jp = jconn.ConnectorPipeline([jconn.ObsNormalizer(),
                                  jconn.Lambda(lambda o: o * 2)])
    tp = tconn.ConnectorPipeline([tconn.ObsNormalizer(),
                                  tconn.Lambda(lambda o: o * 2)])
    jprior, tprior = jp.init_state(), tp.init_state()
    jd, td = jp.init_state(), tp.init_state()
    for c in chunks:
        jo, jd = jp.observe_and_transform(c, jprior, jd)
        to, td = tp.observe_and_transform(c, tprior, td)
        np.testing.assert_array_equal(jo, to)
    jeff, teff = jp.effective(jprior, jd), tp.effective(tprior, td)
    np.testing.assert_array_equal(jeff[0][1], teff[0][1])


def test_action_connectors_exact():
    a = np.random.default_rng(1).normal(size=(8, 2)).astype(np.float32)
    for jc, tc in ((jconn.ActionClip(-0.5, 0.5), tconn.ActionClip(-0.5, 0.5)),
                   (jconn.ActionRescale(0.0, 2.0),
                    tconn.ActionRescale(0.0, 2.0))):
        np.testing.assert_array_equal(
            jconn.ActionPipeline([jc]).to_env(a),
            tconn.ActionPipeline([tc]).to_env(a))


def _batch(rng, T=16, N=4):
    return {"rewards": rng.normal(size=(T, N)).astype(np.float32),
            "values": rng.normal(size=(T, N)).astype(np.float32),
            "dones": (rng.random((T, N)) < 0.1).astype(np.float32),
            "last_values": rng.normal(size=N).astype(np.float32)}


def test_gae_bit_identical():
    b = _batch(np.random.default_rng(3))
    for gamma, lam in ((0.99, 0.95), (0.9, 1.0)):
        ja, jr = jppo._gae(b, gamma, lam)
        ta, tr = tppo._gae(b, gamma, lam)
        np.testing.assert_array_equal(ja, ta)
        np.testing.assert_array_equal(jr, tr)


# == modules: f32 1e-5 =======================================================

def _modules(kind):
    if kind == "discrete":
        return jcore.DiscreteMLP(4, 3, 16), tcore.DiscreteMLP(4, 3, 16)
    return jcore.GaussianMLP(3, 2, 16), tcore.GaussianMLP(3, 2, 16)


@pytest.mark.parametrize("kind", ["discrete", "gaussian"])
def test_module_apply_logp_kl(kind):
    jm, tm = _modules(kind)
    pj = jm.init(jax.random.PRNGKey(0))
    pj2 = jm.init(jax.random.PRNGKey(1))
    pt, pt2 = (tcore.params_from_jax(_np(p), "cpu") for p in (pj, pj2))
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(32, jm.obs_dim)).astype(np.float32)
    jd = jm.apply(pj, jnp.asarray(obs))
    td = tm.apply(pt, torch.tensor(obs))
    for a, b in zip(jd, td):
        _close(b, a)
    if kind == "discrete":
        acts = rng.integers(0, 3, 32).astype(np.int32)
        tacts = torch.tensor(acts)
    else:
        acts = rng.normal(size=(32, 2)).astype(np.float32)
        tacts = torch.tensor(acts)
    for a, b in zip(jm.logp_entropy(jd, jnp.asarray(acts)),
                    tm.logp_entropy(td, tacts)):
        _close(b, a)
    jd2 = jm.apply(pj2, jnp.asarray(obs))
    td2 = tm.apply(pt2, torch.tensor(obs))
    _close(tm.kl(td, td2), jm.kl(jd, jd2))
    # the runner-side sample from the same dist inputs and rng
    ja, jl = jm.np_sample(tuple(np.asarray(d) for d in jd),
                          np.random.default_rng(5))
    ta, tl = tm.np_sample(tuple(d.numpy() for d in td),
                          np.random.default_rng(5))
    if kind == "gaussian":
        _close(ta, ja)
    else:
        np.testing.assert_array_equal(ta, ja)
    _close(tl, jl)


def test_params_from_jax_keeps_the_tree():
    jm = jcore.GaussianMLP(3, 2, 8)
    pj = _np(jm.init(jax.random.PRNGKey(2)))
    pt = tcore.params_from_jax(pj, "cpu")
    assert set(pt) == {"layers", "log_std"}
    assert all(isinstance(l, tuple) and len(l) == 2 for l in pt["layers"])
    for a, b in zip(jax.tree_util.tree_leaves(pj), topt.tree_leaves(pt)):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(a, b.numpy())


# == optimizers: optax's semantics ==========================================

def _grads(seed, scale):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32)
            for s in ((4, 8), (8,), (8, 3))]


def _rel(got, want):
    return max(float(np.linalg.norm(g - w) / np.linalg.norm(w))
               for g, w in zip(got, want))


def test_clip_by_global_norm_matches_optax():
    """Global norm 0.02 over a clip of 0.01: optax scales by
    max_norm / norm; clip_grad_norm_'s 1e-6 in the denominator misses
    the bound here, so it is not the port's clip. The transform's state
    is the norm before the clip; a clip of 0 gives zeros."""
    g = _grads(0, 1.0)
    norm = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum()) for x in g))
    g = [x * np.float32(0.02 / norm) for x in g]
    jclip = optax.clip_by_global_norm(0.01)
    want, _ = jclip.update([jnp.asarray(x) for x in g], jclip.init(g))
    got, st = topt.clip_by_global_norm(0.01).update(
        [torch.tensor(x) for x in g], ())
    assert _rel([t.numpy() for t in got], _np(want)) < 1e-6
    assert abs(float(st) - 0.02) < 0.02 * F32   # the norm before the clip
    # a clip of 0 zeroes every leaf, as optax's does
    jzero = optax.clip_by_global_norm(0.0)
    want0, _ = jzero.update([jnp.asarray(x) for x in g], jzero.init(g))
    got0, _ = topt.clip_by_global_norm(0.0).update(
        [torch.tensor(x) for x in g], ())
    for a, b in zip(got0, _np(want0)):
        np.testing.assert_array_equal(a.numpy(), b)
        assert not b.any()
    below, _ = topt.clip_by_global_norm(1.0).update(
        [torch.tensor(x) for x in g], ())
    for a, b in zip(below, g):
        np.testing.assert_array_equal(a.numpy(), b)
    ts = [torch.tensor(x) for x in g]
    torch.nn.utils.clip_grad_norm_(ts, 0.01)
    assert _rel([t.numpy() for t in ts], _np(want)) > F32


def test_rmsprop_matches_optax_near_zero_nu():
    """Gradients ~1e-4, so nu ~1e-10 << eps: optax's rsqrt(nu + eps)
    step, 5 steps; torch.optim.RMSprop's sqrt(nu) + eps is far off."""
    lr, steps = 5e-3, 5
    p0 = [x for x in _grads(1, 1.0)]
    gs = [_grads(10 + i, 1e-4) for i in range(steps)]
    jopt = optax.rmsprop(lr, decay=0.99, eps=1e-5)
    jp, js = [jnp.asarray(x) for x in p0], None
    js = jopt.init(jp)
    topt_ = topt.Optimizer(topt.rmsprop(lr, decay=0.99, eps=1e-5))
    tp = [torch.tensor(x) for x in p0]
    ts = topt_.init(tp)
    tref = [torch.tensor(x) for x in p0]
    torch_rms = torch.optim.RMSprop(tref, lr=lr, alpha=0.99, eps=1e-5)
    for g in gs:
        u, js = jopt.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, u)
        tp, ts = topt_.step(tp, [torch.tensor(x) for x in g], ts)
        for p, x in zip(tref, g):
            p.grad = torch.tensor(x)
        torch_rms.step()
    dj = [np.asarray(a) - b for a, b in zip(jp, p0)]
    assert _rel([t.numpy() - b for t, b in zip(tp, p0)], dj) < F32
    assert _rel([t.detach().numpy() - b for t, b in zip(tref, p0)],
                dj) > 0.5


def test_adam_matches_optax():
    lr = 3e-3
    p0 = _grads(2, 1.0)
    gs = [_grads(20 + i, 0.1) for i in range(4)]
    jopt = optax.adam(lr)
    jp = [jnp.asarray(x) for x in p0]
    js = jopt.init(jp)
    o = topt.Optimizer(topt.adam(lr))
    tp = [torch.tensor(x) for x in p0]
    ts = o.init(tp)
    tref = [torch.tensor(x) for x in p0]
    torch_adam = torch.optim.Adam(tref, lr=lr, eps=1e-8)
    for g in gs:
        u, js = jopt.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, u)
        tp, ts = o.step(tp, [torch.tensor(x) for x in g], ts)
        for p, x in zip(tref, g):
            p.grad = torch.tensor(x)
        torch_adam.step()
    # the port's steps within 1e-5 of optax's; torch.optim.Adam's
    # parameters within 1e-5 of optax's (its bias corrections in f64
    # put its steps ~2e-5 apart)
    dj = [np.asarray(a) - b for a, b in zip(jp, p0)]
    assert _rel([t.numpy() - b for t, b in zip(tp, p0)], dj) < F32
    assert _rel([t.detach().numpy() for t in tref], _np(jp)) < F32


def test_tree_helpers_round_trip():
    tree = {"b": [(torch.zeros(2), torch.ones(3))], "a": torch.arange(4.0)}
    leaves = topt.tree_leaves(tree)
    assert [tuple(x.shape) for x in leaves] == [(4,), (2,), (3,)]
    back = topt.tree_unflatten(tree, [x + 1 for x in leaves])
    assert list(back) == ["b", "a"] and isinstance(back["b"][0], tuple)
    np.testing.assert_array_equal(back["a"].numpy(), np.arange(1.0, 5.0))
    with pytest.raises(ValueError):
        topt.tree_unflatten(tree, leaves + [torch.zeros(1)])


# == the runner's rollout ===================================================

def _runner_pair(module_kind, need_dist=False):
    if module_kind == "discrete":
        jm, tm = jcore.DiscreteMLP(4, 2, 32), tcore.DiscreteMLP(4, 2, 32)
        jmake, tmake = jenv.CartPoleEnv, tenv.CartPoleEnv
    else:
        jm, tm = jcore.GaussianMLP(3, 1, 32), tcore.GaussianMLP(3, 1, 32)
        jmake, tmake = jenv.PendulumEnv, tenv.PendulumEnv
    pj = jm.init(jax.random.PRNGKey(4))
    pt = tcore.params_from_jax(_np(pj), "cpu")
    jr = jppo._EnvRunner._cls(jmake, 4, 32, 11, None, jm, None, need_dist)
    tr = tppo._EnvRunner._cls(tmake, 4, 32, 11, None, tm, None, need_dist)
    return jr.sample(pj), tr.sample(pt)


def _first_difference(ja, ta):
    diff = np.argwhere(ja != ta)
    return tuple(diff[0]) if len(diff) else None


def test_runner_rollout_matches_reference():
    """32 steps x 4 CartPoles from the same params and seeds: every
    action equal to the reference's. A difference passes only at a
    near-tie: the reference's two best logits, perturbed by the runner's
    own Gumbel draw for that step, within NEAR_TIE; the trajectories
    part there, so the comparison ends at that step."""
    jb, tb = _runner_pair("discrete", need_dist=True)
    at = _first_difference(jb["actions"], tb["actions"])
    T = jb["actions"].shape[0] if at is None else at[0]
    if at is not None:
        rng = np.random.default_rng(11)     # the runner's seed
        for _ in range(at[0] + 1):
            u = rng.gumbel(size=(4, 2))
        z = np.sort(jb["dist_inputs"][0][at[0], at[1]] + u[at[1]])
        assert z[-1] - z[-2] < NEAR_TIE, (at, z)
    np.testing.assert_array_equal(jb["actions"][:T], tb["actions"][:T])
    np.testing.assert_array_equal(jb["obs"][:T], tb["obs"][:T])
    np.testing.assert_array_equal(jb["rewards"][:T], tb["rewards"][:T])
    np.testing.assert_array_equal(jb["dones"][:T], tb["dones"][:T])
    for key in ("logp", "values"):
        _close(tb[key][:T], jb[key][:T])
    _close(tb["dist_inputs"][0][:T], jb["dist_inputs"][0][:T])
    if at is None:
        _close(tb["last_values"], jb["last_values"])
        np.testing.assert_array_equal(jb["last_obs"], tb["last_obs"])
        assert jb["episode_returns"] == tb["episode_returns"]


def test_gaussian_runner_rollout_matches_reference():
    """The continuous head: raw actions within f32 1e-5 of the
    reference's, rewards and observations then within the same bound."""
    jb, tb = _runner_pair("gaussian")
    _close(tb["actions"], jb["actions"])
    _close(tb["logp"], jb["logp"])
    _close(tb["values"], jb["values"])
    np.testing.assert_allclose(tb["rewards"], jb["rewards"], rtol=1e-4,
                               atol=1e-4)


# == the frame on the port's runtime ========================================

def test_build_without_a_device_needs_the_card():
    """device=None means the card: without one, build() raises, and so
    does every module's init; with device="cpu" the params lie there."""
    from ray_tpu_torch.rllib import dqn as tdqn
    from ray_tpu_torch.rllib import sac as tsac

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is for hosts "
                    "without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        R.PPOConfig(num_env_runners=0).build()
    modules = [R.DiscreteMLP(4, 2, 8), R.GaussianMLP(3, 1, 8),
               tdqn._QModule(4, 2, 8),
               tsac._SACModule(3, 1, 8, -2.0, 2.0)]
    for module in modules:
        with pytest.raises(RuntimeError, match="CUDA"):
            module.init(torch.Generator().manual_seed(0))
        params = module.init(torch.Generator().manual_seed(0), "cpu")
        leaves = topt.tree_leaves(params)
        assert leaves and all(t.device.type == "cpu" for t in leaves)
    with pytest.raises(RuntimeError, match="CUDA"):
        tppo._policy_init(torch.Generator().manual_seed(0), 4, 2, 8)


def test_checkpoint_keeps_learner_state(rt, tmp_path):
    """Params and optimizer state through save/restore (host pickles),
    back on the learner's device, and training goes on from them."""
    algo = R.PPOConfig(num_env_runners=1, num_envs_per_runner=2,
                       rollout_len=16, seed=7, **CPU).build()
    try:
        algo.train()
        path = algo.save_checkpoint(str(tmp_path / "ckpt.pkl"))
        w0 = algo.params["layers"][0][0].clone()
        mu0 = algo.opt_state[1]["mu"][0].clone()
        it = algo.iteration
    finally:
        algo.stop()
    algo2 = R.PPOConfig(num_env_runners=1, num_envs_per_runner=2,
                        rollout_len=16, seed=99, **CPU).build()
    try:
        algo2.restore_checkpoint(path)
        assert algo2.iteration == it
        assert torch.equal(algo2.params["layers"][0][0], w0)
        assert torch.equal(algo2.opt_state[1]["mu"][0], mu0)
        assert algo2.train()["training_iteration"] == it + 1
    finally:
        algo2.stop()


def test_runners_get_host_params(rt):
    """The learner's params cross ray.put as CPU tensors, detached."""
    algo = R.PPOConfig(num_env_runners=1, num_envs_per_runner=2,
                       rollout_len=4, seed=0, **CPU).build()
    try:
        host = tcore.host_copy(algo.params)
        for t in topt.tree_leaves(host):
            assert t.device.type == "cpu" and not t.requires_grad
        b = algo._collect()[0]
        assert b["obs"].shape == (4, 2, 4)
        assert b["actions"].dtype == np.int32
    finally:
        algo.stop()


def test_rl_rollout_throughput_is_baseline_config_5(rt):
    """perf.rl_rollout_throughput on the caller's runtime (the device
    path's plain version): the reference's sizes, 8 updates an
    iteration, each on one runner's 8 envs x 64 steps, the learner where
    the caller names it, and the call's device assigns counted."""
    from ray_tpu_torch._private.perf import rl_rollout_throughput

    r = rl_rollout_throughput(iters=1, device="cpu")
    assert ray.is_initialized()
    assert r["env_steps"] == 8 * 8 * 64
    assert r["env_steps_per_sec"] > 0 and r["seconds"] > 0
    assert r["learner_device"] == "cpu"
    assert len(r["learner_ms_by_iteration"]) == 1
    assert r["learner_ms_per_update"] > 0
    assert r["device_assigns"] > 0 and r["device_assign_errors"] == 0
