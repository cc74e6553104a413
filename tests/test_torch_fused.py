"""The slice as a whole: the port's FusedBatchedEnvs (plain PyTorch physics)
against the JAX package's FusedBatchedEnvs(physics="lanes") on MT10 with 3
slots per task, one-hot ids, pinned goal rows (task_select="pseudorandom",
the same numpy-chosen goal_idx on both sides) and max_episode_steps=4, so
every slot crosses NEXT_STEP autoreset twice.

Ten steps restart the port from the JAX state (through `convert`) and
compare all 14 outputs and the next state; ten more run free. Observations
are held at 1e-5; rewards, returns and metrics at 1e-5 relative or 1e-6
absolute; flags and counters exactly; state fields as in
test_torch_physics.py (velocities, finite differences over 2.5 ms, at 1e-4,
gripper_vel at 3e-4, everything else at 1e-5, each plus 1e-6 of its
magnitude).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaworld_tpu import benchmarks as jbench
from metaworld_tpu import vector as jvector
from metaworld_tpu_torch import benchmarks as tbench
from metaworld_tpu_torch import convert
from metaworld_tpu_torch import vector as tvector

MT10 = jbench.MT10_LIST
KW = dict(goal_visible=True, one_hot=True, max_episode_steps=4,
          task_select="pseudorandom")
EXACT = ("terminated", "truncated", "done", "episode_length", "success",
         "grasp_success")
STATE_TOL = dict(hand_vel=1e-4, obj_vel=1e-4, obj_angvel=1e-4, joint_v=1e-4,
                 gripper_vel=3e-4)


@pytest.fixture(scope="module")
def engines():
    jb, tb = jbench.MT10(seed=0, num_goals=5), tbench.MT10(seed=0, num_goals=5)
    return make_engines(jb, tb, MT10, 3)


def _compare_state(sj, st, where):
    dj, dt = convert.as_dict(sj), convert.as_dict(st)

    def walk(a, b, path):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], path + "." + k)
            return
        a64, b64 = a.astype(np.float64), b.astype(np.float64)
        leaf = path.rsplit(".", 1)[-1]
        tol = STATE_TOL.get(leaf, 1e-5) + 1e-6 * np.abs(a64)
        err = np.abs(a64 - b64)
        assert np.all(err <= tol), f"{where}: {path} off by {err.max():.3e}"

    walk(dj, dt, "state")


def _compare_out(oj, ot, where):
    assert set(ot) == set(oj) == set(tvector.OUT_KEYS)
    for k in oj:
        a, b = np.asarray(oj[k]), ot[k].numpy()
        assert a.shape == b.shape, k
        if k in EXACT:
            np.testing.assert_array_equal(b.astype(np.float64), a.astype(np.float64),
                                          err_msg=f"{where}: {k}")
        elif k == "obs":
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=where)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{where}: {k}")


def make_engines(jb, tb, names, per_task):
    """The JAX and the port's fused engines over `names`, `per_task` slots
    each, and the JAX step jitted."""
    je = jvector.FusedBatchedEnvs(
        [jb.train_classes[n] for n in names], [per_task] * len(names),
        [jb.goal_table(n) for n in names], physics="lanes", **KW)
    te = tvector.FusedBatchedEnvs(
        [tb.train_classes[n] for n in names], [per_task] * len(names),
        [tb.goal_table(n) for n in names], physics="torch", device="cpu", **KW)
    return je, te, jax.jit(je._step_impl)


def check_fused(je, te, step_j, n_goals, steps=20, restart=None, crossings=2):
    """Pinned goal rows on both sides; the first `restart` steps (half by
    default) restart the port from the JAX state, the rest run free. Every
    slot must cross autoreset `crossings` times. Returns the port's states
    after each step."""
    restart = steps // 2 if restart is None else restart
    rng = np.random.default_rng(0)
    gidx = rng.integers(0, n_goals, te.num_envs).astype(np.int32)
    sj, oj = je._reset_jit(jax.random.PRNGKey(0), jnp.asarray(gidx))
    st, ot = te.reset(goal_idx=torch.from_numpy(gidx))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=1e-6)
    _compare_state(sj, st, "reset")
    resets = 0
    states = []
    for t in range(steps):
        act = rng.uniform(-1, 1, (te.num_envs, 4)).astype(np.float32)
        if t < restart:  # restart from the shared state
            st = convert.fused_from_dict(convert.as_dict(sj), "cpu")
        resets += int(np.asarray(sj.pending_reset).sum())
        sj, out_j = step_j(sj, jnp.asarray(act))
        st, out_t = te.step(st, torch.from_numpy(act))
        where = f"t={t} ({'restart' if t < restart else 'free'})"
        _compare_out(out_j, out_t, where)
        _compare_state(sj, st, where)
        states.append(st)
    assert resets >= crossings * te.num_envs  # every slot crossed autoreset
    return states


def test_fused_step_matches_jax(engines):
    check_fused(*engines, n_goals=5)


def test_episode_length_wraps_after_done(engines):
    """NEXT_STEP autoreset: the step after a done returns the reset and
    restarts the count at 1; the reset state's path length is 0, so the
    following episode runs max_episode_steps steps after that one."""
    _, te, _ = engines
    st, _ = te.reset(goal_idx=torch.zeros(te.num_envs, dtype=torch.int32))
    lengths, dones = [], []
    for _ in range(10):
        st, out = te.step(st, torch.zeros(te.num_envs, 4))
        lengths.append(out["episode_length"].clone())
        dones.append(out["done"].clone())
    lengths, dones = torch.stack(lengths), torch.stack(dones)
    assert lengths[:, 0].tolist() == [1, 2, 3, 4, 1, 2, 3, 4, 5, 1]
    assert [i for i, d in enumerate(dones[:, 0].tolist()) if d] == [3, 8]
    assert torch.equal(lengths, lengths[:, :1].expand_as(lengths))


def test_random_goal_draws_stay_in_table(engines):
    _, te, _ = engines
    rows = te._reset_rows(torch.zeros(te.num_envs, dtype=torch.int32))
    lo = te._slot_goal_off
    assert bool(((rows >= lo) & (rows < lo + 5)).all())


def test_physics_option_resolves_by_device(engines):
    _, te, _ = engines
    assert te.physics == "torch" and te.device.type == "cpu"
    tb = tbench.MT1("reach-v3", seed=0, num_goals=2)
    with pytest.raises(ValueError):
        tvector.FusedBatchedEnvs([tb.train_classes["reach-v3"]], [2],
                                 [tb.goal_table("reach-v3")], physics="cuda",
                                 device="cpu")


def test_gym_vector_batch_matches_jax_facade(engines):
    """The port's GymVectorBatch against the JAX package's over the same
    engines: after one sample_tasks round both reset onto the same pinned
    goal rows, and over the same seeded actions, across the autoreset at 4
    steps, they give the same observations, rewards, flags, infos and
    final_info (the tolerances above) with the same dtypes; get_attr
    agrees."""
    from metaworld_tpu import gym_adapter as jgym
    from metaworld_tpu_torch import gym_adapter as tgym

    je, te, _ = engines
    jb, tb = jgym.GymVectorBatch(je, seed=11), tgym.GymVectorBatch(te, seed=11)
    for name in ("task_name", "terminate_on_success"):
        assert tb.get_attr(name) == jb.get_attr(name)
    for b in (jb, tb):
        b.reset()
        b.call("toggle_sample_tasks_on_reset", False)
        b.call("sample_tasks")
    (oj, _), (ot, _) = jb.reset(), tb.reset()
    np.testing.assert_array_equal(tb._state.goal_idx.numpy(),
                                  np.asarray(jb._state.goal_idx))
    assert ot.dtype == oj.dtype
    np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-6)
    rng = np.random.default_rng(0)
    done = []
    for t in range(6):
        act = rng.uniform(-1, 1, (te.num_envs, 4)).astype(np.float32)
        (*main_j, info_j), (*main_t, info_t) = jb.step(act), tb.step(act)
        assert info_t.keys() == info_j.keys()
        out_j, out_t = ({k: v for k, v in info.items() if k != "final_info"}
                        for info in (info_j, info_t))
        for k, vj, vt in zip(("obs", "reward", "terminated", "truncated"),
                             main_j, main_t):
            out_j[k], out_t[k] = vj, vt
        for k in out_j:
            assert out_t[k].dtype == out_j[k].dtype, (t, k)
        _compare_out(out_j, {k: torch.from_numpy(v) for k, v in out_t.items()},
                     f"t={t}")
        fj, ft = info_j["final_info"], info_t["final_info"]
        assert ft.keys() == fj.keys() and ft["episode"].keys() == fj["episode"].keys()
        for vt, vj in ((ft["episode"]["r"], fj["episode"]["r"]),
                       (ft["episode"]["l"], fj["episode"]["l"]),
                       (ft["success"], fj["success"])):
            assert vt.dtype == vj.dtype
            np.testing.assert_allclose(vt, vj, rtol=1e-5, atol=1e-6,
                                       err_msg=f"t={t}: final_info")
        done.append(bool(out_t["done"].any()))
    assert done == [False, False, False, True, False, False]
