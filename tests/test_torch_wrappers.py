"""The port's wrappers against the JAX package's, on the same numpy inputs.

* RunningStat, DiscountedRewardNorm, ExponentialRewardNorm and
  ObservationNorm over 50 updates: running means at 1e-6 absolute plus
  1e-5 relative, variances at 1e-5 relative, counts and flags exactly,
  normalised rewards at 1e-5 relative to the batch's largest. Both sides
  reduce float32 batches, in different orders.
* ObservationNorm's normalised output on columns whose running variance
  exceeds VAR_FLOOR at 1e-4 absolute. Columns below it (constant or
  near-constant: a hidden goal's zeros, padded slots) divide a difference
  of about one float32 ulp of the mean by sqrt(var + 1e-8) ~ 1e-4; there
  they are held at 1e-2 and their worst difference is printed.
* RNNMetaRLAugment exactly; PseudoRandomGoals by its cycle (its draws come
  from a torch.Generator and cannot equal threefry's, C4 of ROADMAP.md).
* EnvPipeline with all three options against the JAX EnvPipeline: MT10, 1
  slot per task, pinned goal rows, max_episode_steps=10, 30 steps of
  numpy-seeded random actions; and the port started from the JAX
  pipeline's state at step 15 through `convert`. The physics of the two
  sides agree to about 1e-5 per step (test_torch_fused.py), which the
  observation norm scales by 1/sqrt(var + 1e-8): observations are held at
  PIPE_OBS_ATOL times that scale on columns above VAR_FLOOR (the worst
  seen is 4.2e-6 of it), the observation norm's variances at 1e-4
  relative (2.6e-5 seen), rewards at 1e-4 relative to the step's largest
  (3.2e-6 seen), done exactly. Columns that stay constant fall below
  VAR_FLOOR after 10 steps; they agree exactly.
* checkpoint / restore bit for bit through random-mode autoresets, with
  the engine's generator carried; without it the next random goal draws
  differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metaworld_tpu as jmw
import metaworld_tpu_torch as tmw
from metaworld_tpu import wrappers as jw
from metaworld_tpu_torch import convert
from metaworld_tpu_torch import wrappers as tw

UPDATES = 50
VAR_FLOOR = 1e-6
LOW_VAR_ATOL = 1e-2
PIPE_STEPS = 30
PIPE_OBS_ATOL = 1e-5
PIPE_KW = dict(reward_normalization_method="gymnasium",
               normalize_observations=True, recurrent_info_in_obs=True)


def _close_stat(st, sj, where):
    np.testing.assert_allclose(st.mean.numpy(), np.asarray(sj.mean), rtol=1e-5,
                               atol=1e-6, err_msg=f"{where}: mean")
    np.testing.assert_allclose(st.var.numpy(), np.asarray(sj.var), rtol=1e-5,
                               atol=0, err_msg=f"{where}: var")
    assert float(st.count) == float(sj.count), where


def _obs_batch(rng, n, d):
    """Wide columns, exact zeros (a hidden goal), a constant and a
    near-constant column."""
    scale = rng.uniform(0, 2, d).astype(np.float32)
    obs = rng.normal(size=(n, d)).astype(np.float32) * scale + 0.3
    obs[:, 0:3] = 0.0
    obs[:, 3:6] = np.float32(0.1)
    obs[:, 6] = np.float32(0.1) + rng.normal(size=n).astype(np.float32) * 1e-7
    return obs


def _close_norm_obs(ot, oj, var, where):
    hi = np.asarray(var) > VAR_FLOOR
    err = np.abs(np.asarray(ot) - np.asarray(oj))
    assert np.all(err[:, hi] <= 1e-4), f"{where}: {err[:, hi].max():.3e}"
    low = float(err[:, ~hi].max(initial=0.0))
    assert low <= LOW_VAR_ATOL, f"{where}: low-variance columns off by {low:.3e}"
    return low


def test_running_stat_matches_jax():
    rng = np.random.default_rng(0)
    for shape in ((16,), (8, 39)):
        sj = jw.RunningStat.create(shape[1:])
        st = tw.RunningStat.create(shape[1:], device="cpu")
        for i in range(UPDATES):
            b = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
            sj, st = sj.update(jnp.asarray(b)), st.update(torch.from_numpy(b))
            _close_stat(st, sj, f"{shape} update {i}")


def test_discounted_reward_norm_matches_jax():
    rng = np.random.default_rng(1)
    nj, nt = jw.DiscountedRewardNorm(16), tw.DiscountedRewardNorm(16, device="cpu")
    sj, st = nj.init(), nt.init()
    for i in range(UPDATES):
        r = (rng.normal(size=16) * 5 + 2).astype(np.float32)
        d = (rng.random(16) < 0.1).astype(np.float32)
        sj, rj = nj(sj, jnp.asarray(r), jnp.asarray(d))
        st, rt = nt(st, torch.from_numpy(r), torch.from_numpy(d))
        np.testing.assert_allclose(st.returns.numpy(), np.asarray(sj.returns),
                                   rtol=1e-6, atol=1e-6)
        _close_stat(st.stat, sj.stat, f"update {i}")
        rj = np.asarray(rj)
        np.testing.assert_allclose(rt.numpy(), rj, rtol=0,
                                   atol=1e-5 * np.abs(rj).max())


def test_exponential_reward_norm_matches_jax():
    rng = np.random.default_rng(2)
    nj, nt = jw.ExponentialRewardNorm(), tw.ExponentialRewardNorm(device="cpu")
    sj, st = nj.init(), nt.init()
    for i in range(UPDATES):
        r = (rng.normal(size=16) * 5 + 2).astype(np.float32)
        sj, rj = nj(sj, jnp.asarray(r))
        st, rt = nt(st, torch.from_numpy(r))
        assert bool(st.initialized) and bool(sj.initialized)
        np.testing.assert_allclose(float(st.mean), float(sj.mean), rtol=1e-5)
        np.testing.assert_allclose(float(st.var), float(sj.var), rtol=1e-5)
        rj = np.asarray(rj)
        np.testing.assert_allclose(rt.numpy(), rj, rtol=0,
                                   atol=1e-5 * np.abs(rj).max())


def test_observation_norm_matches_jax():
    rng = np.random.default_rng(3)
    nj, nt = jw.ObservationNorm(55), tw.ObservationNorm(55, device="cpu")
    sj, st = nj.init(), nt.init()
    low = 0.0
    for i in range(UPDATES):
        obs = _obs_batch(rng, 10, 55)
        sj, oj = nj(sj, jnp.asarray(obs))
        st, ot = nt(st, torch.from_numpy(obs))
        _close_stat(st.stat, sj.stat, f"update {i}")
        low = max(low, _close_norm_obs(ot, oj, sj.stat.var, f"update {i}"))
    print(f"low-variance columns: normalised output off by at most {low:.3e}")


def test_rnn_augment_matches_jax():
    rng = np.random.default_rng(4)
    for normalize in (False, True):
        aj = jw.RNNMetaRLAugment(8, normalize)
        at = tw.RNNMetaRLAugment(8, normalize, device="cpu")
        sj, st = aj.init(), at.init()
        for _ in range(UPDATES):
            obs = rng.normal(size=(8, 39)).astype(np.float32)
            np.testing.assert_array_equal(at.augment(st, torch.from_numpy(obs)).numpy(),
                                          np.asarray(aj.augment(sj, jnp.asarray(obs))))
            act = rng.uniform(-1, 1, (8, 4)).astype(np.float32)
            r = rng.normal(size=8).astype(np.float32)
            d = rng.random(8) < 0.2
            sj = aj.update(sj, jnp.asarray(act), jnp.asarray(r), jnp.asarray(d))
            st = at.update(st, torch.from_numpy(act), torch.from_numpy(r),
                           torch.from_numpy(d))
        assert at.augment(st, torch.zeros(8, 39)).shape == (8, 45)


def test_pseudo_random_goals_cycle():
    """Every goal once per epoch, reshuffled afterwards; a slot that does
    not advance keeps its goal."""
    pr = tw.PseudoRandomGoals(num_envs=4, n_goals=5, device="cpu")
    st = pr.init(0)
    seen = [[] for _ in range(4)]
    for _ in range(10):
        st, idx = pr.next_goal(st, torch.ones(4, dtype=torch.bool))
        for i, v in enumerate(idx.tolist()):
            seen[i].append(v)
    for s in seen:
        assert sorted(s[:5]) == [0, 1, 2, 3, 4]
        assert sorted(s[5:]) == [0, 1, 2, 3, 4]
    assert any(s[:5] != s[5:] for s in seen)
    mask = torch.tensor([True, False, True, False])
    st2, a = pr.next_goal(st, mask)
    _, b = pr.next_goal(st2, mask)
    assert b[1] == a[1] and b[3] == a[3]
    # the same seed draws the same permutations
    assert torch.equal(pr.init(0).perm, pr.init(0).perm)


def _mt10_pair():
    kw = dict(seed=0, num_goals=5, envs_per_task=1, use_one_hot=True,
              max_episode_steps=10, task_select="pseudorandom", **PIPE_KW)
    pj = jmw.make_mt_envs("MT10", physics="lanes", **kw)
    pt = tmw.make_mt_envs("MT10", physics="torch", device="cpu", **kw)
    return pj, pt


def _close_pipe(out_t, out_j, onorm_var, where):
    var = np.asarray(onorm_var)
    scale = 1.0 / np.sqrt(var + 1e-8)
    hi = var > VAR_FLOOR
    err = np.abs(out_t["obs"].numpy() - np.asarray(out_j["obs"]))
    tol = PIPE_OBS_ATOL * scale + 1e-5
    assert np.all(err[:, hi] <= tol[hi]), (
        f"{where}: obs off by {(err[:, hi] / tol[hi]).max():.2f} x tolerance")
    rj = np.asarray(out_j["reward"])
    np.testing.assert_allclose(out_t["reward"].numpy(), rj, rtol=0,
                               atol=1e-4 * np.abs(rj).max() + 1e-6, err_msg=where)
    np.testing.assert_array_equal(out_t["done"].numpy(), np.asarray(out_j["done"]))
    return float(err[:, ~hi].max(initial=0.0))


def test_pipeline_matches_jax():
    pj, pt = _mt10_pair()
    assert pt.obs_dim == pj.obs_dim == 39 + 10 + 6
    assert pt.task_names == pj.task_names
    sj, oj = pj.reset(jax.random.PRNGKey(0))
    st, ot = pt.reset(seed=0)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=1e-4)
    rng = np.random.default_rng(5)
    acts = rng.uniform(-1, 1, (PIPE_STEPS, pt.num_envs, 4)).astype(np.float32)
    low = 0.0
    mid = None
    for t in range(PIPE_STEPS):
        sj, out_j = pj.step(sj, jnp.asarray(acts[t]))
        st, out_t = pt.step(st, torch.from_numpy(acts[t]))
        low = max(low, _close_pipe(out_t, out_j, sj[2].stat.var, f"t={t}"))
        _close_stat(st[1].stat, sj[1].stat, f"t={t} reward norm")
        np.testing.assert_allclose(st[2].stat.var.numpy(), np.asarray(sj[2].stat.var),
                                   rtol=1e-4, err_msg=f"t={t} obs var")
        if t == PIPE_STEPS // 2 - 1:
            mid = sj
    print(f"low-variance columns: normalised obs off by at most {low:.3e}")

    # the port continues the JAX pipeline's run from its state at step 15
    parts = [None if p is None else convert.as_dict(p) for p in mid]
    st = convert.pipeline_state_from_dicts(*parts, device="cpu")
    assert isinstance(st[1].stat, tw.RunningStat)
    _close_stat(st[2].stat, mid[2].stat, "converted obs norm")
    sj = mid
    for t in range(PIPE_STEPS // 2, PIPE_STEPS):
        sj, out_j = pj.step(sj, jnp.asarray(acts[t]))
        st, out_t = pt.step(st, torch.from_numpy(acts[t]))
        _close_pipe(out_t, out_j, sj[2].stat.var, f"from JAX state, t={t}")
        np.testing.assert_array_equal(st[3].prev_done.numpy(),
                                      np.asarray(sj[3].prev_done))


def test_convert_reward_norms():
    nj = jw.ExponentialRewardNorm()
    sj, _ = nj(nj.init(), jnp.arange(4.0))
    st = convert.reward_norm_from_dict(convert.as_dict(sj), device="cpu")
    assert isinstance(st, tw.ExponentialRewardNormState)
    assert st.initialized.dtype == torch.bool and bool(st.initialized)
    assert float(st.var) == float(sj.var)
    rs = convert.running_stat_from_dict(convert.as_dict(jw.RunningStat.create((3,))),
                                        device="cpu")
    assert rs.mean.shape == (3,) and float(rs.count) == np.float32(1e-4)


def _run(pipe, state, acts):
    outs = []
    for a in acts:
        state, out = pipe.step(state, a)
        outs.append((out["obs"], out["reward"], out["done"]))
    return state, outs


def test_checkpoint_roundtrip_through_random_autoresets():
    """Checkpoint the engine state, the three wrapper states and the
    engine's generator; the restored run is bit-equal through autoresets
    that draw goal rows at random."""
    pipe = tmw.make_mt_envs("MT10", seed=0, num_goals=50, envs_per_task=3,
                            use_one_hot=True, max_episode_steps=4, device="cpu",
                            **PIPE_KW)
    assert pipe.task_select == "random"
    state, _ = pipe.reset(seed=0)
    rng = np.random.default_rng(6)
    acts = [torch.from_numpy(rng.uniform(-1, 1, (pipe.num_envs, 4)).astype(np.float32))
            for _ in range(14)]
    state, _ = _run(pipe, state, acts[:3])
    blob = tw.checkpoint(state[0], state[1:], envs=pipe)
    assert isinstance(blob, bytes)
    goals_before = state[0].env.rand_vec.clone()
    end, ref = _run(pipe, state, acts[3:])
    # the window crossed autoresets that drew new goal rows
    assert not torch.equal(end[0].env.rand_vec, goals_before)

    v2, w2 = tw.restore(state[0], blob, state[1:], envs=pipe)
    _, again = _run(pipe, (v2, *w2), acts[3:])
    for t, (a, b) in enumerate(zip(ref, again)):
        for x, y in zip(a, b):
            assert torch.equal(x, y), f"step {t}"

    # without the generator's state the next random draws differ
    v3, w3 = tw.restore(state[0], blob, state[1:])
    end3, _ = _run(pipe, (v3, *w3), acts[3:])
    assert not torch.equal(end3[0].env.rand_vec, end[0].env.rand_vec)


def test_restore_checks_the_template():
    envs = tmw.make_mt_envs("reach-v3", seed=0, num_goals=2, envs_per_task=4,
                            device="cpu")
    state, _ = envs.reset()
    blob = tw.checkpoint(state)
    again = tw.restore(state, blob)
    assert torch.equal(again.env.sim.hand, state.env.sim.hand)
    other, _ = tmw.make_mt_envs("reach-v3", seed=0, num_goals=2, envs_per_task=2,
                                device="cpu").reset()
    with pytest.raises(ValueError):
        tw.restore(other, blob)
