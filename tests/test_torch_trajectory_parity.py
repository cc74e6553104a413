"""`metaworld_tpu_torch.trajectory_parity` against the JAX package.

The replay: the port's engine of one slot per golden tape (plain PyTorch
physics), built as `trajectory_parity.replay_engine` builds it, replays the
first 25 recorded actions of reach-v3 and handle-press-v3 (the hand meets
the handle from step 12 and presses it down: a contact on the fixture
joint) against the JAX fused lane engine (`FusedBatchedEnvs(physics=
"lanes")`) built the same way. The run is free (no restart from the JAX
state); it is held at the tolerances of ROADMAP C1 and
tests/test_torch_fused.py all the same: observations (positions) within
1e-5 absolute, success exactly, and the port's reward tails evaluated on
the JAX engine's state within 1e-5 relative or 1e-6 absolute. The rewards
of the free run are held at 2e-4 absolute: handle-press's long-tail
tolerance, whose margin is a few centimetres, turns the runs' 1.8e-7
difference in state (float32 rounding) into up to 8.7e-5 of reward while
the hand presses the handle (steps 10-16). The port's `score` equals the JAX script's on
the same arrays, and its ceiling table is the JAX test's.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaworld_tpu import vector as jvector
from metaworld_tpu.envs import registry as jregistry
from metaworld_tpu_torch import convert
from metaworld_tpu_torch import trajectory_parity as tp
from metaworld_tpu_torch.envs import core
from metaworld_tpu_torch.types import tree_map

ROOT = pathlib.Path(__file__).resolve().parent.parent
NAMES = ["reach-v3", "handle-press-v3"]
STEPS = 25


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "_jax_trajectory_parity", ROOT / "scripts" / "trajectory_parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_replay_matches_jax_lane_engine():
    traces = tp.load_traces(NAMES)
    te = tp.replay_engine(NAMES, traces, "cpu")
    je = jvector.FusedBatchedEnvs(
        [jregistry.get_spec(n) for n in NAMES], [1] * len(NAMES),
        tp.goal_tables(traces), autoreset=False, task_select="pseudorandom",
        physics="lanes")
    acts = np.stack([d["action"][:STEPS] for d in traces], 1).astype(np.float32)
    obs, rew, succ, obs0 = tp.replay(te, torch.from_numpy(acts))
    sj, oj = je._reset_jit(jax.random.PRNGKey(0),
                           jnp.zeros(len(NAMES), jnp.int32))
    np.testing.assert_allclose(obs0.numpy(), np.asarray(oj), rtol=0, atol=1e-6)
    step = jax.jit(je._step_impl)
    for t in range(STEPS):
        prev_obs = convert.fused_from_dict(convert.as_dict(sj), "cpu").env.prev_obs
        sj, out = step(sj, jnp.asarray(acts[t]))
        where = f"step {t}"
        r = np.asarray(out["reward"])
        np.testing.assert_allclose(obs[t].numpy(), np.asarray(out["obs"]),
                                   rtol=0, atol=1e-5, err_msg=where)
        np.testing.assert_allclose(rew[t].numpy(), r, rtol=0, atol=2e-4,
                                   err_msg=where)
        np.testing.assert_array_equal(succ[t].numpy(), np.asarray(out["success"]))
        # the port's tails on the JAX state: the rewards themselves agree
        env = convert.fused_from_dict(convert.as_dict(sj), "cpu").env.replace(
            prev_obs=prev_obs)
        for i, spec in enumerate(te.specs):
            _, o = core.post_step(spec, tree_map(lambda x: x[i:i + 1], env),
                                  torch.from_numpy(acts[t, i:i + 1]))
            np.testing.assert_allclose(o.reward.numpy(), r[i:i + 1], rtol=1e-5,
                                       atol=1e-6, err_msg=where)
    # the contact happened: handle-press's handle moved by the 25th step
    assert abs(obs[-1, 1, 4:7] - obs0[1, 4:7]).max() > 0.01


def test_score_equals_jax_score(monkeypatch):
    jtp = _jax_script()
    rng = np.random.default_rng(3)
    for name in ("reach-v3", "hammer-v3"):
        ours = dict(obs=rng.normal(size=(500, 39)).astype(np.float32),
                    reward=rng.uniform(0, 10, 500).astype(np.float32),
                    success=(rng.uniform(size=500) > 0.9).astype(np.float32))
        ref = dict(obs=rng.normal(size=(500, 39)),
                   reward=rng.uniform(0, 10, 500),
                   success=np.zeros(500) if name == "hammer-v3"
                   else (rng.uniform(size=500) > 0.5).astype(np.float64))
        monkeypatch.setattr(jtp, "rollout", lambda n: (ours, ref))
        assert tp.score(name, ours, ref) == jtp.score(name)


def test_ceilings_equal_the_jax_tests():
    from tests.test_trajectory_parity import CEILINGS

    assert tp.CEILINGS == CEILINGS
    assert set(tp.CEILINGS) == set(tp.registry.ALL_V3_ENVIRONMENTS)


@pytest.mark.parametrize("bad, expect", [
    ({}, []),
    ({"hand_p95": 1.0}, ["hand p95"]),
    ({"obj_p95": 1.0, "rew_mae_rel": 1.0}, ["obj p95", "reward MAE"]),
    ({"succ_ours": 0.0}, ["success agreement"]),
])
def test_over_ceiling_names_each_break(bad, expect):
    s = {"task": "reach-v3", "hand_p95": 0.0, "obj_p95": 0.0,
         "rew_mae_rel": 0.0, "succ_ours": 1.0, "succ_ref": 1.0, **bad}
    got = tp.over_ceiling(s)
    assert len(got) == len(expect)
    assert all(e in g for e, g in zip(expect, got))
