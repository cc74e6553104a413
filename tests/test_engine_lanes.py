"""Equivalence of the three physics-step implementations.

physics/engine.py is the readable per-env implementation (small per-env
arrays + vmap) that env_step and every differentiable consumer run;
physics/engine_lanes.py is the lane-oriented fast path behind
FusedBatchedEnvs; physics/pallas_step.py runs the same lane substep inside
a Pallas TPU kernel. These tests pin all three to each other: a drift in
any one of them fails here before it can skew golden parity.

Tolerances: the lane translation reorders float accumulations (explicit
x+y+z vs jnp.sum) and evaluates atan2 by polynomial (engine_lanes._atan2,
Mosaic has no native lowering), so agreement is ~1e-7 per step, not bitwise.
Each step both engines restart from the shared state so knife-edge contact
branches cannot legitimately fork trajectories mid-test.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import metaworld_tpu as mw
from metaworld_tpu import vector
from metaworld_tpu.envs.core import env_reset
from metaworld_tpu.physics import engine, engine_lanes, pallas_step

# grasp + static boxes | hinge panel + hook | two objects + nail joint + tool
TASKS = ["pick-place-v3", "door-open-v3", "hammer-v3"]

# env_step (the per-env path every golden/replay test drives) runs
# engine.py, so the lane engines' coverage comes from these pins — one
# task per remaining feature family: fixture press | slide panel |
# hook-on-peg ring | hinge lever bar | planar puck with xy limits
EXTRA_TASKS = ["button-press-topdown-v3", "window-open-v3", "assembly-v3",
               "faucet-open-v3", "plate-slide-v3"]


def _max_field_err(sim_a, sim_b):
    worst, field = 0.0, None
    for f in sim_a.__dataclass_fields__:
        a = np.asarray(getattr(sim_a, f), dtype=np.float64)
        b = np.asarray(getattr(sim_b, f), dtype=np.float64)
        e = float(np.max(np.abs(a - b))) if a.size else 0.0
        if e > worst:
            worst, field = e, f
    return worst, field


@pytest.mark.parametrize("name", TASKS + EXTRA_TASKS)
def test_lanes_matches_reference_engine(name):
    bench = mw.MT1(name, seed=0, num_goals=2)
    spec = bench.train_classes[name]
    table = bench.goal_table(name)
    state, _ = env_reset(spec, jnp.asarray(table[0]), jax.random.PRNGKey(3), 1.0)
    scene = jax.tree.map(jnp.asarray, spec.scene_device)
    step_a = jax.jit(lambda s, a: engine.control_step(scene, s, a))
    step_b = jax.jit(lambda s, a: engine_lanes.control_step(scene, s, a))
    sim = state.sim
    rng = np.random.default_rng(0)
    for t in range(25):
        act = jnp.asarray(rng.uniform(-1, 1, 4).astype(np.float32))
        sim_a = step_a(sim, act)
        sim_b = step_b(sim, act)
        err, field = _max_field_err(sim_a, sim_b)
        assert err < 1e-5, f"{name} t={t}: {field} diverged by {err:.3e}"
        sim = sim_a


@pytest.mark.slow
def test_pallas_kernel_matches_lanes_interpret():
    """The Pallas kernel (interpret mode on CPU) reproduces the lane engine
    on a mixed-task batch — validates the packed row layout, the in-kernel
    unpack, AND the per-block task specialization (block 8 over 3 tasks x 8
    slots yields one pure block per task: objects-only for pick-place,
    fixture-only for door-open, mixed for hammer) against the generic XLA
    path.

    Slow (1007 s in a whole tier-1 run): the port never runs this kernel;
    test_torch_layout.py holds its row layout and block-variant rule to
    pallas_step's, and test_torch_kernel_host.py the port's four kernel
    variants to the plain physics."""
    specs, tables = [], []
    for name in TASKS:
        bench = mw.MT1(name, seed=0, num_goals=2)
        specs.append(bench.train_classes[name])
        tables.append(bench.goal_table(name))
    envs = vector.FusedBatchedEnvs(
        specs=specs, counts=[8, 8, 8], goal_tables=tables,
        goal_visible=True, physics="lanes")
    state, _ = envs.reset(jax.random.PRNGKey(0))
    scene = envs._scene_slots
    vids = pallas_step.block_variants(scene, 24, 8)
    assert len(set(vids)) > 1, "specialization should mix variants here"
    assert vids == (0, 2, 3)  # objects-only | fixture-only | everything
    rng = np.random.default_rng(1)
    # Run each task's 8-slot block through ITS specialized kernel as its
    # own jitted program, against the lane engine on the same slice. One
    # jit per variant keeps interpret-mode compile time bounded (~70 s
    # per kernel); a single program carrying all three interpreted
    # kernels compiled superlinearly (>25 min standalone) for the same
    # coverage.
    for i, vid in enumerate(vids):
        sl = slice(8 * i, 8 * (i + 1))
        scene_i = jax.tree.map(lambda x: x[sl], scene)
        sim_i = jax.tree.map(lambda x: x[sl], state.env.sim)
        rows_i = pallas_step.pack_scene_rows(scene_i)
        step_l = jax.jit(lambda s, a, sc=scene_i:
                         engine_lanes.control_step(sc, s, a))
        step_p = jax.jit(lambda s, a, sc=scene_i, rw=rows_i, v=(vid,):
                         pallas_step.control_step(sc, rw, s, a, block=8,
                                                  interpret=True, variants=v))
        for t in range(2):
            act = jnp.asarray(rng.uniform(-1, 1, (8, 4)).astype(np.float32))
            sim_a = step_l(sim_i, act)
            sim_b = step_p(sim_i, act)
            err, field = _max_field_err(sim_a, sim_b)
            assert err < 1e-4, (
                f"variant {vid} t={t}: {field} diverged by {err:.3e}")
            sim_i = sim_a


def test_polynomial_atan2_accuracy():
    """engine_lanes._atan2 (Mosaic-safe polynomial) vs numpy arctan2 over the
    full circle at several radii."""
    th = np.linspace(-np.pi, np.pi, 721)[:-1]
    for r in (1e-3, 0.1, 1.0, 40.0):
        y = jnp.asarray((r * np.sin(th)).astype(np.float32))
        x = jnp.asarray((r * np.cos(th)).astype(np.float32))
        got = np.asarray(engine_lanes._atan2(y, x), dtype=np.float64)
        want = np.arctan2(np.float64(np.asarray(y)), np.float64(np.asarray(x)))
        assert np.max(np.abs(got - want)) < 5e-6


def test_fused_envs_physics_option():
    """physics="lanes" and the default both step; "auto" resolves by backend."""
    bench = mw.MT1("reach-v3", seed=0, num_goals=2)
    spec = bench.train_classes["reach-v3"]
    envs = vector.FusedBatchedEnvs(
        specs=[spec], counts=[4], goal_tables=[bench.goal_table("reach-v3")],
        goal_visible=True)
    assert envs.physics == ("pallas" if jax.default_backend() == "tpu"
                            else "lanes")
    state, obs = envs.reset(jax.random.PRNGKey(0))
    state, out = envs.step(state, jnp.zeros((4, 4)))
    assert np.isfinite(np.asarray(out["reward"])).all()
