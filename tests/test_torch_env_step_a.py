"""The port's per-env step, `envs.core.env_step` with the plain physics,
against the JAX package's per-env `env_step` (which runs the readable
`physics/engine.py`). The 50 tasks are dealt over five files,
test_torch_env_step_a.py to _e.py (`tasks(part)`: every fifth task from
the part's index), ten each: pytest-xdist's loadfile schedule runs a
file on one worker, so five short files spread over the workers where one
long file would hold one of them.

Per task, from the reset of its first MT1(seed=0) goal: two slots, one
driven by seeded random actions and one by the task's JAX scripted expert,
for 25 steps of the JAX step; each step the port restarts from the JAX
state and takes the same actions. A file's tasks run together
(`check_part`): the port's plain physics takes one call per step over all
their slots, then `envs.core.step_tail` finishes each task's step, and on
the first and last steps `env_step` itself must equal that bit for bit;
each task's test reports its own result. The JAX step is `env_step`'s body
(`metaworld_tpu/envs/core.py:207-238`) with its physics,
`engine.control_step`, jitted once per process for every task (the scene
is an argument) and its tail, `post_step`, jitted per task: tracing and
compiling the whole per-env step anew for each task would cost about 8 s
a task.

Tolerances: positions, quaternions, joints, flags and forces 1e-5,
velocities 1e-4 and gripper_vel 3e-4 (the finite differences of
test_torch_physics.py), each plus 1e-6 of the field's magnitude;
observations, the previous observation and rewards 1e-4. Where the port
disagrees with the jitted JAX step on a slot, that slot's step is rerun
eagerly (`jax.disable_jit`, the JAX `env_step` itself): the reference
must then disagree with itself and the port is held to the eager result
(ROADMAP C1). On the tasks of `ENGINES_DIFFER` the JAX package's own two
physics engines disagree beyond these tolerances on a state the expert
reaches (ROADMAP C2); there the port, which is the lane engine's
counterpart, is held to the JAX lane engine's step
(`engine_lanes.control_step`, then the same guard and `post_step`), and
that step must disagree with `engine.py`'s.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaworld_tpu import benchmarks as jbench
from metaworld_tpu.envs import registry as jreg
from metaworld_tpu.envs.core import env_reset as j_env_reset
from metaworld_tpu.envs.core import env_step as j_env_step
from metaworld_tpu.envs.core import post_step as j_post_step
from metaworld_tpu.physics import engine as j_engine
from metaworld_tpu.physics import engine_lanes as j_lanes
from metaworld_tpu.policies import get_policy as j_get_policy
from metaworld_tpu_torch import convert
from metaworld_tpu_torch.envs import core as tcore
from metaworld_tpu_torch.envs import registry as treg
from metaworld_tpu_torch.physics import cuda_step
from metaworld_tpu_torch.types import tree_map
from tests.jax_step import OUT_TOL, TOL, guarded_step

STEPS = 25
# task -> where engine.py and engine_lanes.py part (ROADMAP C2)
ENGINES_DIFFER = {
    "soccer-v3": "expert slot, step 13: the rolling ball's obj_angvel "
                 "-3.335197 (engine.py) against -3.335088 (engine_lanes.py)",
}


def tasks(part: int) -> list:
    """The tasks of file `part` (0 for _a.py ... 4 for _e.py)."""
    return jreg.ALL_V3_ENVIRONMENTS[part::5]


_control = jax.jit(j_engine.control_step)
_lane_control = jax.jit(j_lanes.control_step)


def _lane_physics(scene, sim, act):
    """engine_lanes.control_step on one env (it takes a batch)."""
    one = jax.tree.map(lambda x: jnp.asarray(x)[None], (scene, sim, act))
    return jax.tree.map(lambda x: x[0], _lane_control(*one))


def _bad(ref_state, ref_out, state, out):
    """{slot: (field, error)} where the port's (state, out) is outside
    tolerance of the reference's."""
    bad = {}

    def check(name, ref, got, tol, rel):
        ref = np.asarray(ref, np.float64).reshape(np.shape(ref)[0], -1)
        err = np.abs(ref - np.asarray(got, np.float64).reshape(ref.shape))
        over = err > tol + rel * np.abs(ref)
        for i in np.nonzero(over.any(axis=1))[0]:
            bad.setdefault(int(i), (name, float(err[i].max())))

    dr, dt = convert.as_dict(ref_state), convert.as_dict(state)
    for k, v in dr["sim"].items():
        check("sim." + k, v, dt["sim"][k], TOL.get(k, 1e-5), 1e-6)
    check("prev_obs", dr["prev_obs"], dt["prev_obs"], OUT_TOL, 0.0)
    check("path_length", dr["path_length"], dt["path_length"], 0.0, 0.0)
    do, dp = convert.as_dict(ref_out), convert.as_dict(out)
    for k in ("obs", "reward", "unscaled_reward", "success", "near_object",
              "grasp_success", "grasp_reward", "in_place_reward",
              "obj_to_target"):
        check(k, do[k], dp[k], OUT_TOL, 0.0)
    return bad


def _one(tree, i):
    return jax.tree.map(lambda x: x[i], tree)


def _batch1(tree):
    return jax.tree.map(lambda x: jnp.asarray(x)[None], tree)


def _slice(tree, i):
    return tree.map(lambda x: x[i:i + 1])


def _references(name, spec, post, state, act):
    """The other JAX evaluations of one step that the rules admit, cheapest
    first: for ENGINES_DIFFER tasks the lane engine's step (jitted), then
    the eager reruns (C1)."""
    if name in ENGINES_DIFFER:
        yield "lane engine", guarded_step(_lane_physics, spec, post, state, act)
    with jax.disable_jit():
        eager = j_env_step(spec, state, jnp.asarray(act))
    yield "eager engine.py", eager
    if name in ENGINES_DIFFER:
        with jax.disable_jit():
            eager = guarded_step(_lane_physics, spec, post, state, act)
        yield "eager lane engine", eager


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _stack(trees):
    return jax.tree.map(lambda *x: np.stack(x), *trees)


def _jax_case(name):
    """The JAX side of one task: the spec, the jitted post_step and expert,
    and the reset state and observation of two slots at the task's first
    MT1(seed=0) goal."""
    spec = jreg.get_spec(name)
    vec = jbench.MT1(name, seed=0, num_goals=1).train_tasks[0].rand_vec
    rand = np.zeros(12)
    rand[: vec.shape[0]] = vec
    st, obs = j_env_reset(spec, jnp.asarray(rand), jax.random.PRNGKey(0), 1.0)
    return types.SimpleNamespace(
        name=name, spec=spec, post=jax.jit(functools.partial(j_post_step, spec)),
        expert=jax.jit(j_get_policy(name)), rng=np.random.default_rng(0),
        state=_stack([_host(st)] * 2), obs=np.stack([np.asarray(obs)] * 2))


def _check_case(case, t, new_j, out_j, new_t, out_t, act):
    """Raises AssertionError where a slot of the port's step is outside
    tolerance of the jitted JAX step and of every admitted reference that
    itself differs from the jitted step."""
    for i, (field, err) in _bad(new_j, out_j, new_t, out_t).items():
        jitted = (_batch1(_one(new_j, i)), _batch1(_one(out_j, i)))
        port = (_slice(new_t, i), _slice(out_t, i))
        tried = []
        for what, ref in _references(case.name, case.spec, case.post,
                                     _one(case.state, i), act[i]):
            ref = tuple(map(_batch1, ref))
            if _bad(*ref, *jitted):
                tried.append(what)
                if not _bad(*ref, *port):
                    break
        else:
            raise AssertionError(
                f"{case.name} t={t} slot {i}: {field} off by {err:.3e}; the "
                f"admitted references that differ from the jitted step: {tried}")


def _same(a, b):
    """Bit-equality of two port results, (EnvState, StepOut) each."""
    def eq(x, y):
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(eq(x[k], y[k]) for k in x)
        return np.array_equal(x, y)

    return all(eq(convert.as_dict(x), convert.as_dict(y)) for x, y in zip(a, b))


@functools.lru_cache(maxsize=None)
def check_part(part: int) -> dict:
    """{task: None or the first failure} over the tasks of `part`, two
    slots each (random, expert), for STEPS steps, the port restarting from
    the JAX state each step. The port's physics runs once per step over
    all the part's slots (`plain_control_step` on a table of its scenes,
    the slots being independent), then `step_tail` per task; on the first
    and the last step `env_step` itself runs each task and must give the
    same result bit for bit."""
    names = tasks(part)
    cases = [_jax_case(n) for n in names]
    specs = [treg.get_spec(n) for n in names]
    table = cuda_step.build_scene_table([s.scene for s in specs], "cpu")
    ids = torch.arange(len(names), dtype=torch.int32).repeat_interleave(2)
    failed = {}
    for t in range(STEPS):
        acts = [np.stack([c.rng.uniform(-1, 1, 4),
                          np.asarray(c.expert(c.obs[1]))]).astype(np.float32)
                for c in cases]
        ref = [_stack([_host(guarded_step(_control, c.spec, c.post,
                                          _one(c.state, i), a[i]))
                       for i in range(2)]) for c, a in zip(cases, acts)]
        with torch.inference_mode():
            states = [convert.env_from_dict(convert.as_dict(c.state), "cpu")
                      for c in cases]
            act_t = torch.from_numpy(np.concatenate(acts))
            sim = cuda_step.plain_control_step(
                table, ids, tree_map(lambda *x: torch.cat(x), *[s.sim for s in states]),
                act_t)
            for k, (c, spec, st, (new_j, out_j)) in enumerate(
                    zip(cases, specs, states, ref)):
                a = act_t[2 * k:2 * k + 2]
                new_t, out_t = tcore.step_tail(
                    spec, st, tree_map(lambda x: x[2 * k:2 * k + 2], sim), a)
                if c.name in failed:
                    continue
                try:
                    if t in (0, STEPS - 1):
                        assert _same(tcore.env_step(spec, st, a, physics="torch"),
                                     (new_t, out_t)), \
                            f"{c.name} t={t}: env_step differs from step_tail"
                    _check_case(c, t, new_j, out_j, new_t, out_t, acts[k])
                except AssertionError as e:
                    failed[c.name] = str(e)
        for c, (new_j, out_j) in zip(cases, ref):
            c.state, c.obs = new_j, out_j.obs
    return {n: failed.get(n) for n in names}


def check_env_step(name):
    """`name`'s result in its part's run (see check_part)."""
    part = next(p for p in range(5) if name in tasks(p))
    err = check_part(part)[name]
    assert err is None, err


@pytest.mark.parametrize("name", tasks(0))
def test_env_step_matches_jax(name):
    check_env_step(name)
