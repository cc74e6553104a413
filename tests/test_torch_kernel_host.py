"""The CUDA kernel's arithmetic, built for the host with g++ from the same
`csrc/substep.cuh`, against the port's plain PyTorch version on one batch
holding all ten MT10 scenes (and, in further cases, the scenes MT25
adds; test_torch_kernel_host_mt50.py holds those MT50 adds).

Each of the four template instantiations (pallas_step's v0..v3) runs the
envs it is sound for, through the same packed-row interface the kernel
uses, for 25 control steps that restart from the plain version's state
(variant v's actions from seed v; the four variants' trajectories of a
batch are stepped together, one plain call per step).
The host build makes no fused multiply-adds, but its sinf/cosf/expf are
glibc's and PyTorch's are its own vectorised ones, so the two can differ by
an ulp. Fields are held at 1e-5 plus 1e-6 of their magnitude; the velocity
fields, finite differences over the 2.5 ms substep, at 1e-4 (gripper_vel,
which is further divided by the 0.1 m opening, at 3e-4), as in
test_torch_physics.py. The host build is test-only (the engine never calls
it).

A second case runs the kernel's own per-block code (`csrc/block_step.cuh`)
over a block table at block = 8 on 20 envs per task, so that blocks
straddle two tasks and every variant is dispatched.
"""

import ctypes
import functools
import shutil

import numpy as np
import pytest
import torch

from metaworld_tpu_torch import benchmarks as tbench
from metaworld_tpu_torch.envs.core import env_reset
from metaworld_tpu_torch.physics import _build, cuda_step
from metaworld_tpu_torch.types import tree_map
from tests.test_torch_physics_mt50 import seek_targets

MT10 = tbench.MT10_LIST
MT25_NEW = [n for n in tbench.MT25_LIST if n not in MT10] + [
    "assembly-v3", "stick-push-v3", "button-press-v3"]
TCP_OFFSET = (0.0044, 0.0015, -0.0498)
TOL = dict(hand_vel=1e-4, obj_vel=1e-4, obj_angvel=1e-4, joint_v=1e-4,
           gripper_vel=3e-4)


@pytest.fixture(scope="module")
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host build cannot be made")
    lib = ctypes.CDLL(str(_build.build_host()))
    lib.mw_host_step.restype = ctypes.c_int
    lib.mw_host_step.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 3
    lib.mw_host_blocks.restype = ctypes.c_int
    lib.mw_host_blocks.argtypes = [ctypes.c_void_p, ctypes.c_int] + [
        ctypes.c_void_p] * 5 + [ctypes.c_int]
    return lib


def _batch(near, per_task=3, names=None, grasp_targets=False):
    """Reset states of `per_task` slots of every MT10 task (MT10 goals), or
    of each task in `names` (MT25 goals, or MT1 for a task outside MT25),
    with the scene table and the per-slot task ids. With `near` every slot
    is parked 3 cm above its seek target, obj_init_pos; with
    `grasp_targets` that target is test_torch_physics_mt50.seek_targets'
    (the reset anchor, the reported position or the grasp point, in turn
    over each task's slots), and the batch carries it in obj_init_pos,
    where the seek mode steers."""
    suite = (tbench.MT10 if names is None else tbench.MT25)(
        seed=0, num_goals=per_task)
    names = names or MT10

    def bench_of(n):
        if n in suite.train_classes:
            return suite
        return tbench.MT1(n, seed=0, num_goals=per_task)

    specs = [bench_of(n).train_classes[n] for n in names]
    table = cuda_step.build_scene_table([s.scene for s in specs], "cpu")
    envs, reported, ids = [], [], []
    for k, spec in enumerate(specs):
        goals = torch.from_numpy(
            bench_of(spec.name).goal_table(spec.name).astype(np.float32))
        st, obs = env_reset(spec, goals, 1.0)
        envs.append(st)
        reported.append(obs[:, 4:7])
        ids += [k] * goals.shape[0]
    env = tree_map(lambda *x: torch.cat(x), *envs)
    if grasp_targets:
        scene = [specs[k].scene for k in ids]
        target = seek_targets(
            env.obj_init_pos[:, 0].numpy(), torch.cat(reported).numpy(),
            env.sim.obj_pos[:, 0].numpy(), np.stack([s.obj_grasp_off[0] for s in scene]),
            np.array([s.obj_exists[0] > 0 for s in scene]), per_task)
        obj_init_pos = env.obj_init_pos.clone()
        obj_init_pos[:, 0] = torch.from_numpy(target)
        env = env.replace(obj_init_pos=obj_init_pos)
    if near:
        goal = env.obj_init_pos[:, 0] + torch.tensor([0.0, 0.0, 0.03])
        env = env.replace(sim=env.sim.replace(
            hand=goal, mocap=goal - torch.tensor(TCP_OFFSET)))
    return table, torch.tensor(ids, dtype=torch.int32), env


def _sound(features, variant):
    flags = cuda_step.VARIANTS[variant]
    ok = np.ones(features.shape[0], bool)
    for col, key in enumerate(("with_objects", "with_joints",
                               "with_hand_boxes")):
        if not flags[key]:
            ok &= ~features[:, col]
    return ok


def plain_steps(table, ids, env, mode, seed):
    """25 control steps of the plain version from the batch `env`, each
    from the last one's result: [(state, action, result)]. The seek mode
    steers to obj_init_pos and closes the grip within 3 cm of it."""
    return plain_steps_many(table, ids, env, mode, [seed])[0]


def plain_steps_many(table, ids, env, mode, seeds):
    """`plain_steps` of one copy of the batch per seed, all copies stepped
    by one plain call per step (the lanes are independent): one list of
    (state, action, result) per seed, each copy's actions drawn from its
    own seed's generator."""
    n, k = ids.shape[0], len(seeds)
    rngs = [np.random.default_rng(seed) for seed in seeds]
    ids_k = ids.repeat(k)
    sim = tree_map(lambda x: torch.cat([x] * k), env.sim)
    steps = [[] for _ in seeds]
    for t in range(25):
        acts = []
        for j, rng in enumerate(rngs):
            act = rng.uniform(-1, 1, (n, 4)).astype(np.float32)
            if mode == "seek":
                d = (env.obj_init_pos[:, 0] - sim.hand[j * n:(j + 1) * n]).numpy()
                act[:, :3] = np.clip(d * 60.0 + 0.3 * act[:, :3], -1, 1)
                act[:, 3] = np.where(np.linalg.norm(d, axis=1) < 0.03, 1.0,
                                     act[:, 3])
            acts.append(act)
        act = torch.from_numpy(np.concatenate(acts))
        ref = cuda_step.plain_control_step(table, ids_k, sim, act)
        for j in range(k):
            part = slice(j * n, (j + 1) * n)
            steps[j].append((tree_map(lambda x: x[part], sim), act[part],
                             tree_map(lambda x: x[part], ref)))
        sim = ref
    return steps


def hold_steps(run, table, ids, steps, mask, what):
    """`run(rows, ctl, out)` fills the packed output rows of each step's
    state and action; held against the plain result on the envs in
    `mask`."""
    for t, (sim, act, ref) in enumerate(steps):
        mocap, target, effort = cuda_step._sim_and_ctl(table, ids, sim, act)
        ctl = torch.cat([target.T, effort[None]]).contiguous()
        rows = cuda_step.pack_sim_rows(sim).contiguous()
        out = torch.full_like(rows, float("nan"))
        run(rows, ctl, out)
        got = cuda_step.unpack_sim_rows(out, mocap)
        for field in ref.__dataclass_fields__:
            a = getattr(ref, field)[mask].double()
            b = getattr(got, field)[mask].double()
            err = (a - b).abs().max().item()
            assert err <= TOL.get(field, 1e-5) + 1e-6 * a.abs().max().item(), (
                f"{what} t={t}: {field} off by {err:.3e}")


def _hold_against_plain(run, table, ids, env, mode, seed, mask, what):
    """25 control steps, each from the plain version's state: `run(rows,
    ctl, out)` fills the packed output rows, held on the envs in `mask`."""
    hold_steps(run, table, ids, plain_steps(table, ids, env, mode, seed), mask,
               f"{what} {mode}")


def variant_runner(host_lib, variant, table, ids):
    """The per-env entry point in `variant` on the envs it is sound for:
    (run, mask) for hold_steps."""
    n = ids.shape[0]
    ok = _sound(table.features[ids.numpy()], variant)
    assert ok.sum() >= 3

    def run(rows, ctl, out):
        for i in np.nonzero(ok)[0]:
            assert host_lib.mw_host_step(
                variant, table.rows.data_ptr(), ids.data_ptr(),
                rows.data_ptr(), ctl.data_ptr(), out.data_ptr(), n,
                int(i), 1) == 0

    return run, torch.from_numpy(ok)


@functools.lru_cache(maxsize=None)
def _variant_trajectories(mode, names):
    """The batch and the plain trajectory of every variant in `mode`,
    variant v's actions from seed v, made in one plain run."""
    table, ids, env = _batch(near=mode == "seek",
                             names=None if names is None else list(names))
    return table, ids, plain_steps_many(table, ids, env, mode, range(4))


def check_variant(host_lib, variant, mode, names=None):
    """The per-env entry point in `variant` on the envs it is sound for."""
    table, ids, trajectories = _variant_trajectories(
        mode, None if names is None else tuple(names))
    run, mask = variant_runner(host_lib, variant, table, ids)
    hold_steps(run, table, ids, trajectories[variant], mask,
               f"v{variant} {mode}")


@pytest.mark.parametrize("mode", ["random", "seek"])
@pytest.mark.parametrize("variant", [0, 1, 2, 3])
def test_host_kernel_matches_plain(host_lib, variant, mode):
    check_variant(host_lib, variant, mode)


@pytest.mark.parametrize("mode", ["random", "seek"])
@pytest.mark.parametrize("variant", [0, 1, 2, 3])
def test_host_kernel_matches_plain_mt25_scenes(host_lib, variant, mode):
    """The eighteen scenes MT25 and its helper tasks add: holes and pits,
    planar slide bodies, the tool link, carry-only hooks, hinged fixtures
    with hooks and the mug's grasp tolerance run as CUDA source here."""
    check_variant(host_lib, variant, mode, names=MT25_NEW)


def check_block_dispatch(host_lib, names, per_task, mode, seed,
                         grasp_targets=False):
    """The kernel's per-block code over a block table at block = 8, against
    the per-env entry point (bit for bit) and the plain version."""
    table, ids, env = _batch(near=mode == "seek", per_task=per_task, names=names,
                             grasp_targets=grasp_targets)
    n = ids.shape[0]
    blocks = cuda_step.block_table(ids.numpy(), table.features, block=8)
    assert min(blocks.blocks_by_variant) > 0
    assert (blocks.host[:, 4] == 2).sum() >= 5  # blocks straddling two tasks

    def run(rows, ctl, out):
        assert host_lib.mw_host_blocks(
            blocks.rows.data_ptr(), blocks.host.shape[0],
            table.rows.data_ptr(), ids.data_ptr(), rows.data_ptr(),
            ctl.data_ptr(), out.data_ptr(), n) == 0
        # each env as the per-env entry point runs it in its block's variant
        per_env = torch.full_like(out, float("nan"))
        for v, first, count, _, _ in blocks.host:
            assert host_lib.mw_host_step(
                int(v), table.rows.data_ptr(), ids.data_ptr(), rows.data_ptr(),
                ctl.data_ptr(), per_env.data_ptr(), n, int(first),
                int(count)) == 0
        assert torch.equal(out, per_env)

    _hold_against_plain(run, table, ids, env, mode, seed,
                        torch.ones(n, dtype=torch.bool), "blocks")


def test_host_block_dispatch_matches_plain(host_lib):
    """Random actions only: in the seek mode this batch reaches a knife-edge
    button press where the host build and the plain version part by an ulp
    of glibc against PyTorch arithmetic (as test_torch_physics.py sees with
    JAX), whichever way the block is dispatched."""
    check_block_dispatch(host_lib, MT10, 20, "random", 4)


@pytest.mark.parametrize("mode", ["random", "seek"])
def test_host_block_dispatch_matches_plain_mt25(host_lib, mode):
    check_block_dispatch(host_lib, tbench.MT25_LIST, 12, mode, 5)
