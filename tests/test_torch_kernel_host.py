"""The CUDA kernel's arithmetic, built for the host with g++ from the same
`csrc/substep.cuh`, against the port's plain PyTorch version on one batch
holding all ten MT10 scenes.

Each of the four template instantiations (pallas_step's v0..v3) runs the
envs it is sound for, through the same packed-row interface the kernel
uses, for 25 control steps that restart from the plain version's state.
The host build makes no fused multiply-adds, but its sinf/cosf/expf are
glibc's and PyTorch's are its own vectorised ones, so the two can differ by
an ulp. Fields are held at 1e-5 plus 1e-6 of their magnitude; the velocity
fields, finite differences over the 2.5 ms substep, at 1e-4 (gripper_vel,
which is further divided by the 0.1 m opening, at 3e-4), as in
test_torch_physics.py. The host build is test-only (the engine never calls
it).
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from metaworld_tpu_torch import benchmarks as tbench
from metaworld_tpu_torch.envs.core import env_reset
from metaworld_tpu_torch.physics import _build, cuda_step
from metaworld_tpu_torch.types import tree_map

MT10 = tbench.MT10_LIST
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
    return lib


def _batch(near):
    bench = tbench.MT10(seed=0, num_goals=3)
    specs = [bench.train_classes[n] for n in MT10]
    table = cuda_step.build_scene_table([s.scene for s in specs], "cpu")
    envs, ids = [], []
    for k, spec in enumerate(specs):
        goals = torch.from_numpy(bench.goal_table(spec.name).astype(np.float32))
        st, _ = env_reset(spec, goals, 1.0)
        envs.append(st)
        ids += [k] * goals.shape[0]
    env = tree_map(lambda *x: torch.cat(x), *envs)
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


@pytest.mark.parametrize("mode", ["random", "seek"])
@pytest.mark.parametrize("variant", [0, 1, 2, 3])
def test_host_kernel_matches_plain(host_lib, variant, mode):
    table, ids, env = _batch(near=mode == "seek")
    n = ids.shape[0]
    ok = _sound(table.features[ids.numpy()], variant)
    assert ok.sum() >= 3
    rng = np.random.default_rng(variant)
    sim = env.sim
    for t in range(25):
        act = rng.uniform(-1, 1, (n, 4)).astype(np.float32)
        if mode == "seek":
            d = (env.obj_init_pos[:, 0] - sim.hand).numpy()
            act[:, :3] = np.clip(d * 60.0 + 0.3 * act[:, :3], -1, 1)
            act[:, 3] = np.where(np.linalg.norm(d, axis=1) < 0.03, 1.0,
                                 act[:, 3])
        act = torch.from_numpy(act)
        ref = cuda_step.plain_control_step(table, ids, sim, act)
        mocap, target, effort = cuda_step._sim_and_ctl(table, ids, sim, act)
        ctl = torch.cat([target.T, effort[None]]).contiguous()
        rows = cuda_step.pack_sim_rows(sim).contiguous()
        out = torch.full_like(rows, float("nan"))
        for i in np.nonzero(ok)[0]:
            assert host_lib.mw_host_step(
                variant, table.rows.data_ptr(), ids.data_ptr(),
                rows.data_ptr(), ctl.data_ptr(), out.data_ptr(), n,
                int(i), 1) == 0
        got = cuda_step.unpack_sim_rows(out, mocap)
        mask = torch.from_numpy(ok)
        for field in ref.__dataclass_fields__:
            a = getattr(ref, field)[mask].double()
            b = getattr(got, field)[mask].double()
            err = (a - b).abs().max().item()
            assert err <= TOL.get(field, 1e-5) + 1e-6 * a.abs().max().item(), (
                f"v{variant} {mode} t={t}: {field} off by {err:.3e}")
        sim = ref
