"""The PyTorch port's data layout against the JAX package: MT10 scene rows
and goal tables (bit-equal), the packed lane rows of the physics kernel,
per-block kernel variants, the kernel header's row offsets, and the state
converter."""

import dataclasses
import pathlib
import re
import types as pytypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaworld_tpu import benchmarks as jbench
from metaworld_tpu.envs import registry as jregistry
from metaworld_tpu.envs.core import env_reset as j_env_reset
from metaworld_tpu.physics import pallas_step
from metaworld_tpu_torch import benchmarks as tbench
from metaworld_tpu_torch import convert
from metaworld_tpu_torch.envs import registry as tregistry
from metaworld_tpu_torch.physics import cuda_step
from metaworld_tpu_torch.types import SceneParams, tree_map

MT10 = jbench.MT10_LIST
CSRC = pathlib.Path(cuda_step.__file__).resolve().parent.parent / "csrc"


def _jax_reset_batch(names, per_task=2, seed=0):
    """JAX reset states of `per_task` slots of each task, stacked, with the
    per-slot scene rows."""
    bench = jbench.MT10(seed=seed, num_goals=per_task)
    sims, scenes, envs = [], [], []
    for n in names:
        spec = bench.train_classes[n]
        table = bench.goal_table(n)
        for g in range(per_task):
            st, _ = j_env_reset(spec, jnp.asarray(table[g]),
                                jax.random.PRNGKey(g), 1.0)
            envs.append(st)
            scenes.append(spec.scene_device)
    env = jax.tree.map(lambda *x: jnp.stack(x), *envs)
    scene = jax.tree.map(lambda *x: np.stack(x), *scenes)
    return env, scene


@pytest.mark.parametrize("name", MT10)
def test_scene_rows_bit_equal(name):
    a = tregistry.get_spec(name).scene
    b = jregistry.get_spec(name).scene
    for f in dataclasses.fields(SceneParams):
        x, y = getattr(a, f.name), np.asarray(getattr(b, f.name))
        assert x.dtype == y.dtype, (name, f.name)
        np.testing.assert_array_equal(x, y, err_msg=f"{name}.{f.name}")


@pytest.mark.parametrize("seed", [0, 42])
def test_goal_tables_bit_equal(seed):
    a, b = tbench.MT10(seed=seed), jbench.MT10(seed=seed)
    for name in MT10:
        x, y = a.goal_table(name), b.goal_table(name)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_pack_rows_match_pallas():
    """State rows pack bit-equal to pallas_step.pack_sim_rows and unpack back
    to pallas_step.unpack_sim_rows; scene rows match pack_scene_rows (the
    derived rows -- exp, sqrt -- to float32 rounding)."""
    env, scene = _jax_reset_batch(MT10)
    sim_j = env.sim
    rows_j = np.asarray(pallas_step.pack_sim_rows(sim_j))
    sim_t = convert.sim_from_dict(convert.as_dict(sim_j), "cpu")
    rows_t = cuda_step.pack_sim_rows(sim_t)
    assert rows_t.shape == (cuda_step.SIM_ROWS, 20) == rows_j.shape
    np.testing.assert_array_equal(rows_t.numpy(), rows_j)

    back_j = pallas_step.unpack_sim_rows(jnp.asarray(rows_j), sim_j.mocap)
    back_t = cuda_step.unpack_sim_rows(rows_t, sim_t.mocap)
    dj, dt = convert.as_dict(back_j), convert.as_dict(back_t)
    for k in dj:
        np.testing.assert_array_equal(dt[k], dj[k].astype(np.float32),
                                      err_msg=k)

    sc_j = np.asarray(pallas_step.pack_scene_rows(
        jax.tree.map(jnp.asarray, scene)))
    sc_t = cuda_step.pack_scene_rows(tree_map(
        lambda a: convert._tensor(a, "cpu"),
        convert.scene_from_dict(convert.as_dict(scene))))
    assert sc_t.shape == (cuda_step.SC_ROWS, 20) == sc_j.shape
    np.testing.assert_allclose(sc_t.numpy(), sc_j, rtol=2e-7, atol=0)


def test_scene_table_rows_are_task_rows():
    """The kernel's (n_tasks, SC_ROWS) table holds one packed row per task,
    equal to the per-slot packing of that task's slots."""
    specs = [tregistry.get_spec(n) for n in MT10]
    table = cuda_step.build_scene_table([s.scene for s in specs], "cpu")
    assert table.rows.shape == (10, cuda_step.SC_ROWS)
    _, scene = _jax_reset_batch(MT10, per_task=1)
    per_slot = cuda_step.pack_scene_rows(tree_map(
        lambda a: convert._tensor(a, "cpu"),
        convert.scene_from_dict(convert.as_dict(scene))))
    np.testing.assert_array_equal(table.rows.numpy(), per_slot.T.numpy())


def _bench_layout_scene(n_envs):
    """Per-slot feature arrays of bench.py's MT10 layout (numpy views)."""
    base, rem = divmod(n_envs, 10)
    counts = [base + (1 if i < rem else 0) for i in range(10)]
    fields = ("obj_exists", "joint_exists", "static_exists",
              "static_blocks_hand")
    parts = {f: [] for f in fields}
    for name, c in zip(MT10, counts):
        sc = jregistry.get_spec(name).scene
        for f in fields:
            a = np.asarray(getattr(sc, f))
            parts[f].append(np.broadcast_to(a, (c,) + a.shape))
    return pytypes.SimpleNamespace(
        **{f: np.concatenate(v) for f, v in parts.items()})


@pytest.mark.parametrize("n_envs,block", [(30, 8), (131072, 128),
                                          (131072, 2048), (1000, 128)])
def test_block_variants_match_pallas(n_envs, block):
    scene = _bench_layout_scene(n_envs)
    n_pad = -(-n_envs // block) * block
    want = pallas_step.block_variants(scene, n_pad, block)
    got = cuda_step.block_variants(cuda_step.scene_features(scene), block)
    assert got == want
    runs = cuda_step.variant_runs(got, n_envs, block)
    assert sum(c for _, _, c in runs) == n_envs
    assert [v for v, _, _ in runs] == [v for v, *_ in
                                       pallas_step._variant_runs(want)]


def test_kernel_header_row_offsets():
    """csrc/substep.cuh's ScRow/SimRow enums are the spec's row offsets."""
    src = (CSRC / "substep.cuh").read_text()

    def enum(name):
        body = re.search(r"enum %s : int \{(.*?)\};" % name, src, re.S).group(1)
        return {k: int(v) for k, v in re.findall(r"(\w+)\s*=\s*(\d+)", body)}

    sc = enum("ScRow")
    off = cuda_step.spec_offsets(cuda_step.SC_SPEC)
    rename = {"table_z": "TABLE_Z_ROW"}
    for name, first in off.items():
        assert sc[rename.get(name, name.upper())] == first, name
    assert sc["SC_ROWS"] == cuda_step.SC_ROWS == 198
    sim = enum("SimRow")
    for name, first in cuda_step.spec_offsets(cuda_step.SIM_SPEC).items():
        assert sim["R_" + name.upper()] == first, name
    assert sim["SIM_ROWS"] == cuda_step.SIM_ROWS == 63


def test_convert_round_trips():
    env, scene = _jax_reset_batch(MT10)
    d = convert.as_dict(env)
    assert "rng" not in d
    env_t = convert.env_from_dict(d, "cpu")
    d2 = convert.as_dict(env_t)

    def check(a, b, path=""):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                check(a[k], b[k], path + "." + k)
        else:
            np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=path)

    check(d, d2)
    s = convert.scene_from_dict(convert.as_dict(scene))
    for f in dataclasses.fields(SceneParams):
        np.testing.assert_array_equal(getattr(s, f.name),
                                      np.asarray(getattr(scene, f.name)))
