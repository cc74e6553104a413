"""Drives the PyTorch port's main path on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Three paths, MT10, MT25 and MT50, each laid out as bench.py lays out MT10:
N = 131072 slots split evenly over the tasks, one-hot ids; then ML45's
two splits. Phases, each printing its numbers on its own line; any
failure exits non-zero before the result line:

  1. the card: name and power limit (nvidia-smi), torch's device name;
  2. build of the physics kernel from metaworld_tpu_torch/csrc with nvcc
     (one translation unit), printing its build time, what `-Xptxas -v`
     reports, and the kernel's registers and local (stack and spill) bytes
     per thread, its shared memory per block and the blocks an SM holds at
     once;
  3. MT10: kernel vs its plain PyTorch version at N = 131072, 5 control
     steps, each from the plain version's state, max abs error per state
     field <= 1e-4; one launch per control step, and blocks of every
     variant v0..v3 run;
  4. MT10: the fused step (metaworld_tpu_torch.vector.FusedBatchedEnvs) at
     N = 131072 for 520 steps, so every slot crosses autoreset at
     max_episode_steps=500: finite outputs, episode lengths wrap to 1, the
     kernel launched exactly once per step with blocks of every variant, no
     host synchronisation inside the step loop
     (torch.cuda.set_sync_debug_mode("error")); and on a small batch, the
     fused step with the kernel against the fused step with the plain
     physics;
  5. MT10 timings with CUDA events: kernel ms per control step as one
     launch and, in turns with it, as the same kernel launched once per
     same-variant run (the earlier seven-launch schedule); each variant's
     blocks as one launch; plain-version ms, fused step ms and
     env-steps/s, each beside the card and its power limit, with the
     kernel's bound and roofline share;
  6. MT25: the block layout; kernel vs plain at N = 131072 in a random
     mode and a seek mode (half the slots start 3 cm above their target,
     steer to it and close the grip there: in turn the object's reset
     anchor, the position their reset observation reports and the object's
     grasp point, as the seek tests do), 25 control steps
     each from the plain version's state; the max abs error per state
     field by variant and per task (<= 1e-4), and per task the slots with
     an attached object, a hooked joint or an unanchored object, so that
     the grasp and hook branches are seen to run;
  7. MT25: the fused step with the kernel against the plain physics on 3
     slots per task, then 520 fused steps at N = 131072 with the checks of
     phase 4 (observations (131072, 64));
  8. MT25 timings: the kernel per control step as one launch, each
     variant's blocks as one launch with its bound over the MT25 envs, the
     plain version, and the fused MT25 step in ms and env-steps/s;
  9. MT50: phase 6 on the MT50 layout (2622 x 22 + 2621 x 28 slots),
     where the grasp points include the hammer's handle and the plug's end
     cap; the seek mode must unanchor a peg-unplug-side plug, attach a hammer and hook the handle
     of handle-pull and handle-pull-side;
 10. MT50: phase 7 on 2 slots per task and at N = 131072 (observations
     (131072, 89));
 11. MT50 timings, as phase 8;
 12. ML45: `vector.from_benchmark(ML45(seed=0), split=...)`, the train
     split (45 tasks x 2913 slots, N = 131085) and the test split (5 x
     26214, N = 131070, terminate_on_success), the goal hidden: on each
     split's layout, whose last block is ragged (13 and 126 envs), the
     kernel against its plain version for 4 control steps as in phase 3
     (<= 1e-4 per state field); then 20 fused steps each with the kernel
     and no host synchronisation, finite outputs, one launch per step and
     obs[:, 36:39] == 0;
 13. closed loop: the 50 scripted experts (metaworld_tpu_torch.evaluation.
     ScriptedAgent) drive the MT50 layout of phase 9 with the goal tables of
     MT50(seed=42), task_select="pseudorandom" and autoreset=False, each
     task's slot j pinned to goal row j % 50, for 500 steps of
     eval_action -> step with the kernel, no host synchronisation and one
     launch per step; each slot's success is the max over the steps. Prints
     every task's success over its 50 goal rows, the rows it failed and the
     mean over its slots, and fails unless every task reaches the
     reference's bar of 0.80 over the 50 goal rows, every copy of a (task,
     goal row) ends with the same success, the outputs are finite and the
     experts on the card agree with the CPU on the last observations (at
     least 99.5% of rows within 1e-5); then prints the loop's wall time, ms
     per step and env-steps/s, and the experts' share of the step from CUDA
     events on the same inputs.
 14. evaluation(): `evaluation.evaluation(ScriptedAgent, envs,
     num_episodes=1, vstate=...)` on phase 13's layout and goal rows (MT50,
     N = 131072), now with terminate_on_success and autoreset; every
     task's success must equal phase 13's mean over its slots within 1e-6
     (the first episode ends at the first success or is truncated at step
     500, as phase 13's running max over 500 steps), one launch per step
     running every variant, finite outputs. Prints mean_success,
     mean_returns, the steps, ms per step and host syncs per step (the
     warnings of set_sync_debug_mode("warn")).
 15. metalearning_evaluation() on ML45's test split through
     `make_ml_envs_test("ML45", seed=0, meta_batch_size=131070)` (5 x
     26214 slots, goal hidden), with the experts as a meta-agent whose
     init and adapt count their calls: 2 rounds of one adaptation episode
     and one evaluation episode. Gates: init and adapt called twice, each
     buffer at least one transition; each round evaluates on the goal rows
     it adapted on, and every slot's row differs between the rounds;
     obs[:, 36:39] == 0 and finite outputs; one launch per step. Prints
     per-task success, the steps, the wall time, the peak device memory
     and sample_tasks' host time.
 16. the wrapper stack: `make_mt_envs("MT10", envs_per_task=13107,
     use_one_hot=True, max_episode_steps=20, reward_normalization_method=
     "gymnasium", normalize_observations=True, recurrent_info_in_obs=True)`
     (N = 131070, obs (131070, 55), random task select): 60 steps of
     seeded random actions with no host sync and one launch per step,
     finite outputs and running statistics; a checkpoint (state, the three
     wrapper states and the engine's generator) after step 20, and the 40
     steps after it re-run from its restore, bit-equal in obs, reward and
     done across the random-draw autoresets; 10 steps with the exponential
     reward norm. Prints the pipeline's step against the bare fused step
     (CUDA events, in turns) and the checkpoint's size.

The line before the last is the per-kernel JSON record, one record per
variant and path (MT10, MT25, MT50; the MT50 closed loop and the MT50
evaluation, whose launches are phases 13's and 14's and whose times are
phase 11's on the same layout; the ML45 test split's metalearning and
the MT10 pipeline, timed on their own layouts); the last line is
{"ok": true, "device": {...}}. The script imports nothing of JAX.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

N_ENVS = 131072
FUSED_STEPS = 520
MAX_EPISODE_STEPS = 500
PHYS_STEPS = 5
PATH_PHYS_STEPS = 25
ML45_PER_TASK = {"train": 2913, "test": 26214}  # N = 131085 and 131070
ML45_STEPS = 20
ML45_HOLD_STEPS = 4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
# H100 SXM lane operations per second: 132 SMs x 128 float32 lanes x
# 1.98 GHz. The published 67 TFLOP/s counts a fused multiply-add as two
# operations; the kernel is built with --fmad=false, so it issues none and
# each of its operations takes one lane slot.
F32_OPS_PER_S = 33.5e12
TPU_KERNEL = "metaworld_tpu/physics/pallas_step.py:281"  # _make_kernel
FLAGS_COUNTED = ("attached", "hooked", "unanchored")
LOOP_STEPS = 500
LOOP_GOALS = 50
LOOP_SEED = 42
LOOP_BAR = 0.80  # per task (tests/test_behavioral_bar.py:38-44)
ML45_META_BATCH = 131070
PIPE_PER_TASK = 13107  # MT10 x 13107 = 131070 slots
PIPE_EPISODE = 20
PIPE_STEPS = 60
PIPE_CKPT = 20
PIPE_EXP_STEPS = 10


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "unknown"


def time_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def task_names(path: str) -> list:
    from metaworld_tpu_torch import benchmarks

    return {"mt10": benchmarks.MT10_LIST, "mt25": benchmarks.MT25_LIST,
            "mt50": benchmarks.MT50_LIST}[path]


def bench_engine(device, n_envs, path="mt10", **kw):
    """bench.py's layout of the task set `path` (profile_step.bench_engine)."""
    from metaworld_tpu_torch import profile_step

    return profile_step.bench_engine(device, n_envs, path, **kw)


def ops_per_env_substep(path: str) -> dict:
    """Elementwise float operations one env's substep performs in the plain
    version with each variant's features (each lane op counts once),
    counted on the CPU with a dispatch hook over a one-env batch of every
    task of `path` the variant is sound for: {variant: {task: count}}. The
    plain version masks its branches instead of taking them, so a variant's
    count should not depend on the task."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from metaworld_tpu_torch.physics import cuda_step, engine_lanes

    skip = {"select", "slice", "stack", "cat", "clone", "_to_copy", "copy_",
            "view", "unsqueeze", "expand", "zeros_like", "ones_like",
            "full_like", "empty_like", "lift_fresh", "detach", "alias", "t",
            "transpose", "scalar_tensor", "full", "zeros", "ones", "empty",
            "_local_scalar_dense", "squeeze", "unbind", "split", "index"}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.__name__.split(".")[0] not in skip and isinstance(
                    out, torch.Tensor) and out.numel() == 1:
                Count.n += 1
            return out

    names = task_names(path)
    eng = bench_engine("cpu", len(names), path, physics="torch")
    feats = eng.scene_table.features
    state, _ = eng.reset()
    out = {}
    for variant, flags in enumerate(cuda_step.VARIANTS):
        out[variant] = {}
        for i, name in enumerate(names):
            if ((not flags["with_objects"] and feats[i, 0])
                    or (not flags["with_joints"] and feats[i, 1])
                    or (not flags["with_hand_boxes"] and feats[i, 2])):
                continue
            sl = slice(i, i + 1)
            sim = state.env.sim.map(lambda t: t[sl])
            ids = eng.task_ids[sl]
            rows = eng.scene_table.rows[ids.long()].T
            sc = engine_lanes._NS(**cuda_step._build_lanes(rows, cuda_step.SC_SPEC))
            st = engine_lanes.sim_lanes(sim)
            tgt = engine_lanes._v3(sim.hand)
            Count.n = 0
            with Count():
                engine_lanes._substep(sc, st, tgt, sim.gripper, **flags)
            out[variant][name] = Count.n
    return out


def env_variants(blocks, n, dev) -> torch.Tensor:
    """(n,) variant each env runs in, from the block table."""
    v = np.empty(n, np.int64)
    for variant, first, count, _, _ in blocks.host:
        v[first:first + count] = variant
    return torch.from_numpy(v).to(dev)


def field_errors(got, ref, n):
    """{field: (n,) max abs error per env}, NaN counted as infinite."""
    out = {}
    for f in ref.__dataclass_fields__:
        d = (getattr(got, f) - getattr(ref, f)).abs().reshape(n, -1)
        out[f] = torch.nan_to_num(d, nan=float("inf")).amax(dim=1)
    return out


def hold_steps(eng, dev, gen, steps, tag):
    """Kernel vs plain on `eng`'s layout for `steps` control steps of random
    actions from the reset, each from the plain version's state (phases 3
    and 12): fails on a max abs error above 1e-4 in any state field.
    Returns the max abs error by variant."""
    from metaworld_tpu_torch.physics import cuda_step

    table, ids, blocks = eng.scene_table, eng.task_ids, eng.block_table
    n = eng.num_envs
    variant = env_variants(blocks, n, dev)
    state, _ = eng.reset()
    sim = state.env.sim
    err_by_variant = [0.0] * 4
    for t in range(steps):
        act = torch.rand(n, 4, generator=gen, device=dev) * 2 - 1
        got = cuda_step.control_step(table, ids, sim, act, blocks)
        ref = cuda_step.plain_control_step(table, ids, sim, act)
        worst, field = 0.0, None
        for f, d in field_errors(got, ref, n).items():
            by_v = torch.zeros(4, device=dev).scatter_reduce_(0, variant, d, "amax")
            err_by_variant = [max(a, b) for a, b in zip(err_by_variant, by_v.tolist())]
            e = d.max().item()
            if e > worst:
                worst, field = e, f
        print(f"[{tag}] step {t}: max abs err {worst:.3e} ({field})")
        if not worst <= 1e-4:
            fail(f"{tag}: kernel disagrees with its plain version: {field} {worst:.3e}")
        sim = ref
    return err_by_variant


def seek_actions(act, sim, target, seek):
    """Seeking slots steer toward their target and close the grip within
    3 cm of it (tests/test_torch_kernel_host.py's seek mode)."""
    d = target - sim.hand
    steer = torch.clamp(d * 60.0 + 0.3 * act[:, :3], -1.0, 1.0)
    grip = torch.where(torch.linalg.vector_norm(d, dim=1) < 0.03, 1.0, act[:, 3])
    return torch.where(seek[:, None], torch.cat([steer, grip[:, None]], 1), act)


def seek_targets(eng, state, obs, seek_slot):
    """Each seeking slot's target, the three kinds in turn over the
    seeking slots (`seek_slot` % 3): the object's reset anchor
    (obj_init_pos), the position the reset observation reports (a faucet's
    handle, the stick, the wrench's handle) and the object's grasp point,
    its center plus the scene's grasp offset (the hammer's handle, the
    plug's end cap, the lid's knob), or the reported position where the
    task has no object. The rule of tests/test_torch_physics_mt50.py's
    seek_targets, copied because this script imports nothing of the
    tests."""
    dev = obs.device
    off = torch.tensor(np.stack([s.scene.obj_grasp_off[0] for s in eng.specs]),
                       dtype=torch.float32, device=dev)
    has = torch.tensor([bool(s.scene.obj_exists[0] > 0) for s in eng.specs],
                       device=dev)
    ids = eng.task_ids.long()
    grasp = torch.where(has[ids][:, None], state.env.sim.obj_pos[:, 0] + off[ids],
                        obs[:, 4:7])
    kind = (seek_slot % 3)[:, None]
    return torch.where(kind == 0, state.env.obj_init_pos[:, 0],
                       torch.where(kind == 1, obs[:, 4:7], grasp))


def hold_path(eng, dev, gen, names, path, must_see=()):
    """Kernel vs plain on a path's layout, random and seek modes (phases 6
    and 9). `must_see` lists (flag, task) pairs the seek mode must set on
    some slot of the task. Returns the max abs error by variant over both
    modes."""
    from metaworld_tpu_torch.physics import cuda_step, engine
    from metaworld_tpu_torch.types import SimState

    table, ids, blocks = eng.scene_table, eng.task_ids, eng.block_table
    n, n_tasks = eng.num_envs, len(names)
    variant = env_variants(blocks, n, dev)
    task_variants = [sorted({int(v) for v, f, c, lo, k in blocks.host
                             if lo <= t < lo + k}) for t in range(n_tasks)]
    fields = list(SimState.__dataclass_fields__)
    err_by_variant = [0.0] * 4
    slot = torch.arange(n, device=dev)
    tag = f"{path}-vs-plain"
    for mode in ("random", "seek"):
        state, obs = eng.reset()
        sim = state.env.sim
        # seeking slots: every other slot, steering to seek_targets'
        seek = (slot % 2 == 0) & (mode == "seek")
        target = seek_targets(eng, state, obs, slot // 2)
        if mode == "seek":
            goal = target + torch.tensor([0.0, 0.0, 0.03], device=dev)
            tcp = torch.tensor(engine.TCP_OFFSET, device=dev)
            sim = sim.replace(hand=torch.where(seek[:, None], goal, sim.hand),
                              mocap=torch.where(seek[:, None], goal - tcp, sim.mocap))
        by_task = torch.zeros(len(fields), n_tasks, device=dev)
        by_variant = torch.zeros(len(fields), 4, device=dev)
        ever = torch.zeros(len(FLAGS_COUNTED), n, dtype=torch.bool, device=dev)
        cuda_step.reset_counts()
        for t in range(PATH_PHYS_STEPS):
            act = torch.rand(n, 4, generator=gen, device=dev) * 2 - 1
            if mode == "seek":
                act = seek_actions(act, sim, target, seek)
            got = cuda_step.control_step(table, ids, sim, act, blocks)
            ref = cuda_step.plain_control_step(table, ids, sim, act)
            errs = field_errors(got, ref, n)
            for k, f in enumerate(fields):
                by_task[k].scatter_reduce_(0, ids.long(), errs[f], "amax")
                by_variant[k].scatter_reduce_(0, variant, errs[f], "amax")
            for k, f in enumerate(FLAGS_COUNTED):
                ever[k] |= (getattr(ref, f) != 0).any(dim=1)
            sim = ref
        if cuda_step.launches != PATH_PHYS_STEPS:
            fail(f"{path} {mode}: {cuda_step.launches} launches for "
                 f"{PATH_PHYS_STEPS} control steps")
        end = torch.stack([(getattr(sim, f) != 0).any(dim=1) for f in FLAGS_COUNTED])

        def count(m):
            return torch.zeros(n_tasks, device=dev).index_add_(
                0, ids.long(), m.float()).long().tolist()

        ended = [count(end[k]) for k in range(len(FLAGS_COUNTED))]
        seen = [count(ever[k]) for k in range(len(FLAGS_COUNTED))]
        by_task, by_variant = by_task.cpu().numpy(), by_variant.cpu().numpy()
        for k, f in enumerate(fields):
            print(f"[{tag} {mode}] {f}: max abs err by variant "
                  + " ".join(f"v{v} {by_variant[k, v]:.3e}" for v in range(4)))
        for t, name in enumerate(names):
            worst = int(np.argmax(by_task[:, t]))
            print(f"[{tag} {mode}] task {t} {name} (v"
                  f"{','.join(map(str, task_variants[t]))}): max abs err "
                  f"{by_task[worst, t]:.3e} "
                  f"({fields[worst] if by_task[worst, t] > 0 else '-'}); slots attached/"
                  f"hooked/unanchored at the end {ended[0][t]}/{ended[1][t]}/"
                  f"{ended[2][t]}, at any step {seen[0][t]}/{seen[1][t]}/"
                  f"{seen[2][t]}")
        worst = float(by_task.max())
        totals = [sum(s) for s in seen]
        print(f"[{tag} {mode}] {PATH_PHYS_STEPS} steps x {n} envs: max abs "
              f"err {worst:.3e}; slots attached/hooked/unanchored at any step "
              f"{totals}")
        if not worst <= 1e-4:
            t, k = np.unravel_index(np.argmax(by_task.T), by_task.T.shape)
            fail(f"{path} {mode}: kernel disagrees with its plain version on "
                 f"{names[t]}: {fields[k]} {by_task[k, t]:.3e}")
        if mode == "seek" and not (totals[0] > 0 and totals[1] > 0):
            fail(f"{path} seek: the grasp and hook branches did not run ({totals})")
        if mode == "seek":
            for flag, task in must_see:
                got = seen[FLAGS_COUNTED.index(flag)][names.index(task)]
                if got == 0:
                    fail(f"{path} seek: no {task} slot {flag}: the branch did not run")
        for v in range(4):
            err_by_variant[v] = max(err_by_variant[v], float(by_variant[:, v].max()))
    return err_by_variant


def fused_small(dev, gen, path, n):
    """The fused step with the kernel against the fused step with the plain
    physics, 12 steps of `n` slots from one shared state."""
    from metaworld_tpu_torch import vector

    kw = dict(max_episode_steps=4, task_select="pseudorandom")
    small_k = bench_engine(dev, n, path, **kw)
    small_p = bench_engine(dev, n, path, physics="torch", **kw)
    goal_idx = torch.arange(n, device=dev, dtype=torch.int32) % 50
    sk, _ = small_k.reset(goal_idx=goal_idx)
    worst = {}
    for t in range(12):
        act = torch.rand(n, 4, generator=gen, device=dev) * 2 - 1
        nk, ok = small_k.step(sk, act)
        _, op = small_p.step(sk, act)
        for k in vector.OUT_KEYS:
            a, b = ok[k].double(), op[k].double()
            worst[k] = max(worst.get(k, 0.0), ((a - b).abs() / (1.0 + b.abs())).max().item())
        sk = nk
    return worst


def fused_main(eng, dev, gen, obs_dim, tag):
    """520 fused steps at full width with every check of the main path;
    returns (kernel launches that ran each variant, the actions)."""
    from metaworld_tpu_torch.physics import cuda_step

    n, blocks = eng.num_envs, eng.block_table
    state, obs = eng.reset()
    if tuple(obs.shape) != (n, obs_dim):
        fail(f"{tag}: reset obs shape {tuple(obs.shape)}")
    for _ in range(2):  # warm-up (first calls fill the per-device caches)
        eng.step(state, torch.rand(n, 4, generator=gen, device=dev) * 2 - 1)
    torch.cuda.synchronize()
    state, _ = eng.reset()
    acts = [torch.rand(n, 4, generator=gen, device=dev) * 2 - 1 for _ in range(8)]
    finite = torch.ones((), dtype=torch.bool, device=dev)
    wrapped = torch.zeros((), dtype=torch.bool, device=dev)
    crossed = torch.zeros(n, dtype=torch.bool, device=dev)
    dones = torch.zeros((), dtype=torch.int64, device=dev)
    prev_done = torch.zeros(n, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    cuda_step.reset_counts()
    t0 = time.time()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(FUSED_STEPS):
            state, out = eng.step(state, acts[t % len(acts)])
            for k in ("obs", "reward", "episode_return", "grasp_reward",
                      "in_place_reward", "obj_to_target"):
                finite = finite & torch.isfinite(out[k]).all()
            wrapped = wrapped | (prev_done & (out["episode_length"] == 1)).any()
            crossed = crossed | (prev_done & (out["episode_length"] == 1))
            finite = finite & ~(prev_done & (out["episode_length"] != 1)).any()
            dones = dones + out["done"].sum()
            prev_done = out["done"]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = list(cuda_step.launches_by_variant)
    blocks_run = list(cuda_step.blocks_by_variant)
    print(f"[{tag}] {FUSED_STEPS} steps x {n} envs in {wall:.2f} s wall; "
          f"dones {int(dones)}; slots that crossed autoreset "
          f"{int(crossed.sum())}; launches {cuda_step.launches}, running each "
          f"variant {launches}; blocks by variant {blocks_run}")
    if not bool(finite):
        fail(f"{tag}: non-finite outputs, or an episode length that did not wrap to 1")
    if not bool(wrapped) or int(dones) < n or not bool(crossed.all()):
        fail(f"{tag}: autoreset not crossed by every slot (dones {int(dones)}, "
             f"crossed {int(crossed.sum())})")
    if cuda_step.launches != FUSED_STEPS or launches != [FUSED_STEPS] * 4:
        fail(f"{tag}: kernel launches {cuda_step.launches} {launches}: expected "
             f"one per step, each running blocks of every variant")
    if blocks_run != [FUSED_STEPS * c for c in blocks.blocks_by_variant]:
        fail(f"{tag}: blocks by variant {blocks_run} != {FUSED_STEPS} x "
             f"{blocks.blocks_by_variant}")
    if tuple(out["obs"].shape) != (n, obs_dim):
        fail(f"{tag}: obs shape {tuple(out['obs'].shape)}")
    return launches, acts


def variant_records(eng, dev, act, ops, path, launches, errs, card):
    """Each variant's blocks as one launch, its plain version on the same
    envs, and its bound over the envs it runs: the `kernels` records."""
    from metaworld_tpu_torch.physics import cuda_step

    table, ids, blocks = eng.scene_table, eng.task_ids, eng.block_table
    state, _ = eng.reset()
    sim = state.env.sim
    mocap, target, effort = cuda_step._sim_and_ctl(table, ids, sim, act)
    ctl = torch.cat([target.T, effort[None]]).contiguous()
    rows = cuda_step.pack_sim_rows(sim).contiguous()
    variant = env_variants(blocks, eng.num_envs, dev)
    bytes_per_env = (2 * cuda_step.SIM_ROWS + 4) * 4 + 4
    records = []
    for v in range(4):
        vblocks = blocks.select(blocks.host[:, 0] == v)
        n_v = int(vblocks.host[:, 2].sum())
        k_ms = time_ms(lambda: cuda_step.launch_rows(table.rows, ids, rows, ctl, vblocks), 50)
        idx = torch.nonzero(variant == v).flatten()
        sim_v = sim.map(lambda t: t[idx])
        p_ms = time_ms(lambda: cuda_step.plain_control_step(
            table, ids[idx], sim_v, act[idx]), 3, 1)
        b_bytes = (n_v * bytes_per_env + table.rows.numel() * 4) / HBM_BYTES_PER_S * 1e3
        b_ops = ops[v] * 5 * n_v / F32_OPS_PER_S * 1e3
        records.append({
            "name": f"step_kernel_v{v}", "path": path, "route": "cuda",
            "source": "metaworld_tpu_torch/csrc/step_kernel.cu",
            "replaces": TPU_KERNEL, "launches": launches[v],
            "max_abs_err": errs[v], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(b_bytes, b_ops),
            "bound_by": "operations" if b_ops >= b_bytes else "bytes",
            "library_ms": None,
        })
        print(f"[{path} kernel v{v}] {card}: {n_v} envs in {len(vblocks.host)} "
              f"blocks, one launch {k_ms:.4f} ms, plain {p_ms:.2f} ms, bound "
              f"{max(b_bytes, b_ops) * 1e3:.2f} us")
    return records


def control_step_bound(eng, ops):
    """(bytes ms, operations ms) of one control step over the layout."""
    from metaworld_tpu_torch.physics import cuda_step

    h = eng.block_table.host
    n_by_v = [int(h[h[:, 0] == v, 2].sum()) for v in range(4)]
    bytes_per_env = (2 * cuda_step.SIM_ROWS + 4) * 4 + 4
    total_ops = sum(ops[v] * 5 * n_by_v[v] for v in range(4))
    return ((eng.num_envs * bytes_per_env + eng.scene_table.rows.numel() * 4)
            / HBM_BYTES_PER_S * 1e3, total_ops / F32_OPS_PER_S * 1e3)


@functools.cache
def count_ops(path):
    """Per-variant operation count of `path`, printed with its spread over
    the path's tasks (counted once per run)."""
    per_task = ops_per_env_substep(path)
    ops = {}
    for v, counts in per_task.items():
        ops[v] = max(counts.values())
        spread = sorted(set(counts.values()))
        print(f"[{path} ops] v{v}: {ops[v]} elementwise ops per env per substep "
              f"over {len(counts)} tasks" + ("" if len(spread) == 1 else
                                            f" (counts move: {spread})"))
    return ops


def run_path(path, dev, gen, card, seed, n_small, fused_mt10_ms, must_see=()):
    """Phases 6-8 (MT25) and 9-11 (MT50): kernel vs plain in the random and
    the seek mode, the fused step with the kernel against the plain physics
    on `n_small` slots, 520 fused steps at N = 131072 and the timings.
    Returns the path's `kernels` records."""
    from metaworld_tpu_torch.physics import cuda_step

    names = task_names(path)
    eng = bench_engine(dev, N_ENVS, path, max_episode_steps=MAX_EPISODE_STEPS)
    counts = [int(c) for c in np.bincount(eng.task_ids.cpu().numpy())]
    print(f"[{path} blocks] {len(names)} tasks, slots per task {counts}; one launch "
          f"of {eng.block_table.host.shape[0]} blocks, by variant "
          f"{eng.block_table.blocks_by_variant}")
    gen.manual_seed(seed)
    errs = hold_path(eng, dev, gen, names, path, must_see)
    print(f"[{path}-vs-plain] max err by variant over both modes "
          f"{['%.3e' % e for e in errs]}")

    # the fused step, small batch and main path
    worst = fused_small(dev, gen, path, n_small)
    bad = {k: v for k, v in worst.items() if not v <= 1e-4}
    print(f"[{path} fused-small] kernel vs plain physics, 12 steps x {n_small} "
          f"envs: worst {max(worst.values()):.3e}")
    if bad:
        fail(f"{path}: fused step with the kernel disagrees with the plain physics: {bad}")
    gen.manual_seed(seed + 1)
    launches, acts = fused_main(eng, dev, gen, 39 + len(names), f"{path} fused")

    # timings
    table, ids, blocks = eng.scene_table, eng.task_ids, eng.block_table
    state, _ = eng.reset()
    sim = state.env.sim
    act = acts[0]
    mocap, target, effort = cuda_step._sim_and_ctl(table, ids, sim, act)
    ctl = torch.cat([target.T, effort[None]]).contiguous()
    rows = cuda_step.pack_sim_rows(sim).contiguous()
    kernel_ms = time_ms(lambda: cuda_step.launch_rows(
        table.rows, ids, rows, ctl, blocks), 50)
    plain_ms = time_ms(lambda: cuda_step.plain_control_step(
        table, ids, sim, act), 3, 1)
    fused_ms = time_ms(lambda: eng.step(state, act), 20)
    ops = count_ops(path)
    b_bytes, b_ops = control_step_bound(eng, ops)
    print(f"[{path} time] {card}: kernel {kernel_ms:.4f} ms per control step "
          f"(one launch, N={N_ENVS}); plain torch physics {plain_ms:.2f} ms; "
          f"bound {max(b_bytes, b_ops) * 1e3:.2f} us "
          f"({'operations' if b_ops >= b_bytes else 'bytes'}; bytes "
          f"{b_bytes * 1e3:.2f} us); roofline share "
          f"{max(b_bytes, b_ops) / kernel_ms:.3f}")
    print(f"[{path} time] {card}: fused {path.upper()} step {fused_ms:.3f} ms, "
          f"{N_ENVS / fused_ms * 1e3:.0f} env-steps/s at N={N_ENVS}; fused MT10 "
          f"step {fused_mt10_ms:.3f} ms in this run")
    return variant_records(eng, dev, act, ops, path, launches, errs, card)


def run_ml45(dev, gen, card):
    """Phase 12: ML45's train split (45 tasks x 2913 slots, N = 131085)
    and test split (5 x 26214, N = 131070, terminate_on_success), the goal
    hidden. On each split's layout, with its ragged last block, the kernel
    against its plain version for 4 control steps; then 20 fused steps
    with the kernel and no host synchronisation, finite outputs, one
    launch per step and a zero goal block in every observation. Returns
    each split's kernel-vs-plain max abs error by variant."""
    from metaworld_tpu_torch import benchmarks, vector
    from metaworld_tpu_torch.physics import cuda_step

    bench = benchmarks.ML45(seed=0)
    errs_by_split = {}
    for split, kw in (("train", {}), ("test", dict(terminate_on_success=True))):
        per_task = ML45_PER_TASK[split]
        eng = vector.from_benchmark(bench, split=split, envs_per_task=per_task,
                                    device=dev, **kw)
        n, h = eng.num_envs, eng.block_table.host
        print(f"[ml45 {split} blocks] {len(eng.specs)} tasks x {per_task} = {n} "
              f"envs; one launch of {h.shape[0]} blocks, by variant "
              f"{eng.block_table.blocks_by_variant}; env counts of the blocks "
              f"{sorted({int(c) for c in h[:, 2]})}")
        errs = errs_by_split[split] = hold_steps(eng, dev, gen, ML45_HOLD_STEPS,
                                                 f"ml45 {split}-vs-plain")
        print(f"[ml45 {split}-vs-plain] {ML45_HOLD_STEPS} steps x {n} envs: max "
              f"err by variant {['%.3e' % e for e in errs]}")
        state, obs = eng.reset()
        torch.cuda.synchronize()
        finite = torch.isfinite(obs).all()
        hidden = (obs[:, 36:39] == 0).all()
        cuda_step.reset_counts()
        t0 = time.time()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(ML45_STEPS):
                act = torch.rand(n, 4, generator=gen, device=dev) * 2 - 1
                state, out = eng.step(state, act)
                for k in ("obs", "reward", "episode_return", "grasp_reward",
                          "in_place_reward", "obj_to_target"):
                    finite = finite & torch.isfinite(out[k]).all()
                hidden = hidden & (out["obs"][:, 36:39] == 0).all()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.time() - t0
        print(f"[ml45 {split}] {card}: {len(eng.specs)} tasks x {per_task} = {n} "
              f"envs, obs {tuple(out['obs'].shape)}; {ML45_STEPS} steps in {wall:.2f} "
              f"s wall; "
              f"launches {cuda_step.launches}, blocks by variant "
              f"{eng.block_table.blocks_by_variant}; successes in the last step "
              f"{int(out['success'].sum())}")
        if not bool(finite):
            fail(f"ml45 {split}: non-finite outputs")
        if not bool(hidden):
            fail(f"ml45 {split}: the goal is not hidden")
        if cuda_step.launches != ML45_STEPS:
            fail(f"ml45 {split}: {cuda_step.launches} kernel launches for "
                 f"{ML45_STEPS} steps")
        if tuple(out["obs"].shape) != (n, 39):
            fail(f"ml45 {split}: obs shape {tuple(out['obs'].shape)}")
        del eng, state, out
    return errs_by_split


def count_aten_ops(fn):
    """ATen operations one call of `fn` dispatches (about one device kernel
    each)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def loop_goal_rows(eng):
    """Slot j of each task on goal row j % LOOP_GOALS (phases 13 and 14)."""
    dev = eng.device
    offsets = torch.from_numpy(eng._offsets[:-1]).to(dev)
    slot = torch.arange(eng.num_envs, device=dev)
    return ((slot - offsets[eng.task_ids.long()]) % LOOP_GOALS).int()


def run_closed_loop(dev, card, mt50_records):
    """Phase 13: the 50 experts drive the MT50 layout for LOOP_STEPS steps
    through the kernel; returns the closed loop's `kernels` records (the
    launches of this run, the times of phase 11's records on the same
    layout) and each task's success as the mean over its slots."""
    from metaworld_tpu_torch import evaluation
    from metaworld_tpu_torch.physics import cuda_step

    names = task_names("mt50")
    eng = bench_engine(dev, N_ENVS, "mt50", seed=LOOP_SEED,
                       task_select="pseudorandom", autoreset=False)
    n, n_tasks = eng.num_envs, len(names)
    ids = eng.task_ids.long()
    goal_idx = loop_goal_rows(eng)
    agent = evaluation.ScriptedAgent(eng)
    state, obs = eng.reset(goal_idx=goal_idx)
    eng.step(state, agent.eval_action(obs))  # warm-up: fills the per-device caches
    torch.cuda.synchronize()
    success = torch.zeros(n, device=dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    cuda_step.reset_counts()
    t0 = time.time()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(LOOP_STEPS):
            act = agent.eval_action(obs)
            state, out = eng.step(state, act)
            obs = out["obs"]
            success = torch.maximum(success, out["success"])
            finite = finite & torch.isfinite(act).all() & torch.isfinite(obs).all()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.time() - t0
    total = cuda_step.launches
    launches, blocks_run = list(cuda_step.launches_by_variant), list(cuda_step.blocks_by_variant)

    # each (task, goal row) has 52 or 53 copies; the bar counts each goal
    # row once, as the reference's 50-goal sweep does, so its success is the
    # one its copies share (checked to agree)
    slots = torch.bincount(ids, minlength=n_tasks).float()
    slot_mean = (torch.zeros(n_tasks, device=dev).index_add_(0, ids, success) / slots).tolist()
    key = ids * LOOP_GOALS + goal_idx.long()
    rows = n_tasks * LOOP_GOALS
    lo = torch.full((rows,), 2.0, device=dev).scatter_reduce_(0, key, success, "amin")
    hi = torch.full((rows,), -1.0, device=dev).scatter_reduce_(0, key, success, "amax")
    copies = torch.bincount(key, minlength=rows)
    split = ((lo != hi) & (copies > 0)).reshape(n_tasks, LOOP_GOALS)
    solved = (hi > 0).reshape(n_tasks, LOOP_GOALS).cpu()
    row_ok = solved.sum(1).tolist()
    rate = [k / LOOP_GOALS for k in row_ok]
    if int(copies.min()) == 0:
        fail(f"closed loop: {int((copies == 0).sum())} (task, goal row) pairs have no slot")
    for t, name in enumerate(names):
        failed = torch.nonzero(~solved[t]).flatten().tolist()
        print(f"[closed-loop] task {t} {name}: success {rate[t]:.4f} over {LOOP_GOALS} "
              f"goal rows ({row_ok[t]} solved; goal rows failed {failed}); mean over "
              f"its {int(slots[t])} slots {slot_mean[t]:.4f}; rows whose copies "
              f"disagree {int(split[t].sum())}")
    order = sorted(range(n_tasks), key=lambda t: (rate[t], slot_mean[t]))
    print("[closed-loop] lowest ten: " + ", ".join(
        f"{names[t]} {rate[t]:.4f}" for t in order[:10]))
    print(f"[closed-loop] {card}: {n_tasks} tasks x {LOOP_GOALS} goal rows (MT50 "
          f"seed {LOOP_SEED}), {n} envs, {LOOP_STEPS} steps of expert + step in "
          f"{wall:.2f} s wall: {wall / LOOP_STEPS * 1e3:.2f} ms per step, "
          f"{n * LOOP_STEPS / wall:.0f} env-steps/s; mean success "
          f"{sum(rate) / n_tasks:.4f}, min {rate[order[0]]:.4f} ({names[order[0]]}); "
          f"launches {total}, running each variant {launches}, "
          f"blocks by variant {blocks_run}")

    # the experts on the card against the same experts on the CPU, on the
    # loop's last observations
    act = agent.eval_action(obs)
    off = (act.cpu() - agent.eval_action(obs.cpu())).abs().amax(dim=1)
    n_off = int((off > 1e-5).sum())
    print(f"[closed-loop experts] card vs CPU on the last {n} observations: "
          f"{n_off} rows off by more than 1e-5, worst {float(off.max()):.3e}")

    # the experts' share of the step, CUDA events on the same inputs
    expert_ms = time_ms(lambda: agent.eval_action(obs), 20)
    step_ms = time_ms(lambda: eng.step(state, act), 20)
    expert_ops = count_aten_ops(lambda: agent.eval_action(obs))
    print(f"[closed-loop time] {card}: experts {expert_ms:.3f} ms ({expert_ops} ATen "
          f"ops), fused MT50 step {step_ms:.3f} ms on the same inputs: the experts' "
          f"share {expert_ms / (expert_ms + step_ms):.3f}")

    if not bool(finite):
        fail("closed loop: non-finite actions or observations")
    if not n_off <= 0.005 * n:
        fail(f"closed loop: the experts on the card disagree with the CPU on {n_off} rows")
    if total != LOOP_STEPS or launches != [LOOP_STEPS] * 4:
        fail(f"closed loop: kernel launches {total} {launches}: "
             f"expected one per step, each running blocks of every variant")
    if blocks_run != [LOOP_STEPS * c for c in eng.block_table.blocks_by_variant]:
        fail(f"closed loop: blocks by variant {blocks_run}")
    if bool(split.any()):
        t = int(split.sum(1).argmax())
        fail(f"closed loop: copies of a goal row end with different success "
             f"({int(split.sum())} rows; {names[t]} has {int(split[t].sum())})")
    below = [(names[t], rate[t]) for t in range(n_tasks)
             if not row_ok[t] >= LOOP_BAR * LOOP_GOALS]
    if below:
        fail(f"closed loop: tasks below the bar of {LOOP_BAR}: {below}")
    return [dict(rec, path="mt50 closed loop", launches=launches[v])
            for v, rec in enumerate(mt50_records)], slot_mean


class Counted:
    """Delegates to an engine; counts its steps, records the pinned goal
    rows of every reset and checks, on the device, that every observation
    is finite and (with `hidden`) that its goal block is zero; times
    `sample_tasks` on the host."""

    def __init__(self, envs, hidden=False):
        self.envs = envs
        self.hidden = hidden
        self.steps = 0
        self.goal_rows = []
        self.sample_s = []
        self.ok = torch.ones((), dtype=torch.bool, device=envs.device)

    def __getattr__(self, name):
        return getattr(self.envs, name)

    def _check(self, obs, *more):
        ok = torch.isfinite(obs).all()
        for t in more:
            ok = ok & torch.isfinite(t).all()
        if self.hidden:
            ok = ok & (obs[:, 36:39] == 0).all()
        self.ok = self.ok & ok

    def reset(self, *args, **kwargs):
        state, obs = self.envs.reset(*args, **kwargs)
        self.goal_rows.append(state.goal_idx.clone())
        self._check(obs)
        return state, obs

    def step(self, state, actions):
        self.steps += 1
        state, out = self.envs.step(state, actions)
        self._check(out["obs"], out["reward"], out["episode_return"])
        return state, out

    def sample_tasks(self, state):
        t0 = time.time()
        state = self.envs.sample_tasks(state)
        self.sample_s.append(time.time() - t0)
        return state


def count_syncs(fn):
    """(fn's result, the host synchronisations it made), counted from the
    warnings of torch.cuda.set_sync_debug_mode("warn")."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return result, sum("synchroniz" in str(w.message) for w in caught)


def run_evaluation(dev, card, slot_mean, mt50_records):
    """Phase 14: evaluation() with the 50 experts on phase 13's layout and
    goal rows, pinned through vstate, terminate_on_success and autoreset:
    each task's success must equal phase 13's mean over its slots."""
    from metaworld_tpu_torch import evaluation
    from metaworld_tpu_torch.physics import cuda_step

    t_phase = time.time()
    names = task_names("mt50")
    eng = Counted(bench_engine(dev, N_ENVS, "mt50", seed=LOOP_SEED,
                               task_select="pseudorandom",
                               terminate_on_success=True, autoreset=True))
    vstate, _ = eng.reset(goal_idx=loop_goal_rows(eng))
    agent = evaluation.ScriptedAgent(eng.envs)
    torch.cuda.synchronize()
    eng.steps = 0
    cuda_step.reset_counts()
    t0 = time.time()
    (mean_s, mean_r, per_s, per_r), syncs = count_syncs(
        lambda: evaluation.evaluation(agent, eng, num_episodes=1, vstate=vstate))
    wall = time.time() - t0
    launches, blocks_run = list(cuda_step.launches_by_variant), list(cuda_step.blocks_by_variant)
    steps = eng.steps
    worst = max(abs(per_s[name] - slot_mean[t]) for t, name in enumerate(names))
    for t, name in enumerate(names):
        print(f"[evaluation] task {t} {name}: success {per_s[name]:.4f} (phase 13 slot "
              f"mean {slot_mean[t]:.4f}), returns {per_r[name]:.2f}")
    print(f"[evaluation] {card}: MT50, {eng.num_envs} envs, num_episodes=1: "
          f"mean_success {mean_s:.4f}, mean_returns {mean_r:.4f}; {steps} steps in "
          f"{wall:.2f} s wall, {wall / steps * 1e3:.2f} ms per step; host syncs "
          f"{syncs} ({syncs / steps:.3f} per step); launches {cuda_step.launches}, "
          f"running each variant {launches}; largest difference from phase 13 "
          f"{worst:.3e}; phase {time.time() - t_phase:.1f} s")
    if not bool(eng.ok):
        fail("evaluation: non-finite outputs")
    if cuda_step.launches != steps or launches != [steps] * 4:
        fail(f"evaluation: kernel launches {cuda_step.launches} {launches} for {steps} steps")
    if blocks_run != [steps * c for c in eng.block_table.blocks_by_variant]:
        fail(f"evaluation: blocks by variant {blocks_run}")
    if not worst <= 1e-6:
        fail(f"evaluation: per-task success differs from phase 13's by {worst:.3e}")
    return [dict(rec, path="mt50 evaluation", launches=launches[v])
            for v, rec in enumerate(mt50_records)]


class ScriptedMetaAgent:
    """The experts as a meta-learner: ScriptedAgent actions when adapting
    and evaluating; init and adapt count their calls and adapt keeps the
    length of each buffer it is given."""

    def __init__(self, envs):
        from metaworld_tpu_torch import evaluation

        self.scripted = evaluation.ScriptedAgent(envs)
        self.inits = 0
        self.buffers = []

    def init(self):
        self.inits += 1

    def adapt_action(self, obs):
        return self.scripted.eval_action(obs)

    eval_action = adapt_action

    def adapt(self, timesteps):
        self.buffers.append(len(timesteps))

    def reset(self, env_mask):
        pass


def run_metalearning(dev, card, gen, errs):
    """Phase 15: metalearning_evaluation() on ML45's test split through
    make_ml_envs_test (5 x 26214 slots, goal hidden), 2 rounds of one
    adaptation episode and one evaluation episode."""
    import metaworld_tpu_torch as mw
    from metaworld_tpu_torch import evaluation
    from metaworld_tpu_torch.physics import cuda_step

    t_phase = time.time()
    envs = mw.make_ml_envs_test("ML45", seed=0, meta_batch_size=ML45_META_BATCH,
                                device=dev)
    eng = Counted(envs, hidden=True)
    agent = ScriptedMetaAgent(envs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_step.reset_counts()
    t0 = time.time()
    mean_s, mean_r, per_task = evaluation.metalearning_evaluation(
        agent, eng, num_evals=2, adaptation_steps=1, adaptation_episodes=1,
        num_episodes=1)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = list(cuda_step.launches_by_variant)
    g = eng.goal_rows  # the first reset, then (adaptation, evaluation) per round
    print(f"[metalearning] {card}: ML45 test, {eng.num_envs} envs: per-task success "
          + ", ".join(f"{k} {v:.4f}" for k, v in per_task.items())
          + f"; mean success {mean_s:.4f}, mean returns {mean_r:.4f}; {eng.steps} "
          f"steps in {wall:.2f} s wall ({wall / eng.steps * 1e3:.2f} ms per step); "
          f"adaptation buffers {agent.buffers}; peak memory {peak / 2**30:.2f} GiB; "
          f"sample_tasks host time {['%.3f s' % x for x in eng.sample_s]}; launches "
          f"{cuda_step.launches}, by variant {launches}; phase "
          f"{time.time() - t_phase:.1f} s")
    if agent.inits != 2 or len(agent.buffers) != 2 or min(agent.buffers) < 1:
        fail(f"metalearning: init called {agent.inits} times, adapt buffers {agent.buffers}")
    if len(g) != 5:
        fail(f"metalearning: {len(g)} resets, expected 5")
    for rnd in range(2):
        if not torch.equal(g[1 + 2 * rnd], g[2 + 2 * rnd]):
            fail(f"metalearning: round {rnd} evaluated on other goal rows than it adapted on")
    if not bool((g[1] != g[3]).all()):
        fail(f"metalearning: {int((g[1] == g[3]).sum())} slots kept their goal row across rounds")
    if not bool(eng.ok):
        fail("metalearning: non-finite outputs, or a goal block that is not zero")
    if cuda_step.launches != eng.steps:
        fail(f"metalearning: {cuda_step.launches} kernel launches for {eng.steps} steps")
    ops = count_ops("mt50")  # ML45's tasks are MT50's; op counts per variant
    return variant_records(envs, dev, torch.rand(envs.num_envs, 4, generator=gen,
                                                 device=dev) * 2 - 1,
                           ops, "ml45 test metalearning", launches, errs, card)


def run_pipeline(dev, card, gen):
    """Phase 16: the wrapper stack on MT10 through make_mt_envs (131070
    slots, obs (131070, 55), random task select, 20-step episodes): 60
    steps with no host sync, a checkpoint after step 20 and a bit-equal
    re-run of the next 40 steps from its restore, then 10 steps with the
    exponential reward norm; the pipeline's step against the bare fused
    step."""
    import metaworld_tpu_torch as mw
    from metaworld_tpu_torch import wrappers
    from metaworld_tpu_torch.physics import cuda_step

    t_phase = time.time()
    kw = dict(normalize_observations=True, recurrent_info_in_obs=True)
    pipe = mw.make_mt_envs("MT10", seed=0, envs_per_task=PIPE_PER_TASK,
                           use_one_hot=True, max_episode_steps=PIPE_EPISODE,
                           reward_normalization_method="gymnasium", device=dev, **kw)
    n = pipe.num_envs
    errs = hold_steps(pipe.envs, dev, gen, ML45_HOLD_STEPS, "mt10 pipeline-vs-plain")
    acts = [torch.rand(n, 4, generator=gen, device=dev) * 2 - 1
            for _ in range(PIPE_STEPS)]
    state, obs = pipe.reset(seed=0)
    pipe.step(state, acts[0])  # warm-up: fills the per-device caches
    state, obs = pipe.reset(seed=0)
    if tuple(obs.shape) != (n, 55):
        fail(f"pipeline: obs shape {tuple(obs.shape)}")
    finite = torch.isfinite(obs).all()

    def run(state, steps, outs=None):
        nonlocal finite
        torch.cuda.set_sync_debug_mode("error")
        try:
            for t in steps:
                state, out = pipe.step(state, acts[t])
                finite = finite & torch.isfinite(out["obs"]).all() & torch.isfinite(
                    out["reward"]).all()
                if outs is not None:
                    outs.append((out["obs"], out["reward"], out["done"]))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return state

    torch.cuda.synchronize()
    cuda_step.reset_counts()
    t0 = time.time()
    state = run(state, range(PIPE_CKPT))
    torch.cuda.synchronize()
    t_ckpt = time.time()
    blob = wrappers.checkpoint(state[0], state[1:], envs=pipe)
    t_ckpt = time.time() - t_ckpt
    ref = []
    end = run(state, range(PIPE_CKPT, PIPE_STEPS), ref)
    torch.cuda.synchronize()
    wall = time.time() - t0
    total, launches = cuda_step.launches, list(cuda_step.launches_by_variant)
    dones = int(sum(int(o[2].sum()) for o in ref))
    stats = [end[1].stat.mean, end[1].stat.var, end[2].stat.mean, end[2].stat.var]
    stats_ok = all(bool(torch.isfinite(x).all()) for x in stats)

    vstate, wstates = wrappers.restore(state[0], blob, state[1:], envs=pipe)
    again = []
    cuda_step.reset_counts()
    run((vstate, *wstates), range(PIPE_CKPT, PIPE_STEPS), again)
    torch.cuda.synchronize()
    rerun_launches = cuda_step.launches
    equal = all(torch.equal(x, y) for a, b in zip(ref, again) for x, y in zip(a, b))

    # the exponential reward norm on the same engine
    pipe_e = wrappers.EnvPipeline(pipe.envs, reward_normalization_method="exponential", **kw)
    state_e, _ = pipe_e.reset(seed=1)
    cuda_step.reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(PIPE_EXP_STEPS):
            state_e, out_e = pipe_e.step(state_e, acts[t])
            finite = finite & torch.isfinite(out_e["obs"]).all() & torch.isfinite(
                out_e["reward"]).all()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    exp_launches = cuda_step.launches

    turns = [(name, time_ms(fn, 20)) for name, fn in (
        ("pipeline", lambda: pipe.step(end, acts[0])),
        ("bare", lambda: pipe.envs.step(end[0], acts[0])),
        ("bare", lambda: pipe.envs.step(end[0], acts[0])),
        ("pipeline", lambda: pipe.step(end, acts[0])))]
    pipe_ms = sum(ms for name, ms in turns if name == "pipeline") / 2
    bare_ms = sum(ms for name, ms in turns if name == "bare") / 2
    print(f"[pipeline] {card}: MT10 via make_mt_envs, {n} envs, obs "
          f"{tuple(ref[0][0].shape)}: {PIPE_STEPS} steps with no host sync in "
          f"{wall - t_ckpt:.2f} s wall, dones in steps {PIPE_CKPT}-{PIPE_STEPS - 1} "
          f"{dones}; launches {total}, by variant {launches}; checkpoint "
          f"{len(blob)} bytes in {t_ckpt:.2f} s; restored re-run of {len(again)} steps "
          f"bit-equal {equal} ({rerun_launches} launches); running stats finite "
          f"{stats_ok}; exponential norm {PIPE_EXP_STEPS} steps ({exp_launches} "
          f"launches); phase {time.time() - t_phase:.1f} s")
    print(f"[pipeline time] {card}: in turns "
          + ", ".join(f"{name} {ms:.3f} ms" for name, ms in turns)
          + f": pipeline step {pipe_ms:.3f} ms against the bare fused step "
          f"{bare_ms:.3f} ms on the same inputs (wrappers {pipe_ms - bare_ms:.3f} ms)")
    if not bool(finite):
        fail("pipeline: non-finite outputs")
    if not stats_ok:
        fail("pipeline: non-finite running statistics")
    if total != PIPE_STEPS or launches != [PIPE_STEPS] * 4:
        fail(f"pipeline: kernel launches {total} {launches} for {PIPE_STEPS} steps")
    if rerun_launches != PIPE_STEPS - PIPE_CKPT or exp_launches != PIPE_EXP_STEPS:
        fail(f"pipeline: launches {rerun_launches} (re-run), {exp_launches} (exponential)")
    if dones < n:
        fail(f"pipeline: only {dones} dones after the checkpoint: the window must "
             f"cross autoresets")
    if not equal:
        fail("pipeline: the run restored from the checkpoint is not bit-equal")
    return variant_records(pipe.envs, dev, acts[0], count_ops("mt10"), "mt10 pipeline",
                           launches, errs, card)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from metaworld_tpu_torch.physics import _build, cuda_step

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {kind}", flush=True)

    # ---- 2. build ----
    t0 = time.time()
    _build.build_cuda()
    print(f"[build] nvcc, one translation unit: {time.time() - t0:.1f} s, flags "
          f"{' '.join(_build.NVCC_FLAGS)}")
    for line in _build.ptxas_log.splitlines():
        if line.strip():
            print(f"[ptxas] {line.strip()}")

    # ---- 3. kernel vs plain at full width (MT10) ----
    eng = bench_engine(dev, N_ENVS, max_episode_steps=MAX_EPISODE_STEPS)
    blocks, runs = eng.block_table, eng.variant_runs
    info = cuda_step.kernel_info()
    print(f"[kernel] {card}: {info['regs']} registers and {info['local_bytes']} B "
          f"local memory per thread; {info['shared_bytes']} B shared memory per "
          f"block; {info['blocks_per_sm']} blocks per SM")
    print(f"[blocks] one launch of {blocks.host.shape[0]} blocks, by variant "
          f"{blocks.blocks_by_variant} (heaviest first); earlier schedule: "
          f"{len(runs)} launches " + ", ".join(f"v{v}@{s}+{c}" for v, s, c in runs))
    table, ids = eng.scene_table, eng.task_ids
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    cuda_step.reset_counts()
    err_by_variant = hold_steps(eng, dev, gen, PHYS_STEPS, "kernel-vs-plain")
    if cuda_step.launches != PHYS_STEPS or min(cuda_step.blocks_by_variant) == 0:
        fail(f"expected {PHYS_STEPS} launches running every variant, got "
             f"{cuda_step.launches}, blocks by variant {cuda_step.blocks_by_variant}")
    print(f"[kernel-vs-plain] {cuda_step.launches} launches; blocks by variant "
          f"{cuda_step.blocks_by_variant}; max err by variant "
          f"{['%.3e' % e for e in err_by_variant]}")

    # ---- 4a. the fused step, kernel vs plain physics, small batch ----
    worst = fused_small(dev, gen, "mt10", 60)
    bad = {k: v for k, v in worst.items() if not v <= 1e-4}
    print(f"[fused-small] kernel vs plain physics, 12 steps x 60 envs: worst "
          f"{max(worst.values()):.3e}")
    if bad:
        fail(f"fused step with the kernel disagrees with the plain physics: {bad}")

    # ---- 4b. the main path: 520 fused steps at full width ----
    gen.manual_seed(2)
    main_launches, acts = fused_main(eng, dev, gen, 49, "fused")

    # ---- 5. timings ----
    state, _ = eng.reset()
    sim = state.env.sim
    act = acts[0]
    mocap, target, effort = cuda_step._sim_and_ctl(table, ids, sim, act)
    ctl = torch.cat([target.T, effort[None]]).contiguous()
    rows = cuda_step.pack_sim_rows(sim).contiguous()
    first_env = blocks.host[:, 1]
    run_tables = [blocks.select((first_env >= s) & (first_env < s + c))
                  for _, s, c in runs]

    def one_launch():
        cuda_step.launch_rows(table.rows, ids, rows, ctl, blocks)

    def per_run_launches():
        for bt in run_tables:
            cuda_step.launch_rows(table.rows, ids, rows, ctl, bt)

    turns = [(name, time_ms(fn, 50)) for name, fn in (
        ("one", one_launch), ("runs", per_run_launches),
        ("runs", per_run_launches), ("one", one_launch))]
    kernel_ms = sum(ms for name, ms in turns if name == "one") / 2
    runs_ms = sum(ms for name, ms in turns if name == "runs") / 2
    plain_ms = time_ms(lambda: cuda_step.plain_control_step(table, ids, sim, act), 3, 1)
    wrapper_ms = time_ms(lambda: cuda_step.control_step(table, ids, sim, act, blocks), 20)
    fused_ms = time_ms(lambda: eng.step(state, act), 20)

    ops = count_ops("mt10")
    bound_bytes_ms, bound_ops_ms = control_step_bound(eng, ops)
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    print(f"[schedule] {card}: kernel per control step, in turns "
          + ", ".join(f"{name} {ms:.4f} ms" for name, ms in turns)
          + f": one launch {kernel_ms:.4f} ms against {len(runs)} launches "
          f"{runs_ms:.4f} ms ({runs_ms / kernel_ms:.2f}x)")
    print(f"[time] {card}: kernel {kernel_ms:.4f} ms per control step "
          f"(one launch, N={N_ENVS}); wrapper incl. weld target and "
          f"pack/unpack {wrapper_ms:.4f} ms; plain torch physics {plain_ms:.2f} ms")
    print(f"[bound] {card}: bytes {bound_bytes_ms * 1e3:.2f} us, ops "
          f"{bound_ops_ms * 1e3:.2f} us -> bound {bound_ms * 1e3:.2f} us "
          f"({'operations' if bound_ops_ms >= bound_bytes_ms else 'bytes'}); "
          f"roofline share {bound_ms / kernel_ms:.3f}")
    print(f"[time] {card}: fused MT10 step {fused_ms:.3f} ms, "
          f"{N_ENVS / fused_ms * 1e3:.0f} env-steps/s at N={N_ENVS}")
    kernels = variant_records(eng, dev, act, ops, "mt10", main_launches,
                              err_by_variant, card)
    del eng, state, sim, rows, ctl, acts

    # ---- 6-8. MT25; 9-11. MT50 ----
    kernels += run_path("mt25", dev, gen, card, 3, 75, fused_ms)
    mt50 = run_path(
        "mt50", dev, gen, card, 5, 100, fused_ms,
        must_see=(("unanchored", "peg-unplug-side-v3"), ("attached", "hammer-v3"),
                  ("hooked", "handle-pull-v3"), ("hooked", "handle-pull-side-v3")))
    kernels += mt50

    # ---- 12. ML45, both splits ----
    gen.manual_seed(7)
    ml45_errs = run_ml45(dev, gen, card)

    # ---- 13. the 50 experts in closed loop on MT50 ----
    t0 = time.time()
    loop_records, slot_mean = run_closed_loop(dev, card, mt50)
    kernels += loop_records
    print(f"[closed-loop] phase {time.time() - t0:.1f} s")

    # ---- 14-16. evaluation(), metalearning_evaluation(), the pipeline ----
    kernels += run_evaluation(dev, card, slot_mean, mt50)
    gen.manual_seed(15)
    kernels += run_metalearning(dev, card, gen, ml45_errs["test"])
    gen.manual_seed(16)
    kernels += run_pipeline(dev, card, gen)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
