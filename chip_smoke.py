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
     N = 131072 for 60 steps, so every slot crosses autoreset at
     max_episode_steps=50: finite outputs, episode lengths wrap to 1, the
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
     slots per task, then 60 fused steps at N = 131072 with the checks of
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
 17. the per-env facade: `SawyerEnv(name, seed=0, device="cuda")` with
     its first MT1(seed=0) goal on every one of the 50 tasks, driven by the
     task's scripted expert for 50 steps (reach, push and drawer-open on
     to success, which each must reach within 500 steps): the kernel at
     N = 1 (one block of 128 lanes, one live env, the task's own variant),
     one launch per step; then, from each task's reset state and its state
     after the 50 expert steps, `env_step` with the kernel at N = 1 against
     the plain version (one call over the 100 states) for 3 control steps
     of random actions, each from the plain version's state, <= 1e-4 per
     state field, one launch per kernel step; then a `GymVectorBatch` over `make_mt_envs("MT10",
     envs_per_task=13107)` (N = 131070, numpy in and out) for 20 steps, one
     launch each. Prints ms per SawyerEnv.step, the kernel's and the plain
     version's ms at N = 1 per variant and the phase's seconds.
 18. autograd on the card: `vector.BatchedEnvs` (from_benchmark(fused=
     False), the plain physics) on reach-v3: the gradient of 64 slots' mean
     reward summed over 8 steps of a held action against central
     differences (rtol 2e-2, atol 2e-3), whose 8 windows run as 8 more
     blocks of 64 slots in the same batch; finite jacobians of the next
     sim state in the action on reach, push, drawer-open and hammer, in
     one BatchedEnvs and one backward pass (one slot per jacobian row); the kernel path refusing an action that requires grad
     (`env_step` and the fused engine raise, naming physics='torch'); two
     APG updates (`train_apg`: Pi with 128 hidden units, Adam; H = 20, then
     H = 10 to keep the script inside its time limit) with
     finite loss and gradients, no kernel launch in the differentiable
     path. Prints the seconds per update (forward, backward) and the peak
     device memory.
 19. the v1 reward family: the MT50 layout of phase 9 built with
     `reward_function_version="v1"` specs (N = 131072): kernel vs plain
     for 2 control steps, the fused step with the kernel against the plain
     physics on 100 slots, FUSED_STEPS fused steps with every check of
     phase 4 (every reward and metric finite, one launch per step, no
     host sync); the plain v1 tail recomputed on the kernel's post-step
     state equal to the engine's reward, success and obj_to_target in
     every value on 4 steps (a routing and consistency check: the engine
     calls the same tail); on the same steps, the first 4 slots of every
     task recomputed by the port on the CPU (held against the JAX v1
     functions by the tests), every v1 metric within
     test_torch_v1_rewards.py's tolerances; the tails' ms v1 against v2 in turns on one
     state (ATen ops of each, device kernels of a v1 step); then
     `SawyerEnv(name, reward_function_version="v1")` on assembly,
     basketball, button-press-topdown and hammer (one task per variant),
     50 expert steps each with the kernel at N = 1, the reward equal to
     the plain v1 tail on the kernel's state.
 20. `parallel.ShardedEnvs(MT10, envs_per_task=13106, devices=[cuda,
     cuda])` (N = 131060, 2 shards of 65530 on one card, one stream
     each): 20 steps with one launch per shard per step and no host
     sync; every shard equal in every output and final state value to
     its own FusedBatchedEnvs stepped by hand with the shard's seed and
     actions; when more than one card is visible, the same over
     `make_env_mesh()`; the 2-shard step against one engine of the same N
     in turns (one card: nothing multi-GPU is measured); kernel vs plain
     and the kernel records on a shard's layout.
 21. the offline-data loop: `record_dataset.record` with the experts on
     MT10 at N = 10240 (`benchmarks._mt`) for 100 steps into the native
     store in a temporary directory (deleted after): one launch per step,
     none dropped, every record read back by the port's reader equal to
     what was written, env-steps/s with the IO; then `train_bc.run` at the
     script's defaults (drawer-open-v3, 16 envs, one 500-step episode
     recorded, 60 epochs, 500-step eval on fresh goals): the loss finite
     and lower at the last epoch than the first, and the eval loop again
     with no host sync and one launch per step, its success equal to the
     run's; bc_success_rate beside the JAX script's on a CPU.
 22. PPO (`train_ppo`): MT10 at N = 131070 (rollout 16, 3 updates of 2
     epochs x 4 minibatches), each rollout and GAE with one launch per
     step and no host sync, every statistic finite, the PPO loss on an
     update's batch lower after the learner than before in all but a
     tenth of the updates (`check_learner`); rollout ms per step and
     learner ms per update (CUDA events), env-steps/s and peak memory;
     then reach-v3 for 40 updates at the script's defaults, each
     update held to the same checks, the first and last mean reward and
     the success rate beside the JAX script's on a CPU (whose reward falls
     over those 40 updates: PERF.md).
 23. open-loop parity: the 50 golden action tapes (tests/golden) replayed
     in one engine of 50 slots (`trajectory_parity.replay_engine`), 500
     steps with one launch each and no host sync; every task within the
     port's copy of the ceilings of tests/test_trajectory_parity.py, hand
     and object p95 and reward MAE printed per task.
 24. the host tools: `policy_testing` on door-unlock, stick-pull,
     button-press-wall and door-lock (goal rows 0..49 of MT1(name,
     seed=42), 500 expert steps), the failed rows equal to
     scripts/policy_testing.py's on a CPU; `scaling_bench --sizes 1,2` (two
     shards repeat the one card: mechanics only), `profile_memory` on MT10
     at 13107 per task and `keyboard_control` on piped keys, with their
     launch counts.

The line before the last is the per-kernel JSON record, one record per
variant and path (MT10, MT25, MT50; the MT50 closed loop and the MT50
evaluation, whose launches are phases 13's and 14's and whose times are
phase 11's on the same layout; the ML45 test split's metalearning and
the MT10 pipeline, timed on their own layouts; the per-env facade at
N = 1, whose launches are phase 17's expert drive; the v1 MT50 layout of
phase 19 and a shard's MT10 layout of phase 20; the layouts of phases
21-24, each held against the plain version for 4 control steps: MT10 at
N = 10240, drawer-open at 16, MT10 PPO at 131070, reach-v3 PPO at 64, the
50-slot parity engine, and the four policy_testing engines of 50); the
last line is
{"ok": true, "device": {...}}. The script imports nothing of JAX.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

N_ENVS = 131072
# the main path's fused steps and its episodes: long enough that every slot
# crosses one autoreset (the reference's 500-step episodes run in phases
# 13-14); 60 steps of 50-step episodes keep the script inside its time
# limit with phases 21-24
FUSED_STEPS = 60
MAX_EPISODE_STEPS = 50
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
FACADE_EXPERT_STEPS = 50
FACADE_HOLD_STEPS = 3
FACADE_SUCCESS = ("reach-v3", "push-v3", "drawer-open-v3")
FACADE_MAX_STEPS = 500
GYM_PER_TASK = 13107  # MT10 x 13107 = 131070 slots
GYM_STEPS = 20
APG_N = 64
# two APG updates at depths below the JAX recipe's horizon of 60 (164 s an
# update on the card), which keeps the whole script with phases 21-24
# inside its time limit on a slow host
APG_HORIZONS = (20, 10)
GRAD_STEPS = 8
V1_HOLD_STEPS = 2
V1_TAIL_STEPS = 4
V1_CPU_SLOTS = 4
V1_METRICS = ("reward", "unscaled_reward", "success", "near_object",
              "grasp_success", "grasp_reward", "in_place_reward", "obj_to_target")
V1_FACADE = ("assembly-v3", "basketball-v3", "button-press-topdown-v3", "hammer-v3")
SHARD_PER_TASK = 13106  # MT10 x 13106 = 131060 slots, 2 shards of 65530
SHARD_STEPS = 20
REC_PER_TASK = 1024  # MT10 x 1024 = 10240 slots: 1.9 MB a record
REC_STEPS = 100      # 190 MB in all, inside the store's 256 MB ring
PPO_ARGS = ["--bench", "MT10", "--envs-per-task", "13107", "--rollout", "16",
            "--updates", "3", "--epochs", "2", "--minibatches", "4"]
REACH_PPO_ARGS = ["--env", "reach-v3", "--updates", "40"]
# scripts/train_bc.py --cpu, scripts/train_ppo.py --env reach-v3 --updates 40
# --cpu and scripts/policy_testing.py (the JAX package on a CPU), recorded
# in PERF.md: expectations printed beside the card's results
JAX_CPU_BC_SUCCESS = 1.0
JAX_CPU_REACH_PPO = {"first_mean_reward": 0.9507, "last_mean_reward": 0.492,
                     "success_rate": 0.0}
# the failed goal rows among rows 0..49 of MT1(name, seed=42), 500 expert
# steps (37, 40, 47 and 48 successes)
JAX_CPU_POLICY_TESTING = {
    "door-unlock-v3": [2, 16, 17, 18, 19, 23, 28, 31, 33, 35, 47, 48, 49],
    "stick-pull-v3": [4, 8, 15, 25, 34, 38, 43, 44, 46, 48],
    "button-press-wall-v3": [1, 24, 34],
    "door-lock-v3": [9, 16],
}
PT_GOALS = 50
SCALING_ARGS = ["--sizes", "1,2", "--steps", "20"]
KEYS_PIPED = "wwddqq ee aass x"
JAC_CASES = (("reach-v3", (0.0, 0.65, 0.02, 0.0, 0.8, 0.2)),
             ("push-v3", (0.0, 0.65, 0.02, 0.05, 0.8, 0.02)),
             ("drawer-open-v3", (0.0, 0.9, 0.0)),
             ("hammer-v3", (0.05, 0.45, 0.0)))


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "unknown"


# the plain version is dispatch-bound (0.5-1.1 s a control step at any N),
# and every layout it is timed on has just run it in its hold: one call
PLAIN_TIMING = dict(reps=1, warmup=0)


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


def fused_small(dev, gen, path, n, **engine_kw):
    """The fused step with the kernel against the fused step with the plain
    physics, 12 steps of `n` slots from one shared state (`engine_kw` go to
    both engines)."""
    from metaworld_tpu_torch import vector

    kw = dict(max_episode_steps=4, task_select="pseudorandom", **engine_kw)
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
    """FUSED_STEPS fused steps at full width with every check of the main path;
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
            for k in ("obs", "reward", "episode_return", "success",
                      "near_object", "grasp_success", "grasp_reward",
                      "in_place_reward", "obj_to_target", "unscaled_reward"):
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
        if n_v == 0:  # a layout of a few tasks need not run every variant
            continue
        k_ms = time_ms(lambda: cuda_step.launch_rows(table.rows, ids, rows, ctl, vblocks), 50)
        idx = torch.nonzero(variant == v).flatten()
        sim_v = sim.map(lambda t: t[idx])
        p_ms = time_ms(lambda: cuda_step.plain_control_step(
            table, ids[idx], sim_v, act[idx]), **PLAIN_TIMING)
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
    on `n_small` slots, FUSED_STEPS fused steps at N = 131072 and the timings.
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
        table, ids, sim, act), **PLAIN_TIMING)
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


def run_facade(dev, card):
    """Phase 17: SawyerEnv with the expert on all 50 tasks (the kernel at
    N = 1), env_step with the kernel against the plain version from each
    task's reset and expert-reached states, and a GymVectorBatch over MT10
    at full width. Returns the per-env `kernels` records."""
    import metaworld_tpu_torch as mw
    from metaworld_tpu_torch import gym_adapter
    from metaworld_tpu_torch.envs import core, registry
    from metaworld_tpu_torch.physics import cuda_step
    from metaworld_tpu_torch.policies import get_policy
    from metaworld_tpu_torch.types import tree_map

    t_phase = time.time()
    names = task_names("mt50")
    variant = {n: int(core.step_tables(registry.get_spec(n), dev, 1)[2].host[0, 0])
               for n in names}

    # the main path: the expert through SawyerEnv.step, one launch per step
    starts, reached, steps, solved = {}, {}, {}, {}
    torch.cuda.synchronize()
    cuda_step.reset_counts()
    t0 = time.time()
    for name in names:
        env = mw.SawyerEnv(name, seed=0, device=dev)
        env.set_task(mw.MT1(name, seed=0, num_goals=1).train_tasks[0])
        obs, _ = env.reset()
        starts[name] = env._state
        pol = get_policy(name)
        success, first = 0.0, None
        limit = FACADE_MAX_STEPS if name in FACADE_SUCCESS else FACADE_EXPERT_STEPS
        for t in range(limit):
            obs, _, _, _, info = env.step(
                pol(torch.from_numpy(obs[None].astype(np.float32)))[0].numpy())
            if info["success"] and first is None:
                first = t + 1
            if t + 1 == FACADE_EXPERT_STEPS:
                reached[name] = env._state
            if first is not None and t + 1 >= FACADE_EXPERT_STEPS:
                break
        steps[name], solved[name] = t + 1, first
    torch.cuda.synchronize()
    wall = time.time() - t0
    total, launches = cuda_step.launches, list(cuda_step.launches_by_variant)
    n_steps = sum(steps.values())
    print(f"[facade] {card}: SawyerEnv on the card, 50 tasks, expert for "
          f"{FACADE_EXPERT_STEPS} steps (reach/push/drawer-open to success): "
          f"{n_steps} steps in {wall:.2f} s wall, {wall / n_steps * 1e3:.2f} ms per "
          f"SawyerEnv.step (expert on the host included); launches {total}, by "
          f"variant {launches}; tasks by variant "
          f"{[sum(v == k for v in variant.values()) for k in range(4)]}; first "
          f"success " + ", ".join(f"{n} step {solved[n]}" for n in FACADE_SUCCESS))
    if total != n_steps or sum(launches) != n_steps:
        fail(f"facade: {total} kernel launches ({launches}) for {n_steps} steps")
    if min(launches) == 0:
        fail(f"facade: a variant never ran at N = 1: {launches}")
    unsolved = [n for n in FACADE_SUCCESS if solved[n] is None]
    if unsolved:
        fail(f"facade: the expert did not reach success on {unsolved}")

    # env_step with the kernel at N = 1 against the plain version, from the
    # reset and the expert-reached state of every task; the plain side is
    # one plain_control_step over all 100 states (its slots are independent)
    table = cuda_step.build_scene_table([registry.get_spec(n).scene for n in names], dev)
    slots = [(n, st) for n in names for st in (starts[n], reached[n])]
    ids = torch.tensor([names.index(n) for n, _ in slots], dtype=torch.int32,
                       device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    err_by_variant = [0.0] * 4
    worst = (0.0, None, None)
    for t in range(FACADE_HOLD_STEPS):
        act = torch.rand(len(slots), 4, generator=gen, device=dev) * 2 - 1
        before = cuda_step.launches
        got = [core.env_step(registry.get_spec(n), st, act[k:k + 1], physics="cuda")[0]
               for k, (n, st) in enumerate(slots)]
        if cuda_step.launches - before != len(slots):
            fail(f"facade: {cuda_step.launches - before} launches for "
                 f"{len(slots)} N = 1 steps")
        sim = tree_map(lambda *x: torch.cat(x), *[st.sim for _, st in slots])
        ref, _ = core.keep_stable(
            cuda_step.plain_control_step(table, ids, sim, act), sim)
        for k, (n, _) in enumerate(slots):
            for f, d in field_errors(got[k].sim, ref.map(lambda x: x[k:k + 1]),
                                     1).items():
                e = float(d.max())
                err_by_variant[variant[n]] = max(err_by_variant[variant[n]], e)
                if not e <= worst[0]:
                    worst = (e, n, f)
        slots = [(n, got[k].replace(sim=ref.map(lambda x: x[k:k + 1])))
                 for k, (n, _) in enumerate(slots)]
    print(f"[facade-vs-plain] {card}: env_step at N = 1, "
          f"{FACADE_HOLD_STEPS * len(slots)} kernel steps over 50 tasks x (reset, "
          f"expert-reached) x {FACADE_HOLD_STEPS}: max abs err {worst[0]:.3e} "
          f"({worst[1]} {worst[2]}); by variant "
          f"{['%.3e' % e for e in err_by_variant]}")
    if not worst[0] <= 1e-4:
        fail(f"facade: kernel disagrees with its plain version at N = 1 on "
             f"{worst[1]}: {worst[2]} {worst[0]:.3e}")

    # the Gymnasium vector facade over MT10 at full width
    batch = gym_adapter.GymVectorBatch(mw.make_mt_envs(
        "MT10", seed=0, envs_per_task=GYM_PER_TASK, use_one_hot=True,
        device=dev), seed=0)
    n = batch.num_envs
    obs, _ = batch.reset()
    rng = np.random.default_rng(17)
    acts = [rng.uniform(-1, 1, (n, 4)).astype(np.float32) for _ in range(GYM_STEPS)]
    finite = bool(np.isfinite(obs).all())
    torch.cuda.synchronize()
    cuda_step.reset_counts()
    t0 = time.time()
    for a in acts:
        obs, rew, term, trunc, info = batch.step(a)
        finite &= bool(np.isfinite(obs).all() and np.isfinite(rew).all())
    gym_wall = time.time() - t0
    print(f"[facade gym] {card}: GymVectorBatch over MT10, {n} envs, obs "
          f"{obs.shape}: {GYM_STEPS} steps in {gym_wall:.2f} s wall "
          f"({gym_wall / GYM_STEPS * 1e3:.2f} ms per step with numpy in and out); "
          f"launches {cuda_step.launches}; final_info keys "
          f"{sorted(info['final_info'])}")
    if cuda_step.launches != GYM_STEPS:
        fail(f"facade gym: {cuda_step.launches} launches for {GYM_STEPS} steps")
    if not finite or obs.shape != (n, 49):
        fail(f"facade gym: non-finite outputs or obs shape {obs.shape}")

    # times at N = 1, one task of each variant
    ops = count_ops("mt50")
    bytes_per_env = (2 * cuda_step.SIM_ROWS + 4) * 4 + 4
    records = []
    for v in range(4):
        name = next(n for n in names if variant[n] == v)
        spec = registry.get_spec(name)
        table, ids, blocks = core.step_tables(spec, dev, 1)
        sim = starts[name].sim
        act = torch.rand(1, 4, generator=gen, device=dev) * 2 - 1
        _, target, effort = cuda_step._sim_and_ctl(table, ids, sim, act)
        ctl = torch.cat([target.T, effort[None]]).contiguous()
        rows = cuda_step.pack_sim_rows(sim).contiguous()
        k_ms = time_ms(lambda: cuda_step.launch_rows(table.rows, ids, rows, ctl, blocks), 200)
        p_ms = time_ms(lambda: cuda_step.plain_control_step(table, ids, sim, act),
                       **PLAIN_TIMING)
        step_ms = time_ms(lambda: core.env_step(spec, starts[name], act), 20)
        b_bytes = (bytes_per_env + table.rows.numel() * 4) / HBM_BYTES_PER_S * 1e3
        b_ops = ops[v] * 5 / F32_OPS_PER_S * 1e3
        records.append({
            "name": f"step_kernel_v{v}", "path": "per-env N=1", "route": "cuda",
            "source": "metaworld_tpu_torch/csrc/step_kernel.cu",
            "replaces": TPU_KERNEL, "launches": launches[v],
            "max_abs_err": err_by_variant[v], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(b_bytes, b_ops),
            "bound_by": "operations" if b_ops >= b_bytes else "bytes",
            "library_ms": None,
        })
        print(f"[facade kernel v{v}] {card}: {name} at N = 1: kernel {k_ms:.4f} ms "
              f"per control step, plain {p_ms:.2f} ms, env_step with the kernel "
              f"{step_ms:.2f} ms; bound {max(b_bytes, b_ops) * 1e3:.4f} us")
    print(f"[facade] phase {time.time() - t_phase:.1f} s")
    return records


def run_autograd(dev, card):
    """Phase 18: backprop through the plain physics on the card: a gradient
    against central differences, finite jacobians, the kernel refusing
    grad, and two APG updates (H = 20, then H = 10)."""
    from metaworld_tpu_torch import benchmarks, train_apg, vector
    from metaworld_tpu_torch.envs import core, registry
    from metaworld_tpu_torch.physics import cuda_step
    from metaworld_tpu_torch.types import MAX_RAND, SimState

    t_phase = time.time()
    cuda_step.reset_counts()
    # the 8-step window of APG_N slots, and the 8 windows of central
    # differences in the same batch: block k of APG_N slots (same goal
    # rows in every block) holds the action a0 + d_k, d_0 = 0
    eps = 3e-3
    shifts = torch.cat([torch.zeros(1, 4), eps * torch.eye(4), -eps * torch.eye(4)]).to(dev)
    n_blocks = shifts.shape[0]
    envs = vector.from_benchmark(benchmarks.MT1("reach-v3", seed=0),
                                 envs_per_task=APG_N * n_blocks, fused=False,
                                 device=dev, task_select="pseudorandom")
    goal_idx = (torch.arange(APG_N * n_blocks, device=dev, dtype=torch.int32)
                % APG_N) % 50
    a0 = torch.zeros(4, device=dev, requires_grad=True)
    t0 = time.time()
    state, _ = envs.reset(goal_idx=goal_idx)
    acts = torch.cat([a0[None], a0.detach() + shifts[1:]]).repeat_interleave(APG_N, 0)
    window = torch.zeros(n_blocks, device=dev)
    for _ in range(GRAD_STEPS):
        state, out = envs.step(state, acts)
        window = window + out["reward"].view(n_blocks, APG_N).mean(1)
    window[0].backward()
    torch.cuda.synchronize()
    t_grad = time.time() - t0
    g = a0.grad.cpu().numpy()
    w = window.detach().cpu().numpy()
    fd = (w[1:5] - w[5:9]) / (2 * eps)
    grad_ok = bool(np.allclose(g, fd, rtol=2e-2, atol=2e-3))
    print(f"[autograd] {card}: BatchedEnvs reach-v3, physics {envs.physics}, "
          f"{n_blocks} blocks of N = {APG_N}: d(mean reward over {GRAD_STEPS} steps)/"
          f"d(action) {np.array2string(g, precision=6)}, central differences "
          f"{np.array2string(fd, precision=6)}; forward and backward {t_grad:.2f} s")
    if not grad_ok:
        fail(f"autograd: gradient {g} differs from central differences {fd}")

    # the jacobians of the next sim state in the action on the four tasks in
    # one BatchedEnvs and one backward pass: each task holds one slot per
    # state component (72), all in the task's same state and action, and
    # slot j's cotangent is one-hot on component j, so slot j's action
    # gradient is row j of the task's jacobian (the slots are independent)
    names = [n for n, _ in JAC_CASES]
    tables = []
    for _, vec in JAC_CASES:
        row = np.zeros((1, MAX_RAND))
        row[0, :len(vec)] = vec
        tables.append(row)
    fields = list(SimState.__dataclass_fields__)
    t0 = time.time()
    base = core.base_sim_state(registry.get_spec(names[0]), 1, dev)
    width = sum(getattr(base, f)[0].numel() for f in fields)
    jenv = vector.BatchedEnvs([registry.get_spec(n) for n in names],
                              [width] * len(names), tables, device=dev)
    jstate, _ = jenv.reset()
    a = torch.tensor([0.1, 0.05, -0.1, 0.3], device=dev).repeat(jenv.num_envs, 1)
    a.requires_grad_(True)
    st2, _ = jenv.step(jstate, a)
    flat = torch.cat([getattr(st2.env.sim, f).float().reshape(jenv.num_envs, -1)
                      for f in fields], dim=1)
    onehot = torch.eye(width, device=dev).repeat(len(names), 1)
    (rows,) = torch.autograd.grad(flat, a, onehot)
    jac = rows.view(len(names), width, 4)
    torch.cuda.synchronize()
    t_jac = time.time() - t0
    offsets = np.cumsum([0] + [getattr(st2.env.sim, f)[0].numel() for f in fields])
    hand = slice(int(offsets[fields.index("hand")]), int(offsets[fields.index("hand") + 1]))
    for k, name in enumerate(names):
        finite = torch.isfinite(jac[k]).all(dim=1).cpu().numpy()
        bad = sorted({fields[int(np.searchsorted(offsets, j, side="right")) - 1]
                      for j in np.flatnonzero(~finite)})
        moved = float(jac[k, hand].abs().sum())
        print(f"[autograd jacobian] {name}: d(next sim state)/d(action), "
              f"{width} x 4 entries, non-finite fields {bad}, |d hand/d action| "
              f"{moved:.4f}")
        if bad or not moved > 0:
            fail(f"autograd: jacobian of {name}: non-finite {bad}, hand moved {moved}")
    print(f"[autograd jacobian] four tasks, {jenv.num_envs} slots, one backward pass, "
          f"in {t_jac:.2f} s")

    # the kernel has no backward: its path must refuse, not fall back
    spec = registry.get_spec("reach-v3")
    st, _ = core.env_reset(spec, torch.zeros(1, MAX_RAND, device=dev), 1.0)
    act = torch.zeros(1, 4, device=dev, requires_grad=True)
    fused = vector.from_benchmark(benchmarks.MT1("reach-v3", seed=0, num_goals=2),
                                  envs_per_task=2, device=dev)
    fstate, _ = fused.reset()
    refusals = []
    for what, fn in (("env_step", lambda: core.env_step(spec, st, act)),
                     ("fused step", lambda: fused.step(fstate, act.expand(2, 4)))):
        try:
            fn()
            refusals.append(f"{what}: ran")
        except RuntimeError as err:
            refusals.append(f"{what}: refused" if "physics='torch'" in str(err)
                            else f"{what}: {err}")
    with torch.no_grad():
        core.env_step(spec, st, act)
    print(f"[autograd refusal] the kernel under autograd: {refusals}; under "
          f"no_grad it launched {cuda_step.launches} time(s)")
    if refusals != ["env_step: refused", "fused step: refused"] or cuda_step.launches != 1:
        fail(f"autograd: the kernel path did not refuse grad: {refusals}")

    # two APG updates (train_apg.update, split to time its two halves)
    torch.manual_seed(0)
    apg_envs = vector.from_benchmark(benchmarks.MT1("reach-v3", seed=0),
                                     envs_per_task=APG_N, fused=False, device=dev,
                                     seed=1)
    pi = train_apg.Pi(apg_envs.obs_dim, 128).to(dev)
    opt = torch.optim.Adam(pi.parameters(), lr=2e-3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_step.reset_counts()
    for u, horizon in enumerate(APG_HORIZONS):
        opt.zero_grad(set_to_none=True)
        t0 = time.time()
        loss, reward, success = train_apg.episode_loss(pi, apg_envs, horizon)
        torch.cuda.synchronize()
        t1 = time.time()
        loss.backward()
        norm = torch.nn.utils.clip_grad_norm_(pi.parameters(), 1.0)
        opt.step()
        torch.cuda.synchronize()
        t2 = time.time()
        finite = bool(torch.isfinite(loss)) and bool(torch.isfinite(norm)) and all(
            bool(torch.isfinite(p.grad).all()) for p in pi.parameters())
        print(f"[autograd apg] {card}: update {u}: N = {APG_N}, H = {horizon}: loss "
              f"{loss.item():.5f}, mean reward {float(reward):.4f}, success "
              f"{float(success):.3f}, grad norm {float(norm):.4f}; forward "
              f"{t1 - t0:.2f} s, backward and Adam {t2 - t1:.2f} s, update "
              f"{t2 - t0:.2f} s")
        if not finite:
            fail(f"autograd: APG update {u} has a non-finite loss or gradient")
    peak = torch.cuda.max_memory_allocated()
    print(f"[autograd apg] peak device memory {peak / 2**30:.3f} GiB; kernel "
          f"launches in the differentiable path {cuda_step.launches}; phase "
          f"{time.time() - t_phase:.1f} s")
    if cuda_step.launches != 0:
        fail(f"autograd: the differentiable path launched the kernel "
             f"{cuda_step.launches} times")


def device_kernels(fn):
    """Device kernels one call of `fn` launches, from torch.profiler, or
    None where the profiler does not reach the device."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())
    return n or None


def v1_off(got, ref, key, name):
    """(values off, worst error over tolerance) of a v1 metric against its
    reference, at tests/test_torch_v1_rewards.py's tolerances: rewards
    within 1e-5 * max(1, |ref|) (coffee-pull-v3: max(10, |ref|), ROADMAP
    C5), every other metric within 1e-6 * max(1, |ref|)."""
    got, ref = got.double(), ref.double()
    reward = key in ("reward", "unscaled_reward")
    floor = 10.0 if reward and name == "coffee-pull-v3" else 1.0
    tol = (1e-5 if reward else 1e-6) * ref.abs().clamp(min=floor)
    ratio = (got - ref).abs() / tol
    return int((ratio > 1).sum()), float(ratio.max())


def run_v1(dev, card, gen):
    """Phase 19: the v1 reward family on the card: the MT50 layout of
    phase 9 built with v1 specs, kernel vs plain, the fused step with the
    kernel against the plain physics, FUSED_STEPS fused steps with every
    check of the main path, the plain v1 tail on the kernel's post-step
    state against the engine's reward (bit for bit, a routing and
    consistency check), a sample of the card's v1 metrics against the port
    on the CPU (test_torch_v1_rewards.py's tolerances), the tails' time v1
    against v2 in turns, and SawyerEnv(reward_function_version="v1") at
    N = 1 on one task per variant. Returns the v1 layout's `kernels`
    records."""
    import metaworld_tpu_torch as mw
    from metaworld_tpu_torch.envs import core, registry
    from metaworld_tpu_torch.physics import cuda_step
    from metaworld_tpu_torch.policies import get_policy
    from metaworld_tpu_torch.rewards.v1 import V1_REWARDS
    from metaworld_tpu_torch.types import tree_map

    t_phase = time.time()
    names = task_names("mt50")
    eng = bench_engine(dev, N_ENVS, "mt50", max_episode_steps=MAX_EPISODE_STEPS,
                       reward_function_version="v1")
    if [s.reward_fn for s in eng.specs] != [V1_REWARDS[n] for n in names]:
        fail("v1: the engine's specs do not carry the v1 reward functions")
    gen.manual_seed(19)
    errs = hold_steps(eng, dev, gen, V1_HOLD_STEPS, "v1 kernel-vs-plain")
    worst = fused_small(dev, gen, "mt50", 100, reward_function_version="v1")
    print(f"[v1 fused-small] kernel vs plain physics with v1 rewards, 12 steps x "
          f"100 envs: worst {max(worst.values()):.3e}")
    bad = {k: v for k, v in worst.items() if not v <= 1e-4}
    if bad:
        fail(f"v1: fused step with the kernel disagrees with the plain physics: {bad}")
    launches, acts = fused_main(eng, dev, gen, 89, "v1 fused")

    # on the first V1_TAIL_STEPS steps from a reset: the plain v1 tail on
    # the kernel's post-step state against the engine's reward (a routing
    # and consistency check: the engine calls the same tail), and the first
    # V1_CPU_SLOTS slots of every task recomputed by the port on the CPU,
    # which tests/test_torch_v1_rewards.py holds against the JAX functions
    offs = eng._offsets
    state, _ = eng.reset()
    mismatched, cpu_off, cpu_worst = 0, 0, 0.0
    for t in range(V1_TAIL_STEPS):
        act = acts[t]
        new, out = eng.step(state, act)
        env = new.env.replace(prev_obs=state.env.prev_obs)
        for i, spec in enumerate(eng.specs):
            a, b = int(offs[i]), int(offs[i + 1])
            _, ref = core.post_step(spec, tree_map(lambda x: x[a:b], env), act[a:b])
            for k in ("reward", "success", "obj_to_target"):
                mismatched += int((getattr(ref, k) != out[k][a:b]).sum())
            c = a + V1_CPU_SLOTS
            _, cpu = core.post_step(spec, tree_map(lambda x: x[a:c].cpu(), env),
                                    act[a:c].cpu())
            for k in V1_METRICS:
                off, rel = v1_off(out[k][a:c].cpu(), getattr(cpu, k), k, spec.name)
                cpu_off += off
                cpu_worst = max(cpu_worst, rel)
        state = new
    print(f"[v1 tail] plain v1 tail on the kernel's state vs the engine, "
          f"{V1_TAIL_STEPS} steps x {eng.num_envs} envs: {mismatched} values differ")
    print(f"[v1 cpu] {card}: the card's v1 metrics vs the port on the CPU, "
          f"{V1_TAIL_STEPS} steps x {V1_CPU_SLOTS} slots x {len(eng.specs)} tasks: "
          f"{cpu_off} values outside tolerance; worst error / tolerance {cpu_worst:.3f}")
    if mismatched:
        fail(f"v1: the engine's reward differs from the plain v1 tail on "
             f"{mismatched} values")
    if cpu_off:
        fail(f"v1: {cpu_off} of the card's v1 metrics are off the CPU's")

    # the tails' time, v1 against v2, in turns on the same state and actions
    env = state.env
    v2_specs = [registry.get_spec(n) for n in names]

    def tails(specs):
        def run():
            for i, spec in enumerate(specs):
                a, b = int(offs[i]), int(offs[i + 1])
                core.post_step(spec, tree_map(lambda x: x[a:b], env), acts[0][a:b])
        return run

    turns = [(v, time_ms(tails(eng.specs if v == "v1" else v2_specs), 5))
             for v in ("v2", "v1", "v1", "v2")]
    ops = {v: count_aten_ops(tails(eng.specs if v == "v1" else v2_specs))
           for v in ("v1", "v2")}
    kernels_per_step = device_kernels(lambda: eng.step(state, acts[0]))
    print(f"[v1 time] {card}: per-task tails over MT50 at N={eng.num_envs}, in "
          f"turns " + ", ".join(f"{v} {ms:.2f} ms" for v, ms in turns)
          + f"; ATen ops per tails call v1 {ops['v1']}, v2 {ops['v2']}; device "
          f"kernels per v1 fused step {kernels_per_step}")

    # SawyerEnv with the v1 family at N = 1, one task per variant
    facade_launches = 0
    for name in V1_FACADE:
        env1 = mw.SawyerEnv(name, seed=0, device=dev, reward_function_version="v1")
        env1.set_task(mw.MT1(name, seed=0, num_goals=1).train_tasks[0])
        obs, _ = env1.reset()
        spec = registry.get_spec(name, "v1")
        pol = get_policy(name)
        cuda_step.reset_counts()
        worst_r = 0.0
        for _ in range(FACADE_EXPERT_STEPS):
            before = env1._state
            act = pol(torch.from_numpy(obs[None].astype(np.float32)))[0].numpy()
            obs, r, _, _, info = env1.step(act)
            act_t = torch.as_tensor(np.asarray(act, np.float32).reshape(1, 4),
                                    device=dev)
            _, ref = core.step_tail(spec, before, env1._state.sim, act_t)
            worst_r = max(worst_r, abs(float(ref.reward[0]) - r))
            if not np.isfinite(r):
                fail(f"v1 facade {name}: non-finite reward")
        facade_launches += cuda_step.launches
        print(f"[v1 facade] {card}: SawyerEnv({name!r}, reward_function_version="
              f"'v1') at N = 1, {FACADE_EXPERT_STEPS} expert steps, launches "
              f"{cuda_step.launches} (variant {int(core.step_tables(spec, dev, 1)[2].host[0, 0])}); "
              f"last reward {r:.4f}, success {info['success']}; largest "
              f"difference from the plain v1 tail on the kernel's state {worst_r:.3e}")
        if cuda_step.launches != FACADE_EXPERT_STEPS or worst_r != 0.0:
            fail(f"v1 facade {name}: {cuda_step.launches} launches, reward off "
                 f"the plain tail by {worst_r:.3e}")

    records = variant_records(eng, dev, acts[0], count_ops("mt50"), "mt50 v1",
                              launches, errs, card)
    print(f"[v1] phase {time.time() - t_phase:.1f} s")
    return records


def run_sharded(dev, card, gen):
    """Phase 20: ShardedEnvs on MT10 over two shards on this card (and over
    every visible card when there is more than one): SHARD_STEPS steps with
    one launch per shard per step and no host sync, every shard bit-equal
    to its own FusedBatchedEnvs stepped by hand with the shard's seed and
    actions, kernel vs plain on a shard's layout, and the 2-shard step
    against one engine of the same N in turns. Returns the per-shard
    layout's `kernels` records."""
    from metaworld_tpu_torch import benchmarks, vector
    from metaworld_tpu_torch.parallel import ShardedEnvs, make_env_mesh, shard_seed
    from metaworld_tpu_torch.physics import cuda_step

    t_phase = time.time()
    count = torch.cuda.device_count()
    print(f"[sharded] torch.cuda.device_count() = {count}")
    kw = dict(one_hot=True, max_episode_steps=MAX_EPISODE_STEPS)
    bench = benchmarks.MT10(seed=0)

    def check(devices, per_task, tag):
        envs = ShardedEnvs(bench, envs_per_task=per_task, devices=devices, **kw)
        n, m = envs.num_envs, envs.local.num_envs
        acts = [torch.rand(n, 4, generator=gen, device=envs.devices[0]) * 2 - 1
                for _ in range(SHARD_STEPS)]
        states, _ = envs.reset(seed=20)
        envs.step(states, acts[0])  # warm-up: the per-device caches
        states, _ = envs.reset(seed=20)
        torch.cuda.synchronize()
        outs_all = []
        cuda_step.reset_counts()
        t0 = time.time()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for a in acts:
                states, outs = envs.step(states, a)
                outs_all.append(envs.gather(outs, keys=vector.OUT_KEYS))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = list(cuda_step.launches_by_variant)
        total = cuda_step.launches
        # every shard against its own engine, stepped by hand
        differ = 0
        for i, d in enumerate(envs.devices):
            own = vector.from_benchmark(bench, envs_per_task=per_task // envs.n_shards,
                                        device=d, **kw)
            st, _ = own.reset(seed=shard_seed(20, i, envs.n_shards))
            for t, a in enumerate(acts):
                st, out = own.step(st, a[i * m:(i + 1) * m].to(d))
                for k in vector.OUT_KEYS:
                    differ += int((out[k].to(envs.devices[0]) != outs_all[t][k][i * m:(i + 1) * m]).sum())
            fin = states[i].env.sim.map(lambda x: x.to(envs.devices[0]))
            mine = st.env.sim.map(lambda x: x.to(envs.devices[0]))
            for f in mine.__dataclass_fields__:
                differ += int((getattr(mine, f) != getattr(fin, f)).sum())
        finite = all(bool(torch.isfinite(o["obs"]).all() and torch.isfinite(o["reward"]).all())
                     for o in outs_all)
        print(f"[sharded {tag}] {card}: {envs.n_shards} shards of {m} envs on "
              f"{[str(d) for d in envs.devices]}, {SHARD_STEPS} steps in {wall:.2f} s "
              f"wall; launches {total}, by variant {launches}; values differing from "
              f"the shards' own engines stepped by hand {differ}")
        if total != SHARD_STEPS * envs.n_shards:
            fail(f"sharded {tag}: {total} launches for {SHARD_STEPS} steps of "
                 f"{envs.n_shards} shards")
        if differ or not finite:
            fail(f"sharded {tag}: {differ} values differ from the hand-run "
                 f"shards, finite {finite}")
        return envs, launches

    envs, launches = check([dev, dev], SHARD_PER_TASK, "x2 on one card")
    if count > 1:
        check(make_env_mesh(), count * (SHARD_PER_TASK // count), f"x{count} cards")

    # the 2-shard step against one engine of the same N, in turns
    one = vector.from_benchmark(bench, envs_per_task=SHARD_PER_TASK, device=dev, **kw)
    act = torch.rand(one.num_envs, 4, generator=gen, device=dev) * 2 - 1
    st1, _ = one.reset()
    sts, _ = envs.reset()
    turns = []
    for which in ("one", "two", "two", "one"):
        fn = ((lambda: one.step(st1, act)) if which == "one"
              else (lambda: envs.step(sts, act)))
        turns.append((which, time_ms(fn, 10)))
    print(f"[sharded time] {card}, one card: MT10 at N={one.num_envs}, in turns "
          + ", ".join(f"{w} {ms:.3f} ms" for w, ms in turns)
          + " (two = 2 shards on this card, one stream each; one = one "
          "FusedBatchedEnvs); nothing multi-GPU is measured here")

    # kernel vs plain and the records on a shard's layout
    shard = envs.local
    errs = hold_steps(shard, dev, gen, V1_HOLD_STEPS, "shard kernel-vs-plain")
    records = variant_records(shard, dev, act[:shard.num_envs], count_ops("mt10"),
                              "mt10 shard of 2", launches, errs, card)
    print(f"[sharded] phase {time.time() - t_phase:.1f} s")
    return records


def held_records(eng, dev, gen, path, launches, card, ops_path):
    """The kernel against its plain version on `eng`'s layout for
    ML45_HOLD_STEPS control steps, and the layout's `kernels` records with
    `launches` (by variant) from its run."""
    errs = hold_steps(eng, dev, gen, ML45_HOLD_STEPS, f"{path}-vs-plain")
    act = torch.rand(eng.num_envs, 4, generator=gen, device=dev) * 2 - 1
    return variant_records(eng, dev, act, count_ops(ops_path), path, launches,
                           errs, card)


class KeepWriter:
    """A trajectory writer that keeps a host copy of every record it
    passes on, for the read-back check."""

    def __init__(self, writer):
        self.writer = writer
        self.kept = []

    def write(self, rec):
        host = {k: v.cpu().numpy() for k, v in rec.items()}
        self.kept.append(host)
        return self.writer.write(host)

    def flush(self):
        self.writer.flush()


def run_offline(dev, card, gen):
    """Phase 21: the offline-data loop. record_dataset on MT10 at N = 10240
    for REC_STEPS steps into a temporary directory (deleted after), read
    back with the port's reader, every record equal to what was written
    and none dropped; then train_bc at its defaults on drawer-open-v3
    (record, fit, closed-loop eval), its eval loop again with no host sync
    and one launch per step. Returns the layouts' `kernels` records."""
    import shutil
    import tempfile

    from metaworld_tpu_torch import benchmarks, record_dataset, train_bc
    from metaworld_tpu_torch.evaluation import ScriptedAgent
    from metaworld_tpu_torch.native import TrajectoryReader, TrajectoryWriter
    from metaworld_tpu_torch.physics import cuda_step

    t_phase = time.time()
    envs = record_dataset.make_envs(benchmarks.MT10_LIST, REC_PER_TASK, dev)
    agent = ScriptedAgent(envs)
    tmp = tempfile.mkdtemp(prefix="mw_record_")
    try:
        path = f"{tmp}/mt10.ts"
        with TrajectoryWriter(path) as w:
            keep = KeepWriter(w)
            state, obs = envs.reset(seed=0)  # warm-up: the per-device caches
            envs.step(state, agent.eval_action(obs))
            torch.cuda.synchronize()
            cuda_step.reset_counts()
            t0 = time.time()
            record_dataset.record(envs, agent, keep, 1, REC_STEPS)
            wall = time.time() - t0
            stats = w.stats()
        rec_launches = list(cuda_step.launches_by_variant)
        total = cuda_step.launches
        t0 = time.time()
        back = list(TrajectoryReader(path))
        read_s = time.time() - t0
        differ = sum(
            not (a.keys() == b.keys() and all(
                a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a))
            for a, b in zip(keep.kept, back))
        size = sum(a[k].nbytes for a in keep.kept for k in a)
    finally:
        shutil.rmtree(tmp)
    n = envs.num_envs
    print(f"[record] {card}: record_dataset on MT10, {n} envs, {REC_STEPS} steps: "
          f"{stats}; {size / 1e6:.1f} MB of arrays in {wall:.2f} s wall, "
          f"{n * REC_STEPS / wall:.0f} env-steps/s incl. IO; launches {total}, by "
          f"variant {rec_launches}; read back {len(back)} records in {read_s:.2f} s, "
          f"records differing from what was written {differ}")
    if total != REC_STEPS or stats["pushed"] != REC_STEPS or stats["dropped"] != 0:
        fail(f"record: {total} launches, {stats} for {REC_STEPS} steps")
    if len(back) != REC_STEPS or differ:
        fail(f"record: {len(back)} records read back, {differ} differ")
    records = held_records(envs, dev, gen, f"mt10 record N={n}", rec_launches,
                           card, "mt10")
    del envs, agent, keep, back

    # train_bc at the script's defaults
    args = train_bc.parse_args(["--device", str(dev)])
    data = os.path.join(tempfile.gettempdir(), f"bc_{args.env}.ts")
    cuda_step.reset_counts()
    t0 = time.time()
    try:
        bc = train_bc.run(args)
    finally:
        if os.path.exists(data):
            os.remove(data)
    bc_wall = time.time() - t0
    bc_launches = cuda_step.launches
    losses = [float(x) for x in bc["losses"]]
    cuda_step.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = train_bc.evaluate(bc["policy"], bc["envs"], args.seed + 100)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    eval_launches = list(cuda_step.launches_by_variant)
    print(f"[bc] {card}: train_bc on {args.env}, {bc['envs'].num_envs} envs, "
          f"{args.epochs} epochs: loss first epoch {losses[0]:.5f}, last "
          f"{losses[-1]:.5f}; bc_success_rate {bc['success_rate']:.4f} (JAX "
          f"scripts/train_bc.py --cpu on a CPU: {JAX_CPU_BC_SUCCESS}); the eval "
          f"loop again with no host sync: {float(again):.4f}, launches "
          f"{cuda_step.launches}; run {bc_wall:.1f} s, {bc_launches} launches "
          f"(record + eval)")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"bc: loss not finite or not lower at the last epoch ({losses[0]}, "
             f"{losses[-1]})")
    episode = train_bc.EPISODE_STEPS
    if cuda_step.launches != episode or bc_launches != 2 * episode:
        fail(f"bc: {cuda_step.launches} launches in the eval loop, {bc_launches} "
             f"in the run")
    if float(again) != bc["success_rate"]:
        fail(f"bc: the eval loop's rerun gave {float(again)}, the run "
             f"{bc['success_rate']}")
    records += held_records(bc["envs"], dev, gen, f"mt1 {args.env} bc N=16",
                            eval_launches, card, "mt50")
    print(f"[offline] phase {time.time() - t_phase:.1f} s")
    return records


def ppo_update(model, opt, sched, envs, vstate, obs, pgen, args, tag):
    """One train_ppo update, checked: the rollout and GAE with no host sync
    and one launch per step, the learner timed apart, every statistic
    finite. Its stats hold `probe_loss`, the PPO loss on the update's
    whole batch before and after the learner, for `check_learner`.
    Returns (vstate, obs, stats, launches by variant)."""
    from metaworld_tpu_torch import train_ppo
    from metaworld_tpu_torch.physics import cuda_step

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    cuda_step.reset_counts()
    ev[0].record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        vstate, obs, traj, last = train_ppo.rollout(model, envs, vstate, obs,
                                                    args.rollout, pgen)
        adv, ret = train_ppo.gae(traj["reward"], traj["value"], traj["done"],
                                 last, args.gamma, args.lam)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ev[1].record()
    launches = list(cuda_step.launches_by_variant)
    if cuda_step.launches != args.rollout:
        fail(f"{tag}: {cuda_step.launches} launches for {args.rollout} rollout steps")
    probe = [x.reshape((-1,) + x.shape[2:])
             for x in (traj["obs"], traj["act"], traj["logp"], adv, ret)]
    with torch.no_grad():
        before = train_ppo.ppo_loss(model, probe, args.clip)
    ev[2].record()
    loss = train_ppo.learn(model, opt, sched, traj, adv, ret, args.epochs,
                           args.minibatches, args.clip, pgen)
    ev[3].record()
    with torch.no_grad():
        after = train_ppo.ppo_loss(model, probe, args.clip)
    torch.cuda.synchronize()
    stats = {"loss": float(loss), "mean_reward": float(traj["reward"].mean()),
             "success_rate": float(traj["success"].amax(0).mean()),
             "adv_finite": bool(torch.isfinite(adv).all()
                                and torch.isfinite(ret).all()),
             "rollout_ms": ev[0].elapsed_time(ev[1]),
             "learner_ms": ev[2].elapsed_time(ev[3]),
             "probe_loss": (float(before), float(after))}
    if not all(np.isfinite(v).all() for v in stats.values()):
        fail(f"{tag}: non-finite statistics {stats}")
    return vstate, obs, stats, launches


def check_learner(rows, tag):
    """The learner must lower its own objective: the PPO loss on each
    update's batch falls across the learner in all but a tenth of the
    updates (rounded down). A learner that does not update, or climbs its
    loss, fails; a sound one may rise now and then late in a run
    (reach-v3 at seed 0, the port with the plain physics on a CPU: in 1
    update of 40, and on one rollout step's slice of 64 rows in 5).
    Returns the updates where it rose."""
    rose = [i for i, r in enumerate(rows) if not r["probe_loss"][1] < r["probe_loss"][0]]
    if len(rose) > len(rows) // 10:
        fail(f"{tag}: the learner did not lower its loss on its own batch in "
             f"updates {rose} of {len(rows)}: "
             f"{[rows[i]['probe_loss'] for i in rose]}")
    return rose


def run_ppo(dev, card, gen):
    """Phase 22: train_ppo on MT10 at N = 131070 (rollout 16, 3 updates, 2
    epochs, 4 minibatches), then reach-v3 for 40 updates at the script's
    defaults, each update checked by `ppo_update`. Returns the layouts'
    `kernels` records."""
    from metaworld_tpu_torch import train_ppo

    t_phase = time.time()
    args = train_ppo.parse_args(PPO_ARGS + ["--device", str(dev)])
    envs, model, opt, sched, pgen = train_ppo.setup(args)
    n = envs.num_envs
    vstate, obs = envs.reset(seed=args.seed)
    launches = [0, 0, 0, 0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    t0 = time.time()
    for i in range(args.updates):
        vstate, obs, stats, step_launches = ppo_update(
            model, opt, sched, envs, vstate, obs, pgen, args, "ppo")
        launches = [a + b for a, b in zip(launches, step_launches)]
        rows.append(stats)
        print(f"[ppo] {card}: MT10, {n} envs, update {i}: rollout {args.rollout} "
              f"steps {stats['rollout_ms'] / args.rollout:.3f} ms per step "
              f"({args.rollout} launches, no host sync), learner "
              f"{stats['learner_ms']:.2f} ms ({args.epochs} epochs x "
              f"{args.minibatches} minibatches of "
              f"{n * args.rollout // args.minibatches}); {stats} (probe_loss: the "
              f"PPO loss on the update's batch before / after the learner)")
    wall = time.time() - t0
    check_learner(rows, "ppo")
    peak = torch.cuda.max_memory_allocated()
    print(f"[ppo] {card}: {args.updates} updates in {wall:.2f} s wall, "
          f"{n * args.rollout * args.updates / wall:.0f} env-steps/s with the "
          f"learner; peak memory {peak / 2**30:.2f} GiB")
    records = held_records(envs, dev, gen, f"mt10 ppo N={n}", launches, card, "mt10")
    del envs, model, opt, vstate, obs

    # reach-v3 at the script's defaults
    args = train_ppo.parse_args(REACH_PPO_ARGS + ["--device", str(dev)])
    envs, model, opt, sched, pgen = train_ppo.setup(args)
    vstate, obs = envs.reset(seed=args.seed)
    reach_launches = [0, 0, 0, 0]
    rows = []
    t0 = time.time()
    for i in range(args.updates):
        vstate, obs, stats, step_launches = ppo_update(
            model, opt, sched, envs, vstate, obs, pgen, args, f"ppo reach update {i}")
        reach_launches = [a + b for a, b in zip(reach_launches, step_launches)]
        rows.append(stats)
        if i % 10 == 0 or i == args.updates - 1:
            print(f"[ppo reach] update {i}: {stats}")
    wall = time.time() - t0
    rose = check_learner(rows, "ppo reach")
    first, last = rows[0], rows[-1]
    print(f"[ppo reach] {card}: reach-v3, {args.envs_per_task} envs, {args.updates} "
          f"updates in {wall:.1f} s ({args.updates * args.rollout} launches): the "
          f"loss on the update's batch fell across the learner in "
          f"{args.updates - len(rose)} of {args.updates} updates (rose in {rose}); "
          f"mean_reward first {first['mean_reward']:.4f}, last "
          f"{last['mean_reward']:.4f} (rose: "
          f"{last['mean_reward'] > first['mean_reward']}); success_rate "
          f"{last['success_rate']:.4f} (JAX scripts/train_ppo.py on a CPU: "
          f"{JAX_CPU_REACH_PPO})")
    records += held_records(envs, dev, gen, "mt1 reach-v3 ppo N=64",
                            reach_launches, card, "mt50")
    print(f"[ppo] phase {time.time() - t_phase:.1f} s")
    return records


def run_parity(dev, card, gen):
    """Phase 23: the 50 golden action tapes replayed open loop in one engine
    of 50 slots (500 steps, one launch each, no host sync); every task's
    deviation from the reference's recorded trace within the port's copy of
    the ceilings. Returns the layout's `kernels` records."""
    from metaworld_tpu_torch import trajectory_parity as tp
    from metaworld_tpu_torch.envs import registry
    from metaworld_tpu_torch.physics import cuda_step

    t_phase = time.time()
    names = registry.ALL_V3_ENVIRONMENTS
    traces = tp.load_traces(names)
    envs = tp.replay_engine(names, traces, dev)
    actions = torch.from_numpy(np.stack([d["action"] for d in traces], 1)
                               .astype(np.float32)).to(dev)
    tp.replay(envs, actions[:2])  # warm-up: the per-device caches
    torch.cuda.synchronize()
    cuda_step.reset_counts()
    t0 = time.time()
    torch.cuda.set_sync_debug_mode("error")
    try:
        replayed = tp.replay(envs, actions)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = list(cuda_step.launches_by_variant)
    total = cuda_step.launches
    over = {}
    for name, (ours, ref) in zip(names, tp.pairs(
            traces, *(x.cpu().numpy() for x in replayed))):
        sc = tp.score(name, ours, ref)
        bad = tp.over_ceiling(sc)
        if bad:
            over[name] = (bad, tp.first_fork(ours, ref))
        print(f"[parity] {name:30s} hand p95 {sc['hand_p95'] * 1000:7.1f} mm, obj "
              f"p95 {sc['obj_p95'] * 1000:7.1f} mm, rew mae {sc['rew_mae_rel']:.3f}, "
              f"succ ours/ref {sc['succ_ours']:.0f}/{sc['succ_ref']:.0f}"
              + (f"; OVER CEILING {bad}, first fork (1 mm) at step "
                 f"{over[name][1]}" if bad else ""))
    print(f"[parity] {card}: 50 golden tapes in one engine of {envs.num_envs} slots, "
          f"{actions.shape[0]} steps in {wall:.2f} s wall "
          f"({wall / actions.shape[0] * 1e3:.2f} ms per step, no host sync); "
          f"launches {total}, by variant {launches}; tasks over their ceilings "
          f"{len(over)}")
    if total != actions.shape[0]:
        fail(f"parity: {total} launches for {actions.shape[0]} steps")
    if over:
        fail(f"parity: tasks over their ceilings: {over}")
    records = held_records(envs, dev, gen, "mt50 parity N=50", launches, card, "mt50")
    print(f"[parity] phase {time.time() - t_phase:.1f} s")
    return records


def run_tools(dev, card, gen):
    """Phase 24: the host tools on the card. policy_testing on the four
    tasks whose MT1(name, seed=42) rates are below 1 on the JAX engines
    (the failed goal rows equal to the JAX script's on a CPU),
    scaling_bench on 1 and 2 shards of cuda:0, profile_memory on MT10 at
    13107 per task, and keyboard_control on piped keys. Returns
    policy_testing's `kernels` records."""
    import contextlib
    import io

    from metaworld_tpu_torch import (benchmarks, keyboard_control, policy_testing,
                                     profile_memory, scaling_bench, vector)
    from metaworld_tpu_torch.physics import cuda_step

    t_phase = time.time()
    records, wrong = [], {}
    for name, expect in JAX_CPU_POLICY_TESTING.items():
        cuda_step.reset_counts()
        t0 = time.time()
        succ = policy_testing.run_slots(name, n_goals=PT_GOALS, device=dev)
        wall = time.time() - t0
        got = int(succ.sum())
        failed = torch.nonzero(succ == 0).flatten().tolist()
        print(f"[policy_testing] {card}: {name}: {got}/{PT_GOALS} = "
              f"{got / PT_GOALS:.2f}, failed rows {failed} (JAX "
              f"scripts/policy_testing.py on a CPU: {PT_GOALS - len(expect)}/"
              f"{PT_GOALS}, failed rows {expect}); {wall:.1f} s, launches "
              f"{cuda_step.launches}")
        if failed != expect:
            wrong[name] = (failed, expect)
        if cuda_step.launches != 500:
            fail(f"policy_testing {name}: {cuda_step.launches} launches for 500 steps")
        envs = vector.from_benchmark(benchmarks.MT1(name, seed=42),
                                     envs_per_task=PT_GOALS, autoreset=False,
                                     task_select="pseudorandom", device=dev)
        records += held_records(envs, dev, gen, f"mt1 {name} policy_testing N=50",
                                list(cuda_step.launches_by_variant), card, "mt50")
    if wrong:
        fail(f"policy_testing: failed rows differ from the JAX script's: {wrong}")

    cuda_step.reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = scaling_bench.main(SCALING_ARGS + ["--device", str(dev)])
    print(f"[scaling_bench] {card}, one card (the shards repeat {dev}: mechanics "
          f"only): {rows}; launches {cuda_step.launches}")
    steps = int(SCALING_ARGS[SCALING_ARGS.index("--steps") + 1])
    if cuda_step.launches != 2 * steps * sum(r["devices"] for r in rows):
        fail(f"scaling_bench: {cuda_step.launches} launches")

    cuda_step.reset_counts()
    mem = profile_memory.profile("MT10", PIPE_PER_TASK, dev)
    print(f"[profile_memory] {card}: {mem}; launches {cuda_step.launches}")
    if cuda_step.launches != 1 or not mem["device_bytes_in_use"]:
        fail(f"profile_memory: {cuda_step.launches} launches, {mem}")

    stdin = sys.stdin
    sys.stdin = io.StringIO(KEYS_PIPED)
    buf = io.StringIO()
    cuda_step.reset_counts()
    try:
        with contextlib.redirect_stdout(buf):
            keyboard_control.main(["--device", str(dev)])
    finally:
        sys.stdin = stdin
    lines = [x for x in buf.getvalue().splitlines() if x.startswith("t=")]
    print(f"[keyboard_control] {card}: piped keys {KEYS_PIPED!r}: {len(lines)} "
          f"keypresses, launches {cuda_step.launches}; last line {lines[-1]!r}")
    presses = sum(ch != "x" for ch in KEYS_PIPED.split("x")[0])
    if len(lines) != presses or cuda_step.launches != 5 * presses:
        fail(f"keyboard_control: {len(lines)} lines, {cuda_step.launches} launches "
             f"for {presses} keypresses")
    print(f"[tools] phase {time.time() - t_phase:.1f} s")
    return records


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

    # ---- 4b. the main path: FUSED_STEPS fused steps at full width ----
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
    plain_ms = time_ms(lambda: cuda_step.plain_control_step(table, ids, sim, act),
                       **PLAIN_TIMING)
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

    # ---- 17. the per-env facade; 18. autograd ----
    kernels += run_facade(dev, card)
    run_autograd(dev, card)

    # ---- 19. the v1 reward family; 20. ShardedEnvs ----
    kernels += run_v1(dev, card, gen)
    kernels += run_sharded(dev, card, gen)

    # ---- 21. record -> BC; 22. PPO; 23. parity; 24. the host tools ----
    gen.manual_seed(21)
    kernels += run_offline(dev, card, gen)
    kernels += run_ppo(dev, card, gen)
    kernels += run_parity(dev, card, gen)
    kernels += run_tools(dev, card, gen)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
