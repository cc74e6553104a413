"""Drives the PyTorch port's main path on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases, each printing its numbers on its own line; any failure exits
non-zero before the result line:

  1. the card: name and power limit (nvidia-smi), torch's device name;
  2. build of the physics kernel from metaworld_tpu_torch/csrc with nvcc
     (one translation unit), printing its build time, what `-Xptxas -v`
     reports, and the kernel's registers and local (stack and spill) bytes
     per thread, its shared memory per block and the blocks an SM holds at
     once;
  3. kernel vs its plain PyTorch version on MT10 scenes at N = 131072 laid
     out as bench.py lays them out: 5 control steps, each from the plain
     version's state, max abs error per state field <= 1e-4; one launch
     per control step, and blocks of every variant v0..v3 run;
  4. the fused MT10 step (metaworld_tpu_torch.vector.FusedBatchedEnvs) at
     N = 131072 for 520 steps, so every slot crosses autoreset at
     max_episode_steps=500: finite outputs, episode lengths wrap to 1, the
     kernel launched exactly once per step with blocks of every variant, no
     host synchronisation inside the step loop
     (torch.cuda.set_sync_debug_mode("error")); and on a small batch, the
     fused step with the kernel against the fused step with the plain
     physics;
  5. timings with CUDA events: kernel ms per control step as one launch
     and, in turns with it, as the same kernel launched once per
     same-variant run (the earlier seven-launch schedule); each variant's
     blocks as one launch; plain-version ms, fused step ms and
     env-steps/s, each beside the card and its power limit, with the
     kernel's bound and roofline share.

The line before the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}. The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_ENVS = 131072
FUSED_STEPS = 520
MAX_EPISODE_STEPS = 500
PHYS_STEPS = 5
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
# H100 SXM lane operations per second: 132 SMs x 128 float32 lanes x
# 1.98 GHz. The published 67 TFLOP/s counts a fused multiply-add as two
# operations; the kernel is built with --fmad=false, so it issues none and
# each of its operations takes one lane slot.
F32_OPS_PER_S = 33.5e12
TPU_KERNEL = "metaworld_tpu/physics/pallas_step.py:281"  # _make_kernel


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


def bench_engine(device, n_envs, **kw):
    from metaworld_tpu_torch import benchmarks, vector

    bench = benchmarks.MT10(seed=0)
    names = list(bench.train_classes.keys())
    base, rem = divmod(n_envs, len(names))
    counts = [base + (1 if i < rem else 0) for i in range(len(names))]
    return vector.FusedBatchedEnvs(
        [bench.train_classes[n] for n in names], counts,
        [bench.goal_table(n) for n in names], goal_visible=True, one_hot=True,
        device=device, **kw)


def ops_per_env_substep(variant: int) -> int:
    """Elementwise float operations one env's substep performs in the plain
    version with this variant's features (each lane op counts once), counted
    on the CPU with a dispatch hook over a one-env batch of each sound task."""
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

    eng = bench_engine("cpu", 10, physics="torch")
    flags = cuda_step.VARIANTS[variant]
    feats = eng.scene_table.features
    want = [i for i in range(10)
            if (flags["with_objects"] or not feats[i, 0])
            and (flags["with_joints"] or not feats[i, 1])
            and (flags["with_hand_boxes"] or not feats[i, 2])]
    state, _ = eng.reset()
    total = 0
    for i in want:
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
        total = max(total, Count.n)
    return total


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from metaworld_tpu_torch.physics import _build, cuda_step
    from metaworld_tpu_torch import vector

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

    # ---- 3. kernel vs plain at full width ----
    eng = bench_engine(dev, N_ENVS, max_episode_steps=MAX_EPISODE_STEPS)
    blocks, runs = eng.block_table, eng.variant_runs
    info = cuda_step.kernel_info()
    print(f"[kernel] {card}: {info['regs']} registers and {info['local_bytes']} B "
          f"local memory per thread; {info['shared_bytes']} B shared memory per "
          f"block; {info['blocks_per_sm']} blocks per SM")
    print(f"[blocks] one launch of {blocks.host.shape[0]} blocks, by variant "
          f"{blocks.blocks_by_variant} (heaviest first); earlier schedule: "
          f"{len(runs)} launches " + ", ".join(f"v{v}@{s}+{c}" for v, s, c in runs))
    env_variant = np.empty(N_ENVS, np.int64)
    for v, first, count, _, _ in blocks.host:
        env_variant[first:first + count] = v
    env_variant = torch.from_numpy(env_variant).to(dev)
    table, ids = eng.scene_table, eng.task_ids
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    state, _ = eng.reset()
    sim = state.env.sim
    cuda_step.reset_counts()
    err_by_variant = [0.0] * 4
    for t in range(PHYS_STEPS):
        act = torch.rand(N_ENVS, 4, generator=gen, device=dev) * 2 - 1
        got = cuda_step.control_step(table, ids, sim, act, blocks)
        ref = cuda_step.plain_control_step(table, ids, sim, act)
        torch.cuda.synchronize()
        worst, field = 0.0, None
        for f in ref.__dataclass_fields__:
            d = (getattr(got, f) - getattr(ref, f)).abs().reshape(N_ENVS, -1)
            d = torch.nan_to_num(d, nan=float("inf")).amax(dim=1)
            for v in range(4):
                err_by_variant[v] = max(err_by_variant[v],
                                        d[env_variant == v].max().item())
            e = d.max().item()
            if e > worst:
                worst, field = e, f
        print(f"[kernel-vs-plain] step {t}: max abs err {worst:.3e} ({field})")
        if not worst <= 1e-4:
            fail(f"kernel disagrees with its plain version: {field} {worst:.3e}")
        sim = ref
    if cuda_step.launches != PHYS_STEPS or min(cuda_step.blocks_by_variant) == 0:
        fail(f"expected {PHYS_STEPS} launches running every variant, got "
             f"{cuda_step.launches}, blocks by variant {cuda_step.blocks_by_variant}")
    print(f"[kernel-vs-plain] {cuda_step.launches} launches; blocks by variant "
          f"{cuda_step.blocks_by_variant}; max err by variant "
          f"{['%.3e' % e for e in err_by_variant]}")

    # ---- 4a. the fused step, kernel vs plain physics, small batch ----
    small_k = bench_engine(dev, 60, max_episode_steps=4, task_select="pseudorandom")
    small_p = bench_engine(dev, 60, max_episode_steps=4, task_select="pseudorandom",
                           physics="torch")
    goal_idx = torch.arange(60, device=dev, dtype=torch.int32) % 50
    sk, _ = small_k.reset(goal_idx)
    worst = {}
    for t in range(12):
        act = torch.rand(60, 4, generator=gen, device=dev) * 2 - 1
        nk, ok = small_k.step(sk, act)
        _, op = small_p.step(sk, act)
        for k in vector.OUT_KEYS:
            a, b = ok[k].double(), op[k].double()
            worst[k] = max(worst.get(k, 0.0), ((a - b).abs() / (1.0 + b.abs())).max().item())
        sk = nk
    bad = {k: v for k, v in worst.items() if not v <= 1e-4}
    print(f"[fused-small] kernel vs plain physics, 12 steps x 60 envs: worst "
          f"{max(worst.values()):.3e}")
    if bad:
        fail(f"fused step with the kernel disagrees with the plain physics: {bad}")

    # ---- 4b. the main path: 520 fused steps at full width ----
    state, obs = eng.reset()
    if tuple(obs.shape) != (N_ENVS, 49):
        fail(f"reset obs shape {tuple(obs.shape)}")
    gen.manual_seed(2)
    for _ in range(2):  # warm-up (first calls fill the per-device caches)
        eng.step(state, torch.rand(N_ENVS, 4, generator=gen, device=dev) * 2 - 1)
    torch.cuda.synchronize()
    state, _ = eng.reset()
    acts = [torch.rand(N_ENVS, 4, generator=gen, device=dev) * 2 - 1 for _ in range(8)]
    finite = torch.ones((), dtype=torch.bool, device=dev)
    wrapped = torch.zeros((), dtype=torch.bool, device=dev)
    dones = torch.zeros((), dtype=torch.int64, device=dev)
    prev_done = torch.zeros(N_ENVS, dtype=torch.bool, device=dev)
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
            finite = finite & ~(prev_done & (out["episode_length"] != 1)).any()
            dones = dones + out["done"].sum()
            prev_done = out["done"]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.time() - t0
    main_launches = list(cuda_step.launches_by_variant)
    main_blocks = list(cuda_step.blocks_by_variant)
    print(f"[fused] {FUSED_STEPS} steps x {N_ENVS} envs in {wall:.2f} s wall; "
          f"dones {int(dones)}; launches {cuda_step.launches}, running each "
          f"variant {main_launches}; blocks by variant {main_blocks}")
    if not bool(finite):
        fail("non-finite outputs, or an episode length that did not wrap to 1")
    if not bool(wrapped) or int(dones) < N_ENVS:
        fail(f"autoreset not crossed by every slot (dones {int(dones)})")
    if cuda_step.launches != FUSED_STEPS or main_launches != [FUSED_STEPS] * 4:
        fail(f"kernel launches {cuda_step.launches} {main_launches}: expected "
             f"one per step, each running blocks of every variant")
    if main_blocks != [FUSED_STEPS * c for c in blocks.blocks_by_variant]:
        fail(f"blocks by variant {main_blocks} != {FUSED_STEPS} x "
             f"{blocks.blocks_by_variant}")
    if tuple(out["obs"].shape) != (N_ENVS, 49):
        fail(f"obs shape {tuple(out['obs'].shape)}")

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

    ops = {v: ops_per_env_substep(v) for v in range(4)}
    n_by_v = [int(blocks.host[blocks.host[:, 0] == v, 2].sum()) for v in range(4)]
    bytes_per_env = (2 * cuda_step.SIM_ROWS + 4) * 4 + 4
    total_ops = sum(ops[v] * 5 * n_by_v[v] for v in range(4))
    bound_bytes_ms = (N_ENVS * bytes_per_env + table.rows.numel() * 4) / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = total_ops / F32_OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    print(f"[ops] elementwise ops per env per substep by variant {ops}; "
          f"bytes per env per control step {bytes_per_env}")
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

    kernels = []
    for v in range(4):
        vblocks = blocks.select(blocks.host[:, 0] == v)
        n_v = n_by_v[v]
        k_ms = time_ms(lambda: cuda_step.launch_rows(table.rows, ids, rows, ctl, vblocks), 50)
        idx = torch.nonzero(env_variant == v).flatten()
        sim_v = sim.map(lambda t: t[idx])
        p_ms = time_ms(lambda: cuda_step.plain_control_step(
            table, ids[idx], sim_v, act[idx]), 3, 1)
        b_bytes = (n_v * bytes_per_env + table.rows.numel() * 4) / HBM_BYTES_PER_S * 1e3
        b_ops = ops[v] * 5 * n_v / F32_OPS_PER_S * 1e3
        kernels.append({
            "name": f"step_kernel_v{v}", "route": "cuda",
            "source": "metaworld_tpu_torch/csrc/step_kernel.cu",
            "replaces": TPU_KERNEL, "launches": main_launches[v],
            "max_abs_err": err_by_variant[v], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(b_bytes, b_ops),
            "bound_by": "operations" if b_ops >= b_bytes else "bytes",
            "library_ms": None,
        })
        print(f"[kernel v{v}] {card}: {n_v} envs in {len(vblocks.host)} blocks, "
              f"one launch {k_ms:.4f} ms, plain {p_ms:.2f} ms, bound "
              f"{max(b_bytes, b_ops) * 1e3:.2f} us")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
