"""Scratch builds of the physics kernel, timed on the card beside the
shipped build.

    python -m metaworld_tpu_torch.kernel_sweep [--min-blocks 2,3,4] [--fmad]
        [--csrc NAME=DIR ...] [--envs 131072] [--reps 50] [--rounds 3]

Builds `csrc/step_kernel.cu` once with `__launch_bounds__(128, B)` for each
B (`-DMW_MIN_BLOCKS=B`); with `--fmad`, once more at the shipped B with
multiply-add contraction allowed (`--fmad=true`); and, for each `--csrc`,
the kernel of another copy of the sources (an earlier design) with the
shipped flags. All builds go into `metaworld_tpu_torch/_build/sweep/`, all
nvcc processes at once; the shipped build is not changed. On bench.py's
MT10 layout at `--envs` it then prints, for the shipped build and each
scratch build: registers and local (stack and spill) bytes per thread,
shared memory and blocks per SM, SASS instructions and local loads/stores (cuobjdump), the
one-launch control step time (CUDA events; every build timed in turns,
forward then backward, `--rounds` times; the median and the range), and
the max abs error against the plain version over 5 control steps, each
from the plain version's state. Every line carries the card's name and
power limit; a JSON line comes last. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import pathlib
import re
import shutil
import statistics
import subprocess

import torch

from metaworld_tpu_torch.physics import _build, cuda_step
from metaworld_tpu_torch.profile_step import _card, _time_ms, bench_engine


def _sass_counts(lib) -> dict:
    """SASS instructions of the library, and its local loads and stores."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=300).stdout
    except FileNotFoundError:
        return {}
    return {"sass_instructions": len(re.findall(r"/\*[0-9a-f]{4,}\*/", sass)),
            "sass_ldl": len(re.findall(r"\bLDL\b", sass)),
            "sass_stl": len(re.findall(r"\bSTL\b", sass))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--min-blocks", default="2,3,4")
    ap.add_argument("--fmad", action="store_true")
    ap.add_argument("--envs", type=int, default=131072)
    ap.add_argument("--csrc", action="append", default=[])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    card = _card()

    builds = {f"B={b}": ([*_build.NVCC_FLAGS, f"-DMW_MIN_BLOCKS={b}"], _build.CSRC)
              for b in args.min_blocks.split(",") if b}
    if args.fmad:
        builds["fmad"] = ([f.replace("--fmad=false", "--fmad=true")
                           for f in _build.NVCC_FLAGS], _build.CSRC)
    for spec in args.csrc:
        name, path = spec.split("=", 1)
        builds[name] = (_build.NVCC_FLAGS, pathlib.Path(path).resolve())
    out_dir = _build.BUILD / "sweep"
    paths = {name: out_dir / f"libmw_step_{name.replace('=', '')}.so"
             for name in builds}
    with concurrent.futures.ThreadPoolExecutor(len(builds) + 1) as pool:
        shipped = pool.submit(_build.build_cuda)
        jobs = {name: pool.submit(_build.compile_cuda, paths[name], f, src)
                for name, (f, src) in builds.items()}
        paths = {"shipped": shipped.result(), **paths}
        logs = {"shipped": _build.ptxas_log}
        logs.update((name, job.result()) for name, job in jobs.items())
    libs = {name: cuda_step.bind(ctypes.CDLL(str(p))) for name, p in paths.items()}

    eng = bench_engine(dev, args.envs)
    table, ids, blocks = eng.scene_table, eng.task_ids, eng.block_table
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    state, _ = eng.reset()
    sim = state.env.sim
    err = dict.fromkeys(libs, 0.0)
    for _ in range(5):
        act = torch.rand(eng.num_envs, 4, generator=gen, device=dev) * 2 - 1
        mocap, target, effort = cuda_step._sim_and_ctl(table, ids, sim, act)
        ctl = torch.cat([target.T, effort[None]]).contiguous()
        rows = cuda_step.pack_sim_rows(sim).contiguous()
        sim = cuda_step.plain_control_step(table, ids, sim, act)
        ref = cuda_step.pack_sim_rows(sim)
        for name, lib in libs.items():
            got = cuda_step.launch_rows(table.rows, ids, rows, ctl, blocks, lib=lib)
            d = torch.nan_to_num((got - ref).abs(), nan=float("inf")).max().item()
            err[name] = max(err[name], d)

    turns = {name: [] for name in libs}
    for _ in range(args.rounds):
        for name in list(libs) + list(libs)[::-1]:
            turns[name].append(_time_ms(lambda: cuda_step.launch_rows(
                table.rows, ids, rows, ctl, blocks, lib=libs[name]), args.reps))
    ms = {name: statistics.median(t) for name, t in turns.items()}

    results = {}
    for name, lib in libs.items():
        info = cuda_step.kernel_info(lib=lib)
        ptxas = " | ".join(ln.strip() for ln in logs[name].splitlines()
                           if "registers" in ln or "spill" in ln)
        sass = _sass_counts(paths[name])
        results[name] = dict(info, **sass, ms=ms[name], ms_turns=turns[name],
                             max_abs_err=err[name], ptxas=ptxas)
        print(f"[sweep] {card}: {name}: {ms[name]:.4f} ms per control step "
              f"(one launch, N={eng.num_envs}; median of {len(turns[name])}, "
              f"range {min(turns[name]):.4f}-{max(turns[name]):.4f}); "
              f"{info['regs']} registers, {info['local_bytes']} B local per "
              f"thread; {info['shared_bytes']} B shared per block; "
              f"{info['blocks_per_sm']} blocks per SM; SASS {sass}; max abs err vs "
              f"plain {err[name]:.3e}; ptxas: {ptxas}")
    print(json.dumps({"card": card, "envs": eng.num_envs, "builds": results}))


if __name__ == "__main__":
    main()
