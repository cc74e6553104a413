"""Device helpers of the port: the key of its per-device caches, the card's
name and power limit, CUDA-event timing and the no-host-sync check.

`device_key` is the one key that the per-device caches (`TaskSpec.consts`,
`envs.core.step_tables`, the reach-envelope tables of `engine_lanes`) file
their tensors under. An engine made with `device="cuda"` fills them at
construction, and its step looks them up by a tensor's device, `cuda:0`:
both must name the same entry, or the first step copies the constants to
the card again, and a copy from pageable host memory synchronises.
"""

from __future__ import annotations

import contextlib
import subprocess

import torch


def device_key(device) -> str:
    """`device` (a string, a `torch.device` or a tensor's `.device`) named
    as a tensor made on it reports it, as a string: a CUDA device with no
    index is the current one ("cuda:0"), and the CPU has no index ("cpu")."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def card() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them for the first card ("unknown" when nvidia-smi fails)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "unknown"


def time_ms(fn, reps, warmup=2) -> float:
    """Mean ms of `fn()` on the card over `reps` calls after `warmup` calls,
    from CUDA events around the calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def no_host_sync(device="cuda", mode="error"):
    """Inside the block, a host synchronisation raises (`mode="error"`) or
    warns (`mode="warn"`). On the CPU there is no device to wait for and
    nothing to check."""
    if torch.device(device).type != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)
