"""The key of the reference's per-device caches (a copy of
`device_key` alone from the port's `devices.py`)."""

from __future__ import annotations

import torch


def device_key(device) -> str:
    """`device` named as a tensor made on it reports it: a CUDA device with
    no index is the current one ("cuda:0"), and the CPU is "cpu"."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)
