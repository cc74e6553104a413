"""The native trajectory store: an asynchronous rollout sink in C++.

Counterpart of `metaworld_tpu/native`. `TrajectoryWriter` pushes one
record (a dict of arrays) at a time into a native ring buffer whose
background thread writes framed records to disk, so the step loop never
waits on the disk; `TrajectoryReader` replays the records. The port keeps
its own copy of the C++ (`trajstore.cpp`), built with g++ at first use into
`metaworld_tpu_torch/_build/`, keyed by a hash of the source. The framing
on disk and `_pack` / `_unpack` are the JAX package's byte for byte, so
each package reads the other's files.

`TrajectoryWriter.write` takes tensors on any device, or arrays, and
copies them to the host: for a CUDA tensor that copy waits for the device.
It belongs in the caller's loop, never inside the engine's step.
"""

from __future__ import annotations

import ctypes
import functools
import io
import pathlib
import struct

import numpy as np
import torch

from metaworld_tpu_torch.physics import _build

SOURCE = pathlib.Path(__file__).resolve().parent / "trajstore.cpp"
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_MAGIC = 0x4D57545053544F52  # "MWTPSTOR"


@functools.cache
def _load():
    lib = ctypes.CDLL(str(_build.build_gxx("libmw_trajstore", [SOURCE], SOURCE,
                                           GXX_FLAGS)))
    lib.ts_create.restype = ctypes.c_void_p
    lib.ts_create.argtypes = [ctypes.c_uint64, ctypes.c_char_p]
    lib.ts_push.restype = ctypes.c_int
    lib.ts_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.ts_flush.restype = None
    lib.ts_flush.argtypes = [ctypes.c_void_p]
    lib.ts_stats.restype = None
    lib.ts_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
    lib.ts_close.restype = None
    lib.ts_close.argtypes = [ctypes.c_void_p]
    return lib


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _pack(arrays: dict) -> bytes:
    """npz-lite framing: [n][per entry: name, dtype, shape, raw bytes]."""
    out = io.BytesIO()
    out.write(struct.pack("<I", len(arrays)))
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(_host(arr))
        nb = name.encode()
        dt = arr.dtype.str.encode()
        out.write(struct.pack("<I", len(nb)))
        out.write(nb)
        out.write(struct.pack("<I", len(dt)))
        out.write(dt)
        out.write(struct.pack("<I", arr.ndim))
        out.write(struct.pack(f"<{arr.ndim}q", *arr.shape))
        out.write(arr.tobytes())
    return out.getvalue()


def _unpack(data: bytes) -> dict[str, np.ndarray]:
    buf = io.BytesIO(data)
    (n,) = struct.unpack("<I", buf.read(4))
    out = {}
    for _ in range(n):
        (ln,) = struct.unpack("<I", buf.read(4))
        name = buf.read(ln).decode()
        (ld,) = struct.unpack("<I", buf.read(4))
        dtype = np.dtype(buf.read(ld).decode())
        (nd,) = struct.unpack("<I", buf.read(4))
        shape = struct.unpack(f"<{nd}q", buf.read(8 * nd))
        count = int(np.prod(shape)) if nd else 1
        arr = np.frombuffer(buf.read(count * dtype.itemsize), dtype=dtype)
        out[name] = arr.reshape(shape)
    return out


class TrajectoryWriter:
    """Async rollout sink backed by the native ring buffer of
    `capacity_mb` MiB; a record that does not fit the free space is
    dropped and counted."""

    def __init__(self, path, capacity_mb: int = 256):
        self._lib = _load()
        self._h = self._lib.ts_create(capacity_mb * 1024 * 1024,
                                      str(path).encode())
        if not self._h:
            raise OSError(f"cannot open {path} for writing")

    def write(self, arrays: dict) -> bool:
        """Queue one record (tensors on any device, or arrays); returns
        False if the ring was full and the record was dropped."""
        blob = _pack(arrays)
        return self._lib.ts_push(self._h, blob, len(blob)) == 0

    def flush(self):
        """Block until every queued record is on disk."""
        self._lib.ts_flush(self._h)

    def stats(self) -> dict[str, int]:
        out = (ctypes.c_uint64 * 3)()
        self._lib.ts_stats(self._h, out)
        return {"pushed": out[0], "dropped": out[1], "bytes_written": out[2]}

    def close(self):
        """Write what is queued, close the file and free the ring."""
        if self._h:
            self._lib.ts_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TrajectoryReader:
    """Iterates the records of a file written by either package's
    TrajectoryWriter, as dicts of numpy arrays."""

    def __init__(self, path):
        self.path = path

    def __iter__(self):
        with open(self.path, "rb") as f:
            while True:
                hdr = f.read(16)
                if len(hdr) < 16:
                    return
                magic, nbytes = struct.unpack("<QQ", hdr)
                if magic != _MAGIC:
                    raise ValueError(f"{self.path}: corrupt record header")
                yield _unpack(f.read(nbytes))
