"""Builds the physics kernel library from `csrc/` at first use.

`build_cuda()` compiles `csrc/step_kernel.cu` once per substep variant with
`nvcc` for sm_90a (the four objects compile in parallel) and links them
into one shared library with a plain C interface, loaded with ctypes.
`build_host()` compiles `csrc/host_step.cpp` with g++: the same substep
arithmetic on the CPU, used only by the tests. Both write into
`metaworld_tpu_torch/_build/` (ignored by git), keyed by a hash of the
sources and flags, and raise if the compiler is missing or fails.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"

# --fmad=false: no multiply-add contraction, so the kernel rounds as its
# plain PyTorch version does (with contraction, the finite-difference
# velocity fields drifted 1.5e-4 from it on an H100)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O1", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
             "-Wall", "-Wdouble-promotion", "-Werror=double-promotion"]
VARIANTS = (0, 1, 2, 3)

# what `-Xptxas -v` printed for the last CUDA build in this process
ptxas_log = ""


def _key(sources, flags) -> str:
    h = hashlib.sha256()
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the physics kernel")
    return nvcc


def build_cuda() -> pathlib.Path:
    """Path of the kernel library, compiled now if not yet built."""
    global ptxas_log
    sources = [CSRC / "substep.cuh", CSRC / "step_kernel.cu"]
    lib = BUILD / f"libmw_step_{_key(sources, NVCC_FLAGS)}.so"
    log = lib.with_suffix(".ptxas.txt")
    if lib.exists():
        ptxas_log = log.read_text() if log.exists() else ""
        return lib
    nvcc = find_nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        procs = []
        for v in VARIANTS:
            obj = pathlib.Path(tmp) / f"step_v{v}.o"
            cmd = [nvcc, *NVCC_FLAGS, f"-DMW_VARIANT={v}", "-I", str(CSRC),
                   "-c", str(CSRC / "step_kernel.cu"), "-o", str(obj)]
            procs.append((v, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for v, obj, p in procs:
            out, _ = p.communicate()
            logs.append(f"# variant {v}\n{out}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed for variant {v}:\n{out}")
        tmp_lib = pathlib.Path(tmp) / lib.name
        res = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib),
             *[str(o) for _, o, _ in procs]],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        ptxas_log = "\n".join(logs)
        log.write_text(ptxas_log)
        os.replace(tmp_lib, lib)
    return lib


def build_host() -> pathlib.Path:
    """Path of the host (g++) build of the substep, compiled if needed."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    sources = [CSRC / "substep.cuh", CSRC / "host_step.cpp"]
    lib = BUILD / f"libmw_host_{_key(sources, GXX_FLAGS)}.so"
    if lib.exists():
        return lib
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        tmp_lib = pathlib.Path(tmp) / lib.name
        res = subprocess.run(
            [gxx, *GXX_FLAGS, "-I", str(CSRC), str(CSRC / "host_step.cpp"),
             "-o", str(tmp_lib)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp_lib, lib)
    return lib
