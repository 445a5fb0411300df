"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, under ``build/repro_torch/`` at the repo
root, at first CUDA use. The library name carries a hash of the source, of
every header under ``csrc/`` (``*.cuh``, which the sources share) and of
the flags, so an edited source or header rebuilds and an unchanged one is
reused.
All sources compile in parallel (one ``nvcc`` each, started together).
The libraries are loaded with ``ctypes``; a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

SOURCES = ("buffer_agg", "flash_attention", "flash_attention_bwd",
           "grouped_matmul", "sens_sketch")
CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> loaded CDLL, and name -> {"seconds", "log", "cached"} of the build
# that produced it (a cached library's log is the one its build wrote beside
# it); process-wide, like the CUDA context the libraries use.
_LIBS: Dict[str, ctypes.CDLL] = {}
REPORT: Dict[str, dict] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home is None:
        from torch.utils.cpp_extension import CUDA_HOME
        home = CUDA_HOME
    cands = ([os.path.join(home, "bin", "nvcc")] if home else []) + \
        [shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "repro_torch are built from source at first use")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, dict]:
    """Compile every source that has no up-to-date library, all in
    parallel; raise with the compiler log on any failure. Returns
    ``REPORT``."""
    todo = [n for n in SOURCES if n not in REPORT]
    if not todo:
        return REPORT
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in todo:
        out = _target(name)
        if out.exists():
            log = out.with_suffix(".log")
            REPORT[name] = {"seconds": 0.0, "cached": True,
                            "log": log.read_text() if log.exists() else ""}
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc={proc.returncode}) ---\n{log}")
            continue
        out.with_suffix(".log").write_text(log)   # ptxas -v, for cached loads
        os.replace(tmp, out)
        REPORT[name] = {"seconds": secs, "log": log, "cached": False}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return REPORT


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (building all sources at the
    first call), with ``argtypes``/``restype`` declared for each C entry
    point in ``signatures`` (every entry point returns a cudaError_t)."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def as_f32(x, kernel: str, what: str):
    """A kernel input as contiguous float32: bfloat16 is cast (a fresh
    tensor), other dtypes and non-contiguous float32 raise."""
    import torch
    if x.dtype == torch.bfloat16:
        return x.float()
    if x.dtype != torch.float32:
        raise TypeError(f"{kernel}: {what} must be float32 or bfloat16, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: {what} must be contiguous")
    return x


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
