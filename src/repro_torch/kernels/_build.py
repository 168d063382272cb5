"""Build and load the hand-written CUDA kernels of ``kernels/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<hash>.so`` (the hash is of
the source, every ``csrc/*.cuh`` header and the flags, so an edited kernel
or header rebuilds), then loaded with ``ctypes``.  The
build happens at the first launch, never at import: a machine without
``nvcc`` imports the package and runs the plain versions on CPU tensors.

``build(names)`` starts one ``nvcc`` per missing library, all at once, and
waits for them; ``load(name)`` builds one if needed and returns the
``ctypes.CDLL``.  ``build_seconds`` and ``build_log`` keep each build's wall
time and the compiler's ``-Xptxas -v`` report (registers, shared memory,
spills).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# --split-compile=0: the device code's optimization passes run in
# parallel on every core (flash_attention.cu holds 32 instantiations)
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v", "--split-compile=0")

build_seconds: Dict[str, float] = {}
build_log: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str]) -> None:
    """Compile every library in ``names`` that is not built yet, with one
    ``nvcc`` process per source, all running at once."""
    with _LOCK:
        pending = {}
        for name in names:
            so = _target(name)
            if name in _LIBS or so.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            pending[name] = (proc, tmp, so, time.perf_counter())
        failed = []
        for name, (proc, tmp, so, t0) in pending.items():
            out, _ = proc.communicate()
            build_seconds[name] = time.perf_counter() - t0
            build_log[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
                continue
            os.replace(tmp, so)        # atomic: concurrent builders agree
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build([name])
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
        return lib
