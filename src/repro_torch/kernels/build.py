"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles, on first use, into its own shared library
with a plain C interface under ``build/repro_torch/`` at the checkout's root
(a directory ``.gitignore`` lists); a library may export several launch
functions.  The file name carries a hash of the sources and flags, so an
edited kernel rebuilds and an unchanged one loads as it is.  All sources
build at once, one ``nvcc`` process each.

The flags never include ``--use_fast_math``: it approximates division and
flushes subnormals, which would break the DSBP exactness argument.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "LIBRARIES", "SIGNATURES", "build_all", "load",
           "plain_body", "in_plain_body"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# each kernel's launch function: name -> (library = csrc/<library>.cu,
# C symbol, argtypes)
SIGNATURES = {
    "dsbp_fused": ("dsbp_fused", "dsbp_fused_launch",
                   [P, P, P, P, P, P, I, I, I, I, I, I, F, I, F, I, I, P]),
    "flash_attention": ("flash_attention", "flash_attention_launch",
                        [P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, P]),
    "packed_flash_attention": ("flash_attention", "packed_flash_attention_launch",
                               [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, P]),
    "fp8_quant_align": ("fp8_quant_align", "fp8_quant_align_launch",
                        [P, P, P, P, I, I, I, I, I, F, I, F, I, I, P]),
    "dsbp_matmul": ("dsbp_matmul", "dsbp_matmul_launch",
                    [P, P, P, P, P, I, I, I, I, P]),
}
LIBRARIES = sorted({lib for lib, _, _ in SIGNATURES.values()})

_loaded: dict[str, ctypes._CFuncPtr] = {}
# depth of kernels' plain versions running in place of their kernels (CPU
# tensors): the dispatch counters of kernels/ops.py skip the ops inside
# them, as the JAX counters skip the bodies of Pallas kernels
_plain_depth = [0]
# nvcc's ptxas report (registers, shared memory, spills) of each library
# built in this process
reports: dict[str, str] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return nvcc


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # every .cu and shared .cuh
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every library that is not built yet, all in parallel;
    returns name -> library path.  Raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in LIBRARIES}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if todo:
        nvcc = _nvcc()
        procs = {}
        for name, p in todo.items():
            tmp = p.with_suffix(f".tmp{os.getpid()}")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp)
        failed = []
        for name, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            reports[name] = out
            if proc.returncode != 0:
                failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n{out}")
            else:
                os.replace(tmp, paths[name])
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


@contextlib.contextmanager
def plain_body():
    """Marks a wrapper's call of its kernel's plain version."""
    _plain_depth[0] += 1
    try:
        yield
    finally:
        _plain_depth[0] -= 1


def in_plain_body() -> bool:
    return _plain_depth[0] > 0


def load(name: str):
    """The launch function of kernel ``name``, building its library first
    if needed.  Every pointer and the stream pass as ``c_void_p``."""
    fn = _loaded.get(name)
    if fn is None:
        lib, sym, argtypes = SIGNATURES[name]
        path = build_all()[lib]
        fn = getattr(ctypes.CDLL(str(path)), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn
