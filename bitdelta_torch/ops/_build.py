"""Build and load the hand-written CUDA kernels.

Each ``bitdelta_torch/csrc/<name>.cu`` has a plain C interface and is
compiled by ``nvcc`` for Hopper (``sm_90a``) into its own shared library
under ``bitdelta_torch/build/`` (git-ignored) at first use, then loaded
with ``ctypes``. The library's file name carries a hash of its source and
of the shared headers (``csrc/*.cuh``), so an edited source or header
rebuilds and a stale library is never loaded.

Every C entry point takes pointers and the stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; :func:`launch` raises on
a non-zero code, so a refused launch never passes silently.
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

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[1] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
KERNEL_SOURCES = ("binary_gemm", "flash_decode", "flash_prefill", "int4_gemm")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH)")
    return str(path)


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # sources include these
        digest.update(header.read_bytes())
    return BUILD / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> list:
    return [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, float]:
    """Compile every missing library at once (one ``nvcc`` per source,
    all started together). Returns the wall seconds per source; raises
    with the compiler's output if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    seconds = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built first if needed)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _target(name).exists():
                build_all([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def launch(lib_name: str, fn_name: str, argtypes, *args) -> None:
    """Call C entry ``fn_name`` of library ``lib_name`` (pointers as
    ``P``, ints as ``I``, floats as ``F`` in ``argtypes``; the stream is
    the last argument) and raise if it reports a CUDA error."""
    lib = library(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:                    # declare once per entry
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    code = fn(*args)
    if code != 0:
        lib.bd_error_string.restype = ctypes.c_char_p
        lib.bd_error_string.argtypes = [ctypes.c_int]
        name = lib.bd_error_string(code).decode()
        raise RuntimeError(f"CUDA launch of {fn_name} failed: {name} "
                           f"(error {code})")


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (a copy of a view
    that starts mid-vector), for kernels that read it in 16-byte loads."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
