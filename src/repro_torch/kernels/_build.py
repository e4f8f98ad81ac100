"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source in ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface.  All sources that are not
built yet are compiled together, one ``nvcc`` process each, so the build
takes as long as the slowest file.  A library's file name carries a hash
of its source and flags, so an edited source is rebuilt and a stale
library is never loaded.  The build directory is ``build/kernels`` at the
root of the checkout (listed in ``.gitignore``).

A failed build raises with nvcc's standard error.  Nothing here runs when
the package is imported: the first kernel launch triggers the build.
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
from typing import Callable, Dict, NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# one shared library per source; the key is the kernel module's name
SOURCES = {"similarity": "similarity.cu", "masked_agg": "masked_agg.cu",
           "robust_agg": "robust_agg.cu", "dequant_fold": "dequant_fold.cu",
           "flash_attention": "flash_attention.cu",
           "flash_attention_bf16": "flash_attention_bf16.cu",
           "mamba_scan": "mamba_scan.cu", "phase_mark": "phase_mark.cu",
           "client_step": "client_step.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Built(NamedTuple):
    path: Path
    seconds: float      # 0.0 when the library was already on disk
    log: str            # nvcc's standard error (ptxas register report)


_LOCK = threading.Lock()
_BUILT: Dict[str, Built] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[str, Callable[..., int]] = {}


def nvcc_path() -> str:
    """The nvcc to build with: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``, else the toolkit's default location.  Raises if none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from src/repro_torch/kernels/csrc at first "
        "use")


def _target(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all() -> Dict[str, Built]:
    """Build every kernel library that is not on disk yet, one nvcc per
    source, all started together.  Returns ``{name: Built}``."""
    with _LOCK:
        todo = {}
        for name in SOURCES:
            if name in _BUILT:
                continue
            path = _target(name)
            if path.exists():
                log_path = path.with_suffix(".log")
                log = log_path.read_text() if log_path.exists() else ""
                _BUILT[name] = Built(path, 0.0, log)
            else:
                todo[name] = path
        if not todo:
            return dict(_BUILT)
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for name, path in todo.items():
            tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        failures = []
        for name, (tmp, proc) in procs.items():
            out, err = proc.communicate()
            log = out + err
            if proc.returncode != 0:
                failures.append(f"--- {SOURCES[name]} (exit {proc.returncode})"
                                f"\n{log}")
                tmp.unlink(missing_ok=True)
                continue
            path = todo[name]
            os.replace(tmp, path)      # atomic: a reader never sees half a file
            path.with_suffix(".log").write_text(log)
            _BUILT[name] = Built(path, time.perf_counter() - t0, log)
        if failures:
            raise RuntimeError("nvcc failed to build the port's CUDA "
                               "kernels:\n" + "\n".join(failures))
        return dict(_BUILT)


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library for kernel module ``name``, building the
    kernels first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        built = build_all()[name]
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(built.path))
                _LIBS[name] = lib
    return lib


def entry_point(name: str, symbol: str, argtypes) -> Callable[..., int]:
    """C function ``symbol`` of library ``name``, returning an int CUDA
    error code, with its argument types declared (once)."""
    fn = _FUNCS.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _FUNCS[symbol] = fn
    return fn


def check(name: str, code: int) -> None:
    """Raise if an entry point of library ``name`` returned a CUDA error."""
    if code != 0:
        err = getattr(load(name), f"{name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({err(code).decode()})")
