"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own into
``build/lib<name>-<hash>.so`` (the directory is git-ignored). The hash covers the
source, the headers it may include (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and a stale library is never loaded. :func:`build`
starts one ``nvcc`` per source, all at once, and waits for all of them. A failed
build raises with the compiler's output.

Nothing is compiled at import time: the first wrapper that launches a kernel calls
:func:`load`, which builds that source if its library is missing.
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
from typing import Dict, Iterable, Optional

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel name -> its ``.cu`` source."""
    return {p.stem: p for p in sorted(CSRC_DIR.glob("*.cu"))}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (default: all) in parallel.

    Returns ``{name: {"seconds": wall time, "library": path, "ptxas": [...]}}``;
    an up-to-date library is not rebuilt and reports 0 seconds.
    """
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    unknown = set(names) - set(srcs)
    if unknown:
        raise KeyError(f"no CUDA source for {sorted(unknown)} in {CSRC_DIR}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    report = {}
    t0 = time.perf_counter()
    for name in names:
        lib = _library_path(srcs[name])
        if lib.exists():
            report[name] = {"seconds": 0.0, "library": str(lib), "ptxas": []}
            continue
        nvcc = nvcc or nvcc_path()
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = {}
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed[name] = out
            continue
        os.replace(tmp, lib)
        report[name] = {
            "seconds": seconds, "library": str(lib),
            "ptxas": [ln.strip() for ln in out.splitlines()
                      if "registers" in ln or "spill" in ln],
        }
    if failed:
        msg = "\n".join(f"--- {n} ---\n{o}" for n, o in failed.items())
        raise RuntimeError(f"nvcc failed for {sorted(failed)}:\n{msg}")
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = _library_path(sources()[name])
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib


def function(name: str, symbol: str, argtypes):
    """``symbol`` of kernel library ``name`` (built first if needed), returning
    a C ``int`` and taking ``argtypes``."""
    fn = getattr(load(name), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn
