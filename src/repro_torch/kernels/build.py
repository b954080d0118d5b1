"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` (with the shared ``csrc/*.cuh`` headers) exposes
a plain C launch function and is compiled on first use by ``nvcc`` for
``sm_90a`` into its own shared library, loaded with :mod:`ctypes` (no
PyTorch headers: a build takes seconds).  :func:`build` starts one
``nvcc`` per source, all at once, and waits for them.  Libraries land in
``build/repro_torch/`` at the repository root (listed in ``.gitignore``),
named by a digest of their sources, so an edited kernel is rebuilt and a
stale library is never loaded.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: every kernel source of the port, by library name
KERNELS = ("stream_matmul", "stream_attention")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> pathlib.Path:
    """Where kernel ``name``'s library is built: named by a digest of its
    source, the shared headers (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: tuple[str, ...] = KERNELS) -> dict[str, float]:
    """Compile the named kernels (one ``nvcc`` each, in parallel).

    Returns the wall seconds each build took (0.0 when the library was
    already built).  The ``ptxas -v`` report of each build is kept beside
    its library as ``<name>.ptxas.txt``.  Raises with the compiler's
    output when a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    times = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def ptxas_report(name: str) -> str:
    path = BUILD_DIR / f"{name}.ptxas.txt"
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib


def check_launch(name: str, rc: int) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
