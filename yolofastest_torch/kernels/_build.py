"""Build and load the port's CUDA kernels at first use.

Each ``csrc/*.cu`` file is one shared library with a plain C interface,
compiled by ``nvcc`` for Hopper (``sm_90a``) and loaded with :mod:`ctypes`.
Libraries go to ``build/kernels/<name>-<hash>.so`` under the repository root
(``build/`` is git-ignored); the hash covers the source and the flags, so an
edit rebuilds.  A library is written to a temporary name and renamed into
place, so two processes that build at once both end with a whole file.

Nothing here runs at import time: the CPU tests import every module, and this
host may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Sequence

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches by wrapper, so that a run can show that it went through the
# kernels.  Process-wide; each wrapper adds one where it launches, and
# nowhere else.
LAUNCHES: Dict[str, int] = {"res_chain_cf": 0, "res_chain_rows": 0, "nms": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas' report (registers, shared memory, spills) of each library built by
# this process, by name; empty for a library found already built.
BUILD_LOGS: Dict[str, str] = {}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                           "kernels are built with it at first use")
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: Sequence[str] = ()) -> float:
    """Compile the named sources (default: every ``csrc/*.cu``) that are not
    built yet, one ``nvcc`` per source, all started together.  Returns the
    wall seconds spent; raises with the compiler's output on a failure."""
    names = list(names) or sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for name in names:
        dst = library_path(name)
        if os.path.exists(dst):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, dst, tmp, proc))
    failed = []
    for name, dst, tmp, proc in jobs:
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode == 0:
            os.replace(tmp, dst)
        else:
            os.unlink(tmp)
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(path)
    return lib
