"""ctypes binding to the native C++ runtime (``cpp/`` -> ``libyf.so``).

The port of ``yolofastest_tpu/native/engine.py``: the host-CPU deployment
path, an NHWC conv engine written in C++ (fp32 AVX tiles, int8 VNNI 1x1
and 3x3 convolutions, its own decode and NMS in ``cpp/src/post.cpp``) that
runs the BN-folded graph exported with
:func:`yolofastest_torch.export.save_native_weights`.  The engine runs on
the host's cores whatever card the process has; it takes numpy arrays.

The library is the unchanged C++ of ``cpp/``, found or built at first use:

* ``cpp/build/libyf.so`` (:func:`default_library_path`, what
  ``cpp/build.sh`` writes) where it exists;
* else ``build/native/libyf-<hash>.so`` under the repository root
  (git-ignored), compiled from the sources of ``cpp/CMakeLists.txt``'s
  ``yf_core`` and ``yf`` targets with the host C++ compiler, one process
  per source, all started together, then linked; the hash covers the
  sources, the headers, the compiler and the flags, so an edit rebuilds;
  where the compiler cannot link ``-fopenmp`` (no ``libgomp.spec``), the
  GNU OpenMP runtime is linked by its path (torch's own first).

Neither cmake nor ninja is needed.  If neither library can be had,
:class:`NativeEngine` raises ``FileNotFoundError`` naming both paths.
``YF_INT8=0`` in the environment keeps every layer in fp32 (the library
reads it when an engine is made).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from yolofastest_torch.configs import Config

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CPP = os.path.join(ROOT, "cpp")
BUILD_DIR = os.path.join(ROOT, "build", "native")
# cpp/CMakeLists.txt: the yf_core sources, then the C interface of libyf.so
SOURCES = ("src/weights.cpp", "src/ops.cpp", "src/ops_int8.cpp", "src/ops_neon.cpp",
           "src/model.cpp", "src/post.cpp", "src/capi.cpp")
CXX_FLAGS = ("-std=c++17", "-O3", "-march=native", "-funroll-loops", "-fopenmp", "-fPIC")


def default_library_path() -> str:
    """``cpp/build/libyf.so``, where ``cpp/build.sh`` builds the library."""
    return os.path.join(CPP, "build", "libyf.so")


def _compiler() -> Optional[str]:
    return os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")


def built_library_path() -> str:
    """``build/native/libyf-<hash>.so``: the hash covers every file under
    ``cpp/src`` and ``cpp/include``, the compiler and the flags."""
    digest = hashlib.sha256(" ".join((str(_compiler()), *CXX_FLAGS)).encode())
    for sub in ("src", "include"):
        for d, _, files in sorted(os.walk(os.path.join(CPP, sub))):
            for f in sorted(files):
                digest.update(f.encode())
                with open(os.path.join(d, f), "rb") as fh:
                    digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"libyf-{digest.hexdigest()[:16]}.so")


def available_library() -> Optional[str]:
    """The library that :func:`find_library` would load without building,
    or None."""
    for path in (default_library_path(), built_library_path()):
        if os.path.exists(path):
            return path
    return None


def build_library(dst: str) -> Dict[str, Any]:
    """Compile :data:`SOURCES` into the shared library ``dst``; returns the
    build's wall ``seconds`` and the ``openmp`` runtime it linked.  Raises
    ``RuntimeError`` with the compiler's output on a failure
    (``FileNotFoundError`` when there is no compiler)."""
    cxx = _compiler()
    if cxx is None:
        raise FileNotFoundError("no C++ compiler ($CXX, c++, g++)")
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(dst)) as tmp:
        jobs = []
        for src in SOURCES:
            obj = os.path.join(tmp, os.path.basename(src)[:-4] + ".o")
            cmd = [cxx, *CXX_FLAGS, "-I", os.path.join(CPP, "include"), "-c",
                   os.path.join(CPP, src), "-o", obj]
            jobs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, _, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode:
                failed.append(f"{src} (exit {proc.returncode}):\n{log}")
        if failed:
            raise RuntimeError("native library build failed: " + "\n".join(failed))
        so = os.path.join(tmp, "libyf.so")
        objs = [j[1] for j in jobs]
        link = subprocess.run([cxx, "-shared", "-fopenmp", "-o", so, *objs],
                              capture_output=True, text=True)
        openmp = "the compiler's (-fopenmp)"
        if link.returncode:
            # a compiler without its OpenMP link files (no libgomp.spec):
            # link the GNU OpenMP runtime that is installed, by its path
            gomp = _libgomp(cxx)
            if gomp is None:
                raise RuntimeError(f"native library link failed and no libgomp found:\n"
                                   f"{link.stdout}{link.stderr}")
            link = subprocess.run([cxx, "-shared", "-o", so, *objs, gomp,
                                   f"-Wl,-rpath,{os.path.dirname(gomp)}"],
                                  capture_output=True, text=True)
            if link.returncode:
                raise RuntimeError(f"native library link failed:\n{link.stdout}{link.stderr}")
            openmp = gomp
        os.replace(so, dst)  # whole file or none, if two processes build at once
    return {"seconds": time.perf_counter() - t0, "openmp": openmp}


def _libgomp(cxx: str) -> Optional[str]:
    """A GNU OpenMP runtime to link by path: torch's own (one runtime in the
    process), else the compiler's, else the system's."""
    import glob

    import torch

    found = sorted(glob.glob(os.path.join(os.path.dirname(torch.__file__), "lib", "libgomp*.so*")))
    asked = subprocess.run([cxx, "-print-file-name=libgomp.so.1"], capture_output=True,
                           text=True).stdout.strip()
    found += [asked] if os.path.isabs(asked) else []
    for d in ("/usr/lib/x86_64-linux-gnu", "/lib/x86_64-linux-gnu", "/usr/lib64", "/usr/lib"):
        found += sorted(glob.glob(os.path.join(d, "libgomp.so*")))
    return next((f for f in found if os.path.exists(f)), None)


def find_library() -> Tuple[str, Optional[Dict[str, Any]]]:
    """``(path, build)``: the library found (``build`` None), or built now
    (``build`` as :func:`build_library` returns it).  Raises
    ``FileNotFoundError`` naming both paths when neither can be had."""
    path = available_library()
    if path is not None:
        return path, None
    dst = built_library_path()
    try:
        return dst, build_library(dst)
    except (OSError, RuntimeError) as e:
        raise FileNotFoundError(
            f"native library not found at {default_library_path()} (cpp/build.sh) and "
            f"not built at {dst}: {e}") from e


class NativeEngine:
    """Loads ``libyf.so`` and a ``.yfb`` weights file; runs forward/detect."""

    def __init__(self, weights_path: str, config: Config,
                 library_path: Optional[str] = None):
        if library_path is None:
            library_path = find_library()[0]
        elif not os.path.exists(library_path):
            raise FileNotFoundError(f"native library not built: {library_path}")
        self.lib = ctypes.CDLL(library_path)
        self.lib.yf_create.restype = ctypes.c_void_p
        self.lib.yf_create.argtypes = [ctypes.c_char_p]
        self.lib.yf_destroy.argtypes = [ctypes.c_void_p]
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        self.lib.yf_forward.restype = ctypes.c_int
        self.lib.yf_forward.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int, ctypes.c_int,
                                        f32p, f32p]
        self.lib.yf_detect.restype = ctypes.c_int
        self.lib.yf_detect.argtypes = [
            ctypes.c_void_p, f32p, ctypes.c_int, ctypes.c_int, f32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, f32p,
        ]
        self.lib.yf_is_lite.restype = ctypes.c_int
        self.lib.yf_is_lite.argtypes = [ctypes.c_void_p]
        self.lib.yf_int8_layers.restype = ctypes.c_int
        self.lib.yf_int8_layers.argtypes = [ctypes.c_void_p]
        self.library_path = library_path
        self.handle = self.lib.yf_create(weights_path.encode())
        if not self.handle:
            raise RuntimeError(f"failed to load weights: {weights_path}")
        self.is_lite = bool(self.lib.yf_is_lite(self.handle))
        #: layers executing with real int8 arithmetic (0 = pure fp32; > 0
        #: when the .yfb carries kernel_q weights AND act_scale entries)
        self.int8_layers = int(self.lib.yf_int8_layers(self.handle))
        self.config = config
        io = config.io
        self._anchors = np.asarray(io.anchors, np.float32).reshape(-1)
        if self.is_lite != (len(io.anchors) == 1):
            raise ValueError(
                f"weights are {'lite' if self.is_lite else 'two-head'} but "
                f"config has {len(io.anchors)} anchor group(s); use a "
                f"{'lite-*' if self.is_lite else 'non-lite'} config preset")

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.yf_destroy(self.handle)
            self.handle = None

    def forward(self, img: np.ndarray):
        """(H, W) or (H, W, 1) normalised float32 -> head NHWC logits:
        ``(head_large, head_small)`` for the two-head net, ``(head_small,)``
        for lite weights."""
        io = self.config.io
        h, w = io.input_hw
        img = np.ascontiguousarray(np.asarray(img).reshape(h, w), np.float32)
        ch = io.num_out
        large = np.empty((h // 16, w // 16, ch), np.float32)
        small = np.empty((h // 32, w // 32, ch), np.float32)
        if self.lib.yf_forward(self.handle, img, h, w, large.reshape(-1), small.reshape(-1)):
            raise RuntimeError("yf_forward failed")
        return (small,) if self.is_lite else (large, small)

    def detect(self, img: np.ndarray, max_det: int = 64) -> List[List[float]]:
        """(H, W) normalised float32 -> rows
        ``[x1, y1, x2, y2, conf, cls_score, cls_idx]`` (net-input coords)."""
        io = self.config.io
        h, w = io.input_hw
        img = np.ascontiguousarray(np.asarray(img).reshape(h, w), np.float32)
        out = np.empty((max_det, 7), np.float32)
        n = self.lib.yf_detect(self.handle, img, h, w, self._anchors, len(io.anchors),
                               io.num_anchors, io.num_cls, io.conf_thre, io.nms_thre, max_det,
                               out.reshape(-1))
        if n < 0:
            raise RuntimeError("yf_detect failed")
        return [list(map(float, row)) for row in out[:n]]
