"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` entry points that take
raw device pointers and the CUDA stream and return a ``cudaError_t``. It is
compiled by ``nvcc -arch=sm_90a`` into ``_build/<hash>/lib<name>.so``
(``.gitignore`` lists ``_build/``), keyed by a hash of every source and the
flags, and loaded with ``ctypes``. ``build_all`` starts one ``nvcc`` per
source at once. A failed build raises; nothing falls back to the plain
versions.

``host_library`` builds the port's C++ host library for data preparation
(``native/<name>.cpp``, with ``g++``) the same way, into
``_build/host-<hash>/``; it needs no card.

``launch`` makes the tensors' device current around the call, so each
kernel runs on the card its tensors lie on. ``LAUNCHES`` counts kernel
launches by name: each wrapper adds one where it launches its kernel, so a
run can show that its path went through them.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "_build"
SOURCES = ("lstm", "sinkhorn", "superglue_gnn", "superglue_gnn_any",
           "pointconv", "fps")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

HOST_SRC = PKG / "native"
# The JAX package's own host library is built with these flags; the same
# flags give the same floating-point results (no FMA contraction under ISO
# C++), so DBSCAN's neighbourhoods and labels match element for element.
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-shared")

LAUNCHES: Dict[str, int] = collections.Counter()
_LIBS: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def build_all(names=SOURCES) -> Dict[str, float]:
    """Compile every missing library, all ``nvcc`` processes at once.

    Returns {name: seconds} for what was built (empty when all were
    cached). Raises RuntimeError with the compiler's output on failure.
    """
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not _lib_path(n).is_file()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    procs = {}
    t0 = time.time()
    for name in todo:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    took, errors = {}, []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.time() - t0
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):"
                          f"\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of ``name``, if this process built it."""
    path = build_dir() / f"{name}.log"
    return path.read_text() if path.is_file() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    if name not in _LIBS:
        if not _lib_path(name).is_file():
            build_all((name,))
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LIBS[name]


def _cpu_model() -> str:
    """The host CPU's model name (empty where it cannot be read)."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln for ln in f if ln.startswith("model name")), "")
    except OSError:
        return ""


def host_library(name: str) -> ctypes.CDLL:
    """The C++ host library ``native/<name>.cpp``, compiled by ``g++`` at
    first use into ``_build/host-<hash>/lib<name>.so`` and loaded. Raises
    RuntimeError with the compiler's output when it cannot be built; no
    caller falls back to another implementation on its own."""
    key = f"host:{name}"
    if key in _LIBS:
        return _LIBS[key]
    src = HOST_SRC / f"{name}.cpp"
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(src.read_bytes())
    h.update(_cpu_model().encode())     # -march=native: one build a CPU
    out_dir = BUILD_ROOT / f"host-{h.hexdigest()[:16]}"
    lib = out_dir / f"lib{name}.so"
    if not lib.is_file():
        gxx = os.environ.get("CXX") or shutil.which("g++")
        if not gxx:
            raise RuntimeError(f"g++ not found: the host library {name} "
                               "cannot be built")
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed for {src.name} (rc "
                               f"{proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
    _LIBS[key] = ctypes.CDLL(str(lib))
    return _LIBS[key]


def entry(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of library ``name``, returning an int
    (a ``cudaError_t``); its argument types are set on first use (setting
    them costs the host a few µs a launch)."""
    fn = getattr(library(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def refuse_grad(what: str, *tensors) -> None:
    """Raise if grad mode is on and one of ``tensors`` requires grad: a
    kernel's output is a fresh tensor that C fills, with no path back to
    its inputs. Only a kernel's ``torch.autograd.Function`` (where grad
    mode is off in ``forward``) may launch it on such inputs."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"{what}: an input requires grad, and the kernel's output would "
            "be detached from it; call it through its autograd Function or "
            "under torch.no_grad()")


def launch(fn: ctypes._CFuncPtr, device: torch.device, what: str,
           *args) -> None:
    """Call the C entry point ``fn(*args, stream)`` with ``device`` the
    current device and ``stream`` that device's current stream, and raise
    on a CUDA error. The C side sets kernel attributes and launches on the
    current device, so a tensor on another card than the current one is
    still worked on where it lies."""
    with torch.cuda.device(device):
        check(fn(*args, torch.cuda.current_stream(device).cuda_stream), what)
