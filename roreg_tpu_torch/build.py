"""Builds the port's native libraries from the sources in the checkout.

Every library is compiled by one compiler call into ``_build/`` beside
this file (listed in ``.gitignore``) and loaded with ``ctypes``. A build
writes to a temporary name and renames it into place, so concurrent
processes (test workers) never load a half-written library. A failed build
raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading
import time

__all__ = [
    "BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "CudaKernel", "compile_shared", "needs_build", "nvcc",
]

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
# every CUDA kernel: Hopper with its arch-specific features, plain C
# interface, no PyTorch headers
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` (default /usr/local/cuda),
    else the one on ``PATH``."""
    cuda = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return cuda if os.path.exists(cuda) else (shutil.which("nvcc") or "nvcc")


def needs_build(src: str, lib: str, deps: tuple[str, ...] = ()) -> bool:
    """Whether ``lib`` is missing or older than ``src`` or one of the
    headers ``deps`` it includes."""
    if not os.path.exists(lib):
        return True
    return os.path.getmtime(lib) < max(os.path.getmtime(p) for p in (src, *deps))


def compile_shared(cmd: list[str], src: str, lib: str, timeout: float = 600.0) -> float:
    """Run ``cmd + [src, "-o", tmp]`` and move ``tmp`` to ``lib``.

    Returns the compiler's wall seconds. Raises ``RuntimeError`` with the
    compiler's output when it fails or is missing.
    """
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(lib))
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            cmd + [src, "-o", tmp], capture_output=True, text=True, timeout=timeout
        )
    except FileNotFoundError as e:
        os.unlink(tmp)
        raise RuntimeError(f"compiler not found: {cmd[0]}") from e
    except subprocess.TimeoutExpired as e:
        os.unlink(tmp)
        raise RuntimeError(f"build of {src} exceeded {timeout} s") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"build of {src} failed ({' '.join(cmd)}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return time.perf_counter() - t0


class CudaKernel:
    """Base of every CUDA kernel's wrapper: builds ``csrc/<source>`` with
    ``nvcc`` into ``_build/lib<stem>.so`` at first use, loads it with
    ``ctypes`` (``_bind`` sets the C functions' signatures), and counts
    launches in ``launches``: a subclass adds one where it launches its
    kernel, and nowhere else."""

    source = ""

    def __init__(self) -> None:
        self.launches = 0
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()
        self._src = os.path.join(CSRC_DIR, self.source)
        self._so = os.path.join(BUILD_DIR, "lib" + os.path.splitext(self.source)[0] + ".so")

    def build(self, force: bool = False) -> float:
        """Compile the source for sm_90a if the library is missing or stale
        (or ``force``); returns nvcc's seconds."""
        headers = tuple(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
        if force or needs_build(self._src, self._so, headers):
            return compile_shared([nvcc()] + NVCC_FLAGS, self._src, self._so)
        return 0.0

    def _bind(self, lib: ctypes.CDLL) -> None:
        raise NotImplementedError

    def _load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self.build()
                lib = ctypes.CDLL(self._so)
                self._bind(lib)
                self._lib = lib
            return self._lib

    @staticmethod
    def check_rc(name: str, rc: int) -> None:
        """Raise when the C function returned a CUDA error (its
        ``cudaGetLastError()`` after the launch, or an argument refusal)."""
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
