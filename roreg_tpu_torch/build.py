"""Builds the port's native libraries from the sources in the checkout.

Every library is compiled by one compiler call into ``_build/`` beside
this file (listed in ``.gitignore``) and loaded with ``ctypes``. A build
writes to a temporary name and renames it into place, so concurrent
processes (test workers) never load a half-written library. A failed build
raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import time

__all__ = ["BUILD_DIR", "compile_shared", "needs_build"]

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")


def needs_build(src: str, lib: str) -> bool:
    return not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src)


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
