"""The JAX package's host library, built whole for the port's tests.

``roreg_tpu/native/lib.py`` compiles ``voxelhash.cpp`` at first use with
``g++ ... -o _voxelhash.so``, which writes the library in place, and then
loads any ``_voxelhash.so`` newer than its source. Test workers that start
together on a fresh checkout race there: one may load a half-written file
(``OSError: file too short``), and from then on that process runs the
JAX package's numpy fallbacks, which quantize differently from the C++
(``np.floor(p / voxel)`` against a product with the reciprocal).

Every port test module that calls into the JAX package imports the
``reference_native`` fixture from here. Before the module's first test
(and its module fixtures) it builds the library once per checkout into the
port's build directory, under an exclusive ``flock``, through a temporary
name renamed into place (``roreg_tpu_torch/build.py`` ``compile_shared``),
loads that copy into ``roreg_tpu.native.lib`` and fails if nothing loaded,
so a fallback can never pass unnoticed. Where ``_voxelhash.so`` is missing
or stale it also renames a copy onto it, so that the JAX package's own
tests, which still build in place, mostly find it built. The JAX package
itself is not changed.
"""

import ctypes
import fcntl
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

from roreg_tpu_torch.build import BUILD_DIR, compile_shared, needs_build

__all__ = ["REFERENCE_SO", "GXX", "build_whole", "ensure_reference_native", "reference_native"]

# the JAX package's own compiler call (roreg_tpu/native/lib.py _build)
GXX = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
REFERENCE_SO = os.path.join(BUILD_DIR, "reference_voxelhash.so")


def build_whole(src: str, so: str, install: str | None = None) -> str:
    """Compile ``src`` into ``so`` unless it is already newer, under an
    exclusive lock on ``so + ".lock"``: one process compiles, the others
    wait and then find it built; ``so`` only ever holds a whole library.
    With ``install``, a copy of it is also renamed onto that path where
    that is missing or stale, so the path holds a whole library too."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    with open(so + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if needs_build(src, so):
            compile_shared(GXX, src, so, timeout=300)
        if install is not None and install != so and needs_build(src, install):
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(install))
            os.close(fd)
            shutil.copy(so, tmp)  # with its mode
            os.replace(tmp, install)
    return so


def ensure_reference_native(so: str = REFERENCE_SO) -> ctypes.CDLL:
    """Load the JAX package's host library from a whole build at ``so``
    (built first where missing or stale, and installed whole at the JAX
    module's own path where that is missing or stale, which the package's
    own tests then find built) unless the process already holds it, and
    return it; raises if ``roreg_tpu.native.lib`` loaded nothing."""
    from roreg_tpu.native import lib as L

    if L._lib is None:
        build_whole(L._SRC, so, install=L._SO)
        saved = L._SO
        L._SO, L._tried = so, False  # a failed earlier attempt is retried
        try:
            L._load()
        finally:
            L._SO = saved
    if L._lib is None:
        raise RuntimeError(f"the JAX package's host library did not load from {so}")
    return L._lib


@pytest.fixture(scope="module", autouse=True)
def reference_native():
    """Autouse in every module that imports it: the JAX package's host
    library is loaded whole before the module's first test."""
    return ensure_reference_native()


RACE = """
import sys
sys.path.insert(0, {tests!r})
import numpy as np
from roreg_tpu.native import lib as L
import test_torch_reference_native as H

L._SRC, L._SO = {src!r}, {so!r}
H.ensure_reference_native(L._SO)
assert L._load() is not None
pts = np.random.default_rng(0).uniform(-2, 2, size=(4000, 3)).astype(np.float32)
to_voxel, rep, coords = L.voxelize_host(pts, 0.1)
assert np.array_equal(coords[to_voxel], np.floor(pts * (np.float32(1) / np.float32(0.1))).astype(np.int32))
"""


def test_processes_that_start_together_load_one_whole_library(tmp_path):
    """Four processes on a copy of the native sources with no library call
    the helper at once, building into the copy's own ``_voxelhash.so``,
    and then the JAX module's ``_load()``: every one loads a whole library
    (the C++ quantizes with the reciprocal), the path holds one, and no
    temporary file is left beside it."""
    from roreg_tpu.native import lib as L

    src = tmp_path / "voxelhash.cpp"
    src.write_bytes(Path(L._SRC).read_bytes())
    so = tmp_path / "_voxelhash.so"
    code = RACE.format(tests=str(Path(__file__).parent), src=str(src), so=str(so))
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=Path(__file__).resolve().parents[1])
             for _ in range(4)]
    errs = [p.communicate(timeout=600)[1] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, errs
    ctypes.CDLL(str(so))
    assert sorted(f.name for f in tmp_path.iterdir()) == ["_voxelhash.so", "_voxelhash.so.lock", "voxelhash.cpp"]


def test_the_fixture_leaves_the_native_library_loaded(reference_native):
    """The autouse fixture ran: the JAX module holds a loaded library and
    reports it available, and its path setting is the package's own."""
    from roreg_tpu.native import lib as L

    assert reference_native is L._lib is not None and L.native_available()
    assert L._SO == os.path.join(os.path.dirname(L._SRC), "_voxelhash.so")
    assert not needs_build(L._SRC, REFERENCE_SO) and not needs_build(L._SRC, L._SO)
    ctypes.CDLL(L._SO)  # the package's own path holds a whole library
