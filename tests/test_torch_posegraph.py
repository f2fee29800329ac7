"""The port's pose-graph synchronization against the JAX package's on the
four graphs of ``tests/test_posegraph.py``: exact, noisy, a low-weight
outlier, and a full-weight 90-degree outlier that only the IRLS rounds
vote down. Both work in float32; the refined pairwise transforms agree
within ``T_TOL``, and their rotations are proper."""

import os
import sys

import numpy as np
import pytest
from test_torch_reference_native import reference_native  # noqa: E402,F401 (autouse: the JAX host library, built whole)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu_torch.eval import posegraph  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

T_TOL = 1e-4  # f32 QR / SVD / solve in another order: ~3e-6 seen


def _graph(case):
    from test_posegraph import _make_graph

    seed, kw = {"exact": (0, dict(n=6)), "noisy": (1, dict(n=8, noise_deg=3.0, t_noise=0.05)),
                "low_weight_outlier": (2, dict(n=7, noise_deg=1.0, t_noise=0.01)),
                "full_weight_outlier": (5, dict(n=4, noise_deg=1.0, t_noise=0.01))}[case]
    Ps, pairs, Ts = _make_graph(np.random.default_rng(seed), **kw)
    w = np.ones(len(pairs), np.float32)
    if case == "low_weight_outlier":
        Ts[3] = np.eye(4, dtype=np.float32)
        w[3] = 0.05
    if case == "full_weight_outlier":
        corrupt = np.eye(4, dtype=np.float32)
        corrupt[:3, :3] = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
        corrupt[:3, 3] = [1.0, 0, 0]
        Ts[0] = (corrupt @ Ts[0]).astype(np.float32)
    return Ps, pairs, Ts, w


@pytest.mark.parametrize("case", ["exact", "noisy", "low_weight_outlier", "full_weight_outlier"])
def test_sync_scene_equals_jax(case):
    from roreg_tpu.eval.posegraph import sync_scene as jsync

    Ps, pairs, Ts, w = _graph(case)
    got = np.stack(posegraph.sync_scene(pairs, Ts, w, device="cpu"))
    ref = np.stack([np.asarray(t) for t in jsync(pairs, Ts, w)])
    assert got.dtype == np.float32 and np.abs(got - ref).max() <= T_TOL
    assert np.abs(np.linalg.det(got[:, :3, :3]) - 1).max() < 1e-4
    gt = np.stack([np.linalg.inv(Ps[i]) @ Ps[j] for i, j in pairs])
    assert np.abs(got[:, :3, 3] - gt[:, :3, 3]).max() < 0.1  # the outliers are overruled


def test_sync_scene_remaps_ids_and_keeps_the_pair_order():
    """Sparse node ids are remapped densely; the output follows the input
    pairs. The absolute poses carry a gauge; the pairwise transforms do not."""
    Ps, pairs, Ts, w = _graph("noisy")
    ids = [3, 7, 8, 12, 20, 21, 30, 41]
    sparse = [(ids[i], ids[j]) for i, j in pairs]
    a = np.stack(posegraph.sync_scene(sparse, Ts, w, device="cpu"))
    b = np.stack(posegraph.sync_scene(pairs, Ts, w, device="cpu"))
    assert np.array_equal(a, b)
    e = torch.as_tensor(pairs)
    P = posegraph.synchronize(e, torch.as_tensor(np.stack(Ts)), torch.as_tensor(w), len(Ps))
    assert float((torch.linalg.det(P[:, :3, :3]) - 1).abs().max()) < 1e-4
    assert float(P[0, :3, 3].abs().max()) < 1e-4  # the translation gauge c_0 = 0
