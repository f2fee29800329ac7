"""The port's core (group tables, SO(3)/SE(3), kNN) against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu.core import knn as jknn  # noqa: E402
from roreg_tpu.core import se3 as jse3  # noqa: E402
from roreg_tpu.core import so3 as jso3  # noqa: E402
from roreg_tpu.core.group import get_group as jax_group  # noqa: E402
from roreg_tpu_torch.core import knn, se3, so3  # noqa: E402
from roreg_tpu_torch.core.group import get_group  # noqa: E402

TOL = 1e-5


@pytest.mark.parametrize("size", [12, 24, 60])
def test_group_tables_equal(size):
    a, b = get_group(size), jax_group(size)
    assert np.array_equal(a.rotations, b.rotations)
    assert np.array_equal(a.cayley, b.cayley)
    assert np.array_equal(a.nei13, b.nei13)
    assert np.array_equal(a.inverse, b.inverse)


def _rand_rotations(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return np.asarray(jso3.matrix_from_quaternion(jnp.asarray(q))), q


def test_so3_matches_jax():
    rng = np.random.default_rng(0)
    R, q = _rand_rotations(rng, 64)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    assert np.abs(so3.matrix_from_quaternion(t(q)).numpy() - R).max() <= TOL
    qj = np.asarray(jso3.quaternion_from_matrix(jnp.asarray(R)))
    assert np.abs(so3.quaternion_from_matrix(t(R)).numpy() - qj).max() <= TOL
    rots = get_group(60).rotations.astype(np.float32)
    idx_j = np.asarray(jso3.nearest_group_index(jnp.asarray(R), jnp.asarray(rots)))
    idx = so3.nearest_group_index(t(R), t(rots)).numpy()
    assert np.array_equal(idx, idx_j)
    rq_j = np.asarray(jso3.residual_quaternion(jnp.asarray(R), jnp.asarray(idx_j), jnp.asarray(rots)))
    assert np.abs(so3.residual_quaternion(t(R), t(idx), t(rots)).numpy() - rq_j).max() <= TOL


def test_se3_matches_jax():
    rng = np.random.default_rng(1)
    R, _ = _rand_rotations(rng, 4)
    src = rng.normal(size=(4, 50, 3)).astype(np.float32)
    tvec = rng.normal(size=(4, 3)).astype(np.float32)
    dst = np.einsum("bij,bnj->bni", R, src) + tvec[:, None] + rng.normal(size=src.shape).astype(np.float32) * 0.01
    w = rng.uniform(0.1, 1.0, size=(4, 50)).astype(np.float32)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    Tj = np.array(jse3.kabsch_weighted(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    T = se3.kabsch_weighted(t(src), t(dst), t(w)).numpy()
    assert np.abs(T - Tj).max() <= TOL
    assert np.abs(se3.transform_points(t(src), t(T)).numpy()
                  - np.asarray(jse3.transform_points(jnp.asarray(src), jnp.asarray(Tj)))).max() <= TOL
    # refinement, including the no-inlier guard (second transform is far off)
    T_far = Tj.copy()
    T_far[:, :3, 3] += 100.0
    valid = rng.random((4, 50)) > 0.2
    for T0 in (Tj, T_far):
        for dist in (0.05, 0.02):
            ref = np.asarray(jse3.refine_transform(
                jnp.asarray(dst), jnp.asarray(src), jnp.asarray(T0), jnp.asarray(w), dist,
                jnp.asarray(valid)))
            out = se3.refine_transform(t(dst), t(src), t(T0), t(w), dist, t(valid)).numpy()
            assert np.abs(out - ref).max() <= TOL


def test_knn_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(300, 3)).astype(np.float32)
    r = rng.normal(size=(500, 3)).astype(np.float32)
    mask = rng.random(500) > 0.3
    dj, ij = (np.asarray(x) for x in jknn.knn(jnp.asarray(q), jnp.asarray(r), 5,
                                               ref_mask=jnp.asarray(mask), tile=128))
    d, i = knn.knn(torch.from_numpy(q), torch.from_numpy(r), 5, ref_mask=torch.from_numpy(mask), tile=128)
    # index sets equal, modulo ties (equal distances may swap order)
    for row in range(len(q)):
        if set(i[row].tolist()) != set(ij[row].tolist()):
            assert np.allclose(np.sort(d[row].numpy()), np.sort(dj[row]), atol=1e-6)
    assert np.abs(d.numpy() - dj).max() <= 1e-4
    _, nj = jknn.nn(jnp.asarray(q), jnp.asarray(r), ref_mask=jnp.asarray(mask))
    _, n = knn.nn(torch.from_numpy(q), torch.from_numpy(r), ref_mask=torch.from_numpy(mask))
    assert np.array_equal(n.numpy(), np.asarray(nj))
    assert mask[n.numpy()].all()


def test_mutual_nn_matches_jax():
    rng = np.random.default_rng(3)
    f0 = rng.normal(size=(200, 32)).astype(np.float32)
    f1 = np.concatenate([f0[:120] + 0.05 * rng.normal(size=(120, 32)),
                         rng.normal(size=(60, 32))]).astype(np.float32)
    m0, m1 = rng.random(200) > 0.1, rng.random(180) > 0.1
    nj, mj = jknn.mutual_nn(jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(m0), jnp.asarray(m1))
    n, mu = knn.mutual_nn(torch.from_numpy(f0), torch.from_numpy(f1),
                          torch.from_numpy(m0), torch.from_numpy(m1))
    assert np.array_equal(n.numpy(), np.asarray(nj))
    assert np.array_equal(mu.numpy(), np.asarray(mj))
    assert mu.sum() > 50
