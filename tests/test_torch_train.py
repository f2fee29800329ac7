"""Head training (GF, RD, RM, ET) against the JAX package.

The four losses, and one train step of each head from the same variables
and the same batch (loss, updated parameters, running statistics); the
training loop's other pieces are in ``tests/test_torch_train_loop.py``.
Small group (G = 12), small batches.

One Adam step moves each parameter by about ``lr * sign(grad)``, so a
gradient that is zero in exact arithmetic (a bias that a training-mode
batch norm follows, whose gradient is rounding noise in both frameworks)
moves it by an arbitrary ``lr * noise / (|noise| + eps)``. Such elements
(|grad| below ``NOISE_GRAD`` times the head's largest gradient: biases
before a norm, attention key biases under the softmax, inputs constant
over the points before an instance norm; at most half of a head) are held
to the step size; every other element of the updated parameters and every
running statistic to 1e-5 relative to its tensor's largest value.
"""

import numpy as np
import pytest
from test_torch_reference_native import reference_native  # noqa: E402,F401 (autouse: the JAX host library, built whole)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from roreg_tpu.core.group import get_group as jax_group  # noqa: E402
from roreg_tpu.train import losses as JL  # noqa: E402
from roreg_tpu_torch.core.group import get_group  # noqa: E402
from roreg_tpu_torch.train import losses as L  # noqa: E402
from roreg_tpu_torch.train.trainer import TrainConfig, make_train_step  # noqa: E402
from roreg_tpu_torch.weights import _leaves, flatten_variables  # noqa: E402

G = 12
RTOL = 1e-5
NOISE_GRAD = 1e-6  # relative to the head's largest gradient element


def _np(tree):
    """A flax variable tree (dicts or FrozenDicts of arrays) as nested
    dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: _np(v) for k, v in tree.items()}
    return np.array(tree)


def _gf_batch(rng, b=8, noise=0.1):
    """feats1 = feats0 permuted by the true index's Cayley row, plus
    ``noise``: a learnable batch (noise 0.1) or a hard one (noise 3)."""
    f0 = rng.normal(size=(b, G, 32)).astype(np.float32)
    idx = rng.integers(0, G, size=b)
    cay = get_group(G).cayley
    f1 = np.stack([f0[i][cay[idx[i]]] for i in range(b)]) + noise * rng.normal(size=(b, G, 32)).astype(np.float32)
    q = rng.normal(size=(b, 4)).astype(np.float32)
    return {"feats0": f0, "feats1": f1.astype(np.float32), "true_idx": idx,
            "delta_r": q / np.linalg.norm(q, axis=-1, keepdims=True)}


def _rd_batch(rng, b=16):
    return {"feats0": rng.normal(size=(b, G, 32)).astype(np.float32),
            "feats1": rng.normal(size=(b, G, 32)).astype(np.float32),
            "rdiffs": rng.random(b).astype(np.float32)}


def _rm_batch(rng, m=24, n=20, p=8):
    pairs = np.stack([np.arange(p), rng.permutation(n - 2)[:p]], -1)  # valid rows and columns
    m0 = np.full((1, m), -1)
    m0[0, pairs[:, 0]] = pairs[:, 1]
    return {
        "feats0": rng.normal(size=(1, m, G, 32)).astype(np.float32),
        "feats1": rng.normal(size=(1, n, G, 32)).astype(np.float32),
        "keys0": rng.normal(size=(1, m, 3)).astype(np.float32),
        "keys1": rng.normal(size=(1, n, 3)).astype(np.float32),
        "mask0": (np.arange(m) < m - 3)[None],
        "mask1": (np.arange(n) < n - 2)[None],
        "pairs": pairs[None].astype(np.int32),
        "pair_mask": np.ones((1, p), bool),
        "unpair0": (np.arange(m) >= p)[None] & (np.arange(m) < m - 3)[None],
        "unpair1": np.isin(np.arange(n), pairs[:, 1], invert=True)[None] & (np.arange(n) < n - 2)[None],
        "matches0": m0,
    }


def _hard_gf_batch(rng):
    return _gf_batch(rng, noise=3.0)


BATCHES = {"gf": _hard_gf_batch, "rd": _rd_batch, "rm": _rm_batch, "et": _hard_gf_batch}


@pytest.fixture(scope="module")
def gf_frozen():
    from roreg_tpu.models.gf import GroupFeatNetwork

    return _np(GroupFeatNetwork(jax_group(G)).init(jax.random.PRNGKey(1), jnp.zeros((2, G, 32)), False))


# ---------------------------------------------------------------------------
# losses


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    b = 10
    inv0, inv1 = (rng.normal(size=(b, 32)).astype(np.float32) for _ in range(2))
    eqv0, eqv1 = (rng.normal(size=(b, G, 32)).astype(np.float32) for _ in range(2))
    idx = rng.integers(0, G, b)
    ref, raux = JL.gf_loss(*(jnp.asarray(a) for a in (inv0, inv1, eqv0, eqv1, idx)), jax_group(G).cayley)
    cay = torch.as_tensor(get_group(G).cayley, dtype=torch.long)
    got, aux = L.gf_loss(*(torch.from_numpy(a) for a in (inv0, inv1, eqv0, eqv1, idx)), cay)
    assert float(got) == pytest.approx(float(ref), rel=RTOL)
    for k in raux:
        assert float(aux[k]) == pytest.approx(float(raux[k]), rel=RTOL, abs=1e-7), k

    scores, rdiffs = rng.random(2 * b).astype(np.float32), rng.random(b).astype(np.float32)
    assert float(L.rd_loss(torch.from_numpy(scores), torch.from_numpy(rdiffs))) == pytest.approx(
        float(JL.rd_loss(jnp.asarray(scores), jnp.asarray(rdiffs))), rel=RTOL)

    batch = _rm_batch(rng)
    sb = rng.normal(size=(1, 25, 21)).astype(np.float32)
    so = rng.random((1, 24, 20, 2)).astype(np.float32)
    args = (sb, so, batch["pairs"], batch["pair_mask"], batch["unpair0"], batch["unpair1"])
    ref, raux = JL.rm_loss(*(jnp.asarray(a) for a in args))
    got, aux = L.rm_loss(*(torch.from_numpy(np.asarray(a)) for a in args))
    assert float(got) == pytest.approx(float(ref), rel=RTOL)
    for k in raux:
        assert float(aux[k]) == pytest.approx(float(raux[k]), rel=RTOL), k

    q0, q1 = rng.normal(size=(b, 4)).astype(np.float32), rng.normal(size=(b, 4)).astype(np.float32)
    assert float(L.et_loss(torch.from_numpy(q0), torch.from_numpy(q1))) == pytest.approx(
        float(JL.et_loss(jnp.asarray(q0), jnp.asarray(q1))), rel=RTOL)


# ---------------------------------------------------------------------------
# one train step per head


def _jax_step(comp, batch, frozen):
    """The JAX package's first step: (variables before, loss, grads,
    variables after)."""
    from roreg_tpu.train.trainer import TrainConfig as JTrainConfig, make_train_step as j_make

    jcfg = JTrainConfig.defaults(comp, group_size=G)
    init_fn, step_fn, _ = j_make(jcfg, frozen)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = init_fn(jax.random.PRNGKey(0), jb)
    before = _np({"params": state["params"], "batch_stats": state["batch_stats"]})
    new, metrics = step_fn(state, jb)
    after = _np({"params": new["params"], "batch_stats": new["batch_stats"]})
    return before, float(metrics["loss"]), after


@pytest.mark.parametrize("comp", ["gf", "rd", "rm", "et"])
def test_one_train_step_matches_jax(comp, gf_frozen):
    rng = np.random.default_rng({"gf": 1, "rd": 2, "rm": 3, "et": 4}[comp])
    batch = BATCHES[comp](rng)
    frozen = {"gf": gf_frozen} if comp == "et" else None
    before, ref_loss, after = _jax_step(comp, batch, frozen)
    cfg = TrainConfig.defaults(comp, group_size=G)
    init_fn, step_fn, _ = make_train_step(cfg, frozen, device="cpu")
    state = init_fn(before)
    metrics = step_fn(state, batch)
    assert float(metrics["loss"]) == pytest.approx(ref_loss, rel=RTOL)
    assert state.step == 1
    grads = {"/".join(path): t.grad for t, path, _ in _leaves(state.net) if path[0] == "params"}
    got = flatten_variables(state.variables())
    ref = flatten_variables(after)
    assert got.keys() == ref.keys()
    lr = cfg.lr_init
    gmax = max(float(g.abs().max()) for g in grads.values())
    noisy = 0
    for k, want in ref.items():
        have = got[k]
        scale = RTOL * max(float(np.abs(want).max()), 1e-12)
        if k in grads:
            g = grads[k].numpy()
            g = g.T if g.shape != want.shape else g
            noise = np.abs(g) < NOISE_GRAD * gmax  # a rounding-noise gradient: the step is at most lr
            noisy += int(noise.sum())
            assert (np.abs(have - want)[noise] <= 2 * lr * 1.001).all(), k
            have, want = have[~noise], want[~noise]
        assert np.allclose(have, want, rtol=RTOL, atol=scale), (k, float(np.abs(have - want).max()))
    assert noisy <= 0.5 * sum(v.size for v in ref.values())
