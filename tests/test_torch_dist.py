"""Distribution on ``torch.distributed``: a gloo world of two on the CPU.

Mirrors ``tests/test_dist.py`` and
``tests/test_dist_eval.py::test_sharded_matches_batched``. One spawn of two
processes (``init_method="file://..."``, no network port) runs every
sharded computation; each rank saves what it got, and the tests hold it
against one process on the whole batch:

* ``shard_train_step`` on a batch of each head (GF 16 and ET 8 samples,
  RD 8 pairs, so 16 rows of its concatenated forward, RM 2 pairs): the
  loss within the JAX test's 1e-3 and within 1e-6 (f32 rounding; the
  larger losses within 1e-6 of their size), the summed gradients within
  1e-5 of their largest element, the running statistics within 1e-5 of
  their largest value, the updated parameters as ``tests/test_torch_train.py`` holds one Adam step (1e-5
  relative, and the step size for elements whose gradient is
  rounding-sized, ROADMAP C19); both ranks hold the same state;
* the backbone's ``MaskedBatchNorm`` with half of the rows a rank: its
  output, statistics and gradients within 1e-5 of one process's;
* ``eval_pairs_sharded`` and ``pair_stacks_sharded`` on 8 pairs with the
  draws given: transforms within 1e-4 (JAX's test: 1e-3) of the batched
  stage, matches and estimate masks equal;
* ``replicate`` and ``shard_batch``; ``host_local_shard`` against the
  JAX package's at the same rank and world size, ``all_gather_metrics`` in
  rank order, ``primary_first``'s order.
"""

import os

import numpy as np
import pytest
from test_torch_reference_native import reference_native  # noqa: E402,F401 (autouse: the JAX host library, built whole)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from roreg_tpu_torch.core.group import get_group  # noqa: E402
from roreg_tpu_torch.dist import eval as dist_eval  # noqa: E402
from roreg_tpu_torch.dist import multihost  # noqa: E402
from roreg_tpu_torch.pipeline.config import PipelineConfig  # noqa: E402
from roreg_tpu_torch.pipeline.registration import RegistrationPipeline  # noqa: E402
from roreg_tpu_torch.models.gf import GroupFeatNetwork  # noqa: E402
from roreg_tpu_torch.sparse.conv import MaskedBatchNorm  # noqa: E402
from roreg_tpu_torch.train.trainer import TrainConfig, make_train_step  # noqa: E402
from roreg_tpu_torch.weights import _leaves, flatten_variables, init_module_variables, init_variables  # noqa: E402

GS, WORLD, B_GF, B_PAIRS = 12, 2, 16, 8
HEAD_BATCH = {"gf": B_GF, "rd": 8, "rm": 2, "et": 8}
RTOL = 1e-5
# Adam's first step moves an element by lr * g / (|g| + 1e-8): where g is
# rounding-sized (an exact zero, or a sum that cancels), the two runs'
# other order of the batch norms' sums moves it by up to lr either way
# (ROADMAP C19). Measured on this batch: every element off by more than
# 1e-5 had |g| <= 3.8e-6 of the head's largest gradient element.
NOISE_GRAD = 1e-5
# The same rule for RD, RM and ET: their elements off by more than 1e-5
# had |g| <= 1.5e-5 (RD), 6.3e-8 (RM) and 1.8e-7 (ET) of the largest.
NOISE_GRAD_HEADS = 2e-5
# The summed gradients themselves, before Adam: within 1e-5 of the largest
# gradient element (measured at most 1.3e-6, GF).
GRAD_ATOL = 1e-5
T_TOL = 1e-4
# GF's loss within 1e-6; the larger losses within 1e-6 of their size
# (ET: 7.6e-6 of 18.07, RD and RM equal).
LOSS_ATOL = 1e-6
LOSS_RTOL = 1e-6
EVAL = dict(group_size=GS, keynum=32, capacities=(512, 256, 128, 64), conv1_kernel_size=3, sinkhorn_iters=10,
            max_iter=32, use_rm=False, estimator="yohoc", bs_et=32, ransac_ird=0.5)


def _gf_batch(b):
    """tests/test_dist.py's GF batch."""
    rng = np.random.default_rng(0)
    f0 = rng.normal(size=(b, GS, 32)).astype(np.float32)
    idx = rng.integers(0, GS, size=b)
    cayley = get_group(GS).cayley
    f1 = np.stack([f0[i][cayley[idx[i]]] for i in range(b)])
    return {"feats0": f0, "feats1": f1, "true_idx": idx}


def _rd_batch(b):
    rng = np.random.default_rng(2)
    return {"feats0": rng.normal(size=(b, GS, 32)).astype(np.float32),
            "feats1": rng.normal(size=(b, GS, 32)).astype(np.float32),
            "rdiffs": rng.random(b).astype(np.float32)}


def _rm_batch(b, m=24, n=20, p=8):
    """``tests/test_torch_train.py``'s RM batch, one pair a row."""
    rng = np.random.default_rng(3)
    rows = []
    for _ in range(b):
        pairs = np.stack([np.arange(p), rng.permutation(n - 2)[:p]], -1)
        rows.append({
            "feats0": rng.normal(size=(m, GS, 32)).astype(np.float32),
            "feats1": rng.normal(size=(n, GS, 32)).astype(np.float32),
            "keys0": rng.normal(size=(m, 3)).astype(np.float32),
            "keys1": rng.normal(size=(n, 3)).astype(np.float32),
            "mask0": np.arange(m) < m - 3,
            "mask1": np.arange(n) < n - 2,
            "pairs": pairs.astype(np.int32),
            "pair_mask": np.ones(p, bool),
            "unpair0": (np.arange(m) >= p) & (np.arange(m) < m - 3),
            "unpair1": np.isin(np.arange(n), pairs[:, 1], invert=True) & (np.arange(n) < n - 2),
        })
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def _et_batch(b):
    batch = _gf_batch(b)
    q = np.random.default_rng(4).normal(size=(b, 4)).astype(np.float32)
    return {**batch, "delta_r": q / np.linalg.norm(q, axis=-1, keepdims=True)}


def _head_step(comp):
    """-> (config, fresh state, step_fn, batch) of one head at seed 0; ET's
    frozen GF from seed 1."""
    cfg = TrainConfig.defaults(comp, group_size=GS, batch_size=HEAD_BATCH[comp])
    frozen = {"gf": init_module_variables(GroupFeatNetwork(get_group(GS)), 1)} if comp == "et" else None
    init_fn, step_fn, _ = make_train_step(cfg, frozen, device="cpu")
    batch = {"gf": _gf_batch, "rd": _rd_batch, "rm": _rm_batch, "et": _et_batch}[comp](HEAD_BATCH[comp])
    return cfg, init_fn(seed=0), step_fn, batch


def _bn_inputs():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(400, 32)).astype(np.float32)
    mask = rng.random(400) < 0.7
    dy = rng.normal(size=(400, 32)).astype(np.float32)
    return x, mask, dy


def _eval_inputs():
    """tests/test_dist_eval.py's pair batch, with the draws as inputs, and
    descriptor stacks of 4 clouds for the stacked variant."""
    rng = np.random.default_rng(0)
    k = EVAL["keynum"]
    sets = [rng.normal(size=(B_PAIRS, k, GS, 32)).astype(np.float32) for _ in range(4)]
    keys = [rng.normal(size=(B_PAIRS, k, 3)).astype(np.float32) for _ in range(2)]
    draws = {"buckets": rng.integers(0, GS, (B_PAIRS, EVAL["max_iter"])),
             "gumbel": rng.gumbel(size=(B_PAIRS, EVAL["max_iter"], k)).astype(np.float32)}
    stacks = (rng.normal(size=(4, k, GS, 32)).astype(np.float32), rng.normal(size=(4, k, GS, 32)).astype(np.float32),
              rng.normal(size=(4, k, 3)).astype(np.float32))
    i0 = np.array([0, 0, 1, 2, 3, 1, 2, 0])
    i1 = np.array([1, 2, 3, 3, 0, 2, 1, 3])
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    return ([t(a) for a in sets[:2] + sets[2:] + keys], {k: t(v) for k, v in draws.items()},
            [t(a) for a in stacks], t(i0), t(i1))


def _pipe():
    cfg = PipelineConfig(**EVAL)
    return RegistrationPipeline(cfg, init_variables(cfg, 0), device="cpu")


def _worker(rank: int, init_file: str, out_dir: str) -> None:
    """One rank of the world: every sharded computation, results saved."""
    from roreg_tpu_torch.dist.collectives import data_parallel, gather_rows, shard_rows
    from roreg_tpu_torch.dist.mesh import _sharded_forward, make_mesh, replicate, shard_batch, shard_train_step

    torch.set_num_threads(1)
    multihost.initialize(f"file://{init_file}", WORLD, rank, backend="gloo")
    mesh = make_mesh(WORLD, device="cpu")
    out = {"rank": mesh.rank}

    for comp in HEAD_BATCH:
        _, state, step_fn, batch = _head_step(comp)
        m = shard_train_step(step_fn, mesh)(state, batch)
        out[f"{comp}_loss"] = float(m["loss"])
        out[f"{comp}_vars"] = flatten_variables(state.variables())
        out[f"{comp}_grads"] = {"/".join(path): t.grad.clone() for t, path, _ in _leaves(state.net)
                                if path[0] == "params"}

    class Pool(torch.nn.Module):  # returns a batch statistic alongside its rows
        def forward(self, x, y=None):
            return {"rows": x * 2, "mean": x.mean(0, keepdim=True)}

    out["refused"] = []
    for what, call in (("args", lambda net: net(torch.ones(4, 3), torch.ones(3, 3))),
                       ("out", lambda net: net(torch.ones(4, 3)))):
        net = Pool()
        with _sharded_forward(net, mesh):
            try:
                call(net)
            except ValueError:
                out["refused"].append(what)

    x, mask, dy = (torch.from_numpy(a) for a in _bn_inputs())
    bn = MaskedBatchNorm(32)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(0))
    xs = shard_rows(x, None).clone().requires_grad_()
    with data_parallel(torch.distributed.group.WORLD):
        y = gather_rows(bn(xs, shard_rows(mask, None)), None)
    (y * dy).sum().backward()
    for p in (bn.weight, bn.bias):
        torch.distributed.all_reduce(p.grad)
    out["bn"] = {"y": y.detach(), "dx": gather_rows(xs.grad, None), "mean": bn.running_mean.clone(),
                 "var": bn.running_var.clone(), "dw": bn.weight.grad.clone(), "db": bn.bias.grad.clone()}

    sets, draws, stacks, i0, i1 = _eval_inputs()
    pipe = _pipe()
    out["eval"] = dist_eval.eval_pairs_sharded(mesh, pipe, *sets, **draws)
    out["stacks"] = dist_eval.pair_stacks_sharded(mesh, pipe, i0, i1, *stacks, **draws)

    net = torch.nn.Linear(3, 2)
    with torch.no_grad():
        net.weight.fill_(float(rank))  # differs between the ranks until replicated
    replicate(mesh, net)
    out["replicated"] = (net.weight.detach().clone(), replicate(mesh, {"t": torch.full((2,), float(rank))})["t"])
    out["batch_shard"] = shard_batch(mesh, {"x": torch.arange(8), "y": np.arange(4), "n": 3})

    with multihost.primary_first():  # rank 0's block ends before rank 1's starts
        if rank == 0:
            open(os.path.join(out_dir, "first"), "w").close()
        out["saw_first"] = os.path.exists(os.path.join(out_dir, "first"))

    out["shard"] = multihost.host_local_shard(list(range(7)))
    out["metrics"] = multihost.all_gather_metrics({"b": 2.0 * rank + 0.5, "a": float(rank)})
    out["primary"] = multihost.is_primary()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the world of two once; -> each rank's saved results."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("gloo")
    mp.spawn(_worker, args=(str(tmp / "init"), str(tmp)), nprocs=WORLD, join=True)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _check_sharded_step(comp, world):
    cfg, state, step_fn, batch = _head_step(comp)
    m = step_fn(state, batch)
    assert abs(world[0][f"{comp}_loss"] - float(m["loss"])) < 1e-3  # tests/test_dist.py's bound
    # the batch norms' sums run in another order: 6.7e-8 of GF's loss of 5.8e-3
    assert abs(world[0][f"{comp}_loss"] - float(m["loss"])) <= max(LOSS_ATOL, LOSS_RTOL * abs(float(m["loss"])))
    grads = {"/".join(path): t.grad for t, path, _ in _leaves(state.net) if path[0] == "params"}
    gmax = max(float(g.abs().max()) for g in grads.values())
    for r in range(WORLD):
        assert world[r][f"{comp}_grads"].keys() == grads.keys()
        for k, g in grads.items():
            assert float((world[r][f"{comp}_grads"][k] - g).abs().max()) <= GRAD_ATOL * gmax, (r, k)
    noise_grad = NOISE_GRAD if comp == "gf" else NOISE_GRAD_HEADS
    ref = flatten_variables(state.variables())
    for r in range(WORLD):
        got = world[r][f"{comp}_vars"]
        assert got.keys() == ref.keys()
        for k, want in ref.items():
            have = got[k]
            scale = RTOL * max(float(np.abs(want).max()), 1e-12)
            if k in grads:
                g = grads[k].numpy()
                g = g.T if g.shape != want.shape else g
                noise = np.abs(g) < noise_grad * gmax  # a rounding-noise gradient: the step is at most lr
                assert (np.abs(have - want)[noise] <= 2 * cfg.lr_init * 1.001).all(), k
                have, want = have[~noise], want[~noise]
            assert np.allclose(have, want, rtol=RTOL, atol=scale), (k, float(np.abs(have - want).max()))
    noisy = sum(int((np.abs(g.numpy()) < noise_grad * gmax).sum()) for g in grads.values())
    assert noisy <= 0.5 * sum(g.numel() for g in grads.values())
    for k in ref:  # the two ranks hold one state
        assert np.array_equal(world[0][f"{comp}_vars"][k], world[1][f"{comp}_vars"][k]), k


def test_sharded_gf_step_matches_single_process(world):
    _check_sharded_step("gf", world)


@pytest.mark.parametrize("comp", ["rd", "rm", "et"])
def test_sharded_head_step_matches_single_process(comp, world):
    """RD's forward takes both sides concatenated (rank 0 gets feats0, rank
    1 feats1), RM's six pair-shaped inputs and a dict of score maps, ET's
    true index beside the frozen GF's features: each sharded step is the
    single-process step on the whole batch."""
    _check_sharded_step(comp, world)


def test_sharded_forward_refuses_other_tensors(world):
    """A forward given a tensor that does not lead with the batch axis, or
    returning one that does not lead with the shard's rows, raises instead
    of cutting or gathering it."""
    for r in range(WORLD):
        assert world[r]["refused"] == ["args", "out"]


def test_sharded_masked_batch_norm_matches_single_process(world):
    x, mask, dy = (torch.from_numpy(a) for a in _bn_inputs())
    bn = MaskedBatchNorm(32)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(0))
    x.requires_grad_()
    y = bn(x, mask)
    (y * dy).sum().backward()
    ref = {"y": y.detach(), "dx": x.grad, "mean": bn.running_mean, "var": bn.running_var,
           "dw": bn.weight.grad, "db": bn.bias.grad}
    for r in range(WORLD):
        for k, want in ref.items():
            got = world[r]["bn"][k]
            assert float((got - want).abs().max()) <= RTOL * max(float(want.abs().max()), 1.0), (r, k)


def test_sharded_eval_matches_batched(world):
    sets, draws, stacks, i0, i1 = _eval_inputs()
    pipe = _pipe()
    ref = dist_eval.batched_pair_stage(pipe, *sets, **draws)
    ref_stacks = dist_eval.pair_batch_from_stacks(pipe, i0, i1, *stacks, **draws)
    for r in range(WORLD):
        for got, want in ((world[r]["eval"], ref), (world[r]["stacks"], ref_stacks)):
            assert got.keys() == want.keys() and got["transform"].shape == (B_PAIRS, 4, 4)
            assert float((got["transform"] - want["transform"]).abs().max()) <= T_TOL
            for k in ("m0", "m1", "est_valid", "match_valid", "keys_m0", "keys_m1"):
                if k in want:
                    assert torch.equal(got[k], want[k]), (r, k)


def test_replicate_and_shard_batch(world):
    """``replicate`` gives every rank rank 0's module and tensors;
    ``shard_batch`` takes each rank's contiguous slice of every leading axis
    (tensors and arrays) and leaves scalars."""
    for r in range(WORLD):
        weight, t = world[r]["replicated"]
        assert bool((weight == 0).all()) and bool((t == 0).all())
        got = world[r]["batch_shard"]
        assert torch.equal(got["x"], torch.arange(8)[4 * r:4 * r + 4])
        assert np.array_equal(got["y"], np.arange(4)[2 * r:2 * r + 2]) and got["n"] == 3


def test_host_local_shard_and_metrics(world, monkeypatch):
    """``host_local_shard`` equals the JAX package's at the same rank and
    world size; ``all_gather_metrics`` gives each rank's values in rank
    order; one process answers for a world of one, as JAX's does."""
    from roreg_tpu.dist import multihost as jax_multihost

    for r in range(WORLD):
        monkeypatch.setattr(jax, "process_count", lambda: WORLD)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        assert world[r]["shard"] == jax_multihost.host_local_shard(list(range(7)))
        assert world[r]["metrics"] == {"a": [0.0, 1.0], "b": [0.5, 2.5]}
        assert world[r]["primary"] == (r == 0) and world[r]["saw_first"]
    monkeypatch.undo()
    assert multihost.host_local_shard(list(range(7))) == jax_multihost.host_local_shard(list(range(7)))
    assert multihost.all_gather_metrics({"x": 1.5}) == jax_multihost.all_gather_metrics({"x": 1.5})
    assert multihost.is_primary() and multihost.process_count() == 1


def test_compile_guard_signature_equals_jax(tmp_path, capsys):
    """The port's describe signature hashes the JAX package's fields alike;
    an unknown signature warns (naming the kernels' builds) and is known
    once recorded."""
    from roreg_tpu.pipeline.config import PipelineConfig as JConfig
    from roreg_tpu.utils import compile_guard as jguard
    from roreg_tpu_torch.utils import compile_guard as guard

    for kw in ({}, {"engine": "gather", "host_maps": False}, {"backbone_compute_dtype": None, "rot_vmap": 2}):
        assert guard.describe_signature(PipelineConfig(**kw)) == jguard.describe_signature(JConfig(**kw))
    cfg = PipelineConfig()
    assert not guard.check_describe_signature(cfg, str(tmp_path), label="bench")
    assert "nvcc" in capsys.readouterr().err
    guard.record_describe_signature(cfg, str(tmp_path), label="bench")
    assert guard.check_describe_signature(cfg, str(tmp_path), label="bench")
    assert capsys.readouterr().err == ""
