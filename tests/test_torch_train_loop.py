"""The training loop's pieces against the JAX package: the batch functions
(the same features and ``default_rng`` seed give the same batches), the
PCA filter, validation, the best-checkpoint gate, a step-accurate resume
and a trained checkpoint in the pipeline. Small group (G = 12)."""

from types import SimpleNamespace

import numpy as np
import pytest
from test_torch_reference_native import reference_native  # noqa: E402,F401 (autouse: the JAX host library, built whole)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu_torch.data.synthetic import synthetic_scene  # noqa: E402
from roreg_tpu_torch.train import data as D  # noqa: E402
from roreg_tpu_torch.train.trainer import TrainConfig, Trainer, make_train_step, name2metric  # noqa: E402
from roreg_tpu_torch.train.validators import make_val_fn  # noqa: E402
from roreg_tpu_torch.weights import flatten_variables  # noqa: E402

G = 12
VAL_RTOL = 1e-4  # means of f32 network outputs of the two frameworks


def _scene(seed=2):
    return synthetic_scene(np.random.default_rng(seed), num_clouds=3, points_per_cloud=2000, num_keypoints=400,
                           overlap=0.7, max_angle_deg=50.0, surface_extent=1.2, name=f"scene{seed}")


class _Cache:
    """A feature cache whose rotations come from the batch function's rng
    (as the real one draws them) and whose features are fixed arrays."""

    def __init__(self, feats):
        self.cfg = SimpleNamespace(group_size=G)
        self.rnum = 2
        self.feats = feats
        self.cache = {}

    def get(self, ds, pc_id, rng):
        key = (ds.name, pc_id)
        if key not in self.cache:
            Rs = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(self.rnum)])
            Rs = Rs * np.sign(np.linalg.det(Rs))[:, None, None]
            self.cache[key] = (Rs.astype(np.float32), self.feats[key])
        return self.cache[key]


def _feats(scene, seed=0, rnum=2):
    rng = np.random.default_rng(seed)
    return {(scene.name, i): rng.normal(size=(rnum, len(scene.get_kps(i)), G, 32)).astype(np.float32)
            for i in scene.pc_ids}


def _equal_batches(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_batch_functions_equal_jax():
    from roreg_tpu.train import data as JD

    scene = _scene()
    feats = _feats(scene)
    its = [mod.gf_et_batches(_Cache(feats), [scene], 16, np.random.default_rng(5)) for mod in (JD, D)]
    for _ in range(3):
        _equal_batches(*(next(it) for it in its))

    gf = {k: v[0] for k, v in feats.items()}
    its = [mod.rm_batches(gf, [scene], np.random.default_rng(6), min_ps=64, max_ps=300, capacity=320,
                          group_size=G, max_pairs=256) for mod in (JD, D)]
    for _ in range(3):
        _equal_batches(*(next(it) for it in its))

    rng = np.random.default_rng(7)
    bank = []
    for _ in range(2):
        R = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(20)])
        R = R * np.sign(np.linalg.det(R))[:, None, None]
        T_pre = np.tile(np.eye(4), (20, 1, 1))
        T_pre[:, :3, :3], T_pre[:, :3, 3] = R, rng.normal(size=(20, 3))
        bank.append({"feats0": rng.normal(size=(20, G, 32)), "feats1": rng.normal(size=(20, G, 32)),
                     "T_pre": T_pre, "T_gt": T_pre[0]})
    its = [mod.rd_batches(bank, 8, np.random.default_rng(8)) for mod in (JD, D)]
    for _ in range(3):
        _equal_batches(*(next(it) for it in its))


class _PlaneSphere:
    """Half the keypoints on a plane (planarity about 0), half on a sphere
    of radius 0.3 (high surface variation); identity gt."""

    name = "stub"
    pc_ids = (0, 1)
    pair_ids = ((0, 1),)

    def __init__(self):
        rng = np.random.default_rng(5)
        plane = np.column_stack([rng.uniform(0, 2, size=(3000, 2)), np.zeros(3000)])
        v = rng.normal(size=(3000, 3))
        sphere = 0.3 * v / np.linalg.norm(v, axis=1, keepdims=True) + np.array([5.0, 0, 0])
        self._pc = np.concatenate([plane, sphere]).astype(np.float32)
        self._kp = np.concatenate([plane[:32], sphere[:32]]).astype(np.float32)

    def get_pc(self, pc_id):
        return self._pc

    def get_kps(self, pc_id):
        return self._kp

    def get_transform(self, id0, id1):
        return np.eye(4)


def test_planar_keypoints_excluded_from_batches():
    """The port of ``tests/test_gf_et_pca_filter.py``: with the PCA filter
    no planar keypoint (ids 0..31, which the stub features encode) reaches
    a batch; without it they do."""
    ds = _PlaneSphere()
    ids = np.arange(64, dtype=np.float32)[None, :, None, None]
    cache = _Cache({("stub", i): np.broadcast_to(ids, (2, 64, G, 32)).copy() for i in ds.pc_ids})
    rng = np.random.default_rng(0)
    it = D.gf_et_batches(cache, [ds], batch_size=64, rng=rng, pair_dist=0.01, pca_thre=0.03)
    for _ in range(3):
        assert (next(it)["feats0"][:, 0, 0] >= 32).all(), "planar keypoints leaked into a batch"
    it = D.gf_et_batches(cache, [ds], batch_size=64, rng=rng, pair_dist=0.01, pca_thre=None)
    assert (np.concatenate([next(it)["feats0"][:, 0, 0] for _ in range(3)]) < 32).any()


def _batches(rng):
    from test_torch_train import _gf_batch, _rd_batch, _rm_batch

    return {"gf": _gf_batch(rng), "rd": _rd_batch(rng), "rm": _rm_batch(rng), "et": _gf_batch(rng)}


def test_make_val_fn_all_components_equal_jax():
    """Each component's validation on the same variables and held-out batch
    gives the JAX package's metrics."""
    import jax
    import jax.numpy as jnp

    from roreg_tpu.models.gf import GroupFeatNetwork as JGF
    from roreg_tpu.core.group import get_group as jax_group
    from roreg_tpu.train.trainer import TrainConfig as JTrainConfig, make_train_step as j_make
    from roreg_tpu.train.validators import make_val_fn as j_make_val_fn
    from test_torch_train import _np

    gf_vars = _np(JGF(jax_group(G)).init(jax.random.PRNGKey(1), jnp.zeros((2, G, 32)), False))
    for comp, batch in _batches(np.random.default_rng(5)).items():
        frozen = {"gf": gf_vars} if comp == "et" else None
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        j_init, _, j_eval = j_make(JTrainConfig.defaults(comp, group_size=G), frozen)
        jstate = j_init(jax.random.PRNGKey(0), jb)
        ref = j_make_val_fn(comp, G, [jb], frozen=frozen)(jstate, j_eval)
        init_fn, _, eval_fwd = make_train_step(TrainConfig.defaults(comp, group_size=G), frozen, device="cpu")
        state = init_fn(_np({"params": jstate["params"], "batch_stats": jstate["batch_stats"]}))
        out = make_val_fn(comp, G, [batch], frozen=frozen)(state, eval_fwd)
        assert set(out) == set(ref), comp
        key = name2metric[comp][0]
        assert np.isfinite(out[key]), comp
        for k in ref:
            assert np.allclose(out[k], np.asarray(ref[k]), rtol=VAL_RTOL, atol=1e-6), (comp, k, out[k], ref[k])
        assert state.net.training  # validation restores the training mode


def test_validation_gates_best_checkpoint(tmp_path):
    """Validation runs every ``val_interval`` steps, the gate metric
    improves on a learnable fixed batch, and ``model_best`` is written; it
    loads into the pipeline through ``weights.load_components``."""
    from test_torch_train import _gf_batch

    from roreg_tpu_torch.pipeline.config import PipelineConfig
    from roreg_tpu_torch.pipeline.registration import RegistrationPipeline
    from roreg_tpu_torch.train.checkpoints import load_pipeline_variables
    from roreg_tpu_torch.weights import init_variables, load_components

    cfg = TrainConfig.defaults("gf", group_size=G, lr_init=1e-3, total_steps=8, val_interval=4,
                               save_interval=100, log_interval=2, model_dir=str(tmp_path))
    fixed = _gf_batch(np.random.default_rng(4))

    def it():
        while True:
            yield fixed

    t = Trainer(cfg, it(), val_fn=make_val_fn("gf", G, [fixed]), device="cpu")
    res = t.run()
    assert res["final_step"] == 8 and np.isfinite(res["last"]["loss"])
    assert np.isfinite(t.best) and t.best >= 0.0
    best = tmp_path / "GF" / "model_best"
    assert (best / "gf.npz").exists() and not (tmp_path / "GF" / "model").exists()
    assert len([h for h in t.history if "val_whole_recall" in h]) == 2  # steps 4 and 8
    assert len((tmp_path / "GF" / "log" / "scalars.jsonl").read_text().splitlines()) == 4 + 2

    pcfg = PipelineConfig(group_size=G, voxel_size=0.05, conv1_kernel_size=3)
    variables = init_variables(pcfg, 0)
    assert load_components(str(best), pcfg, variables, ("gf",)) == ["gf"]
    variables = init_variables(pcfg, 0)
    assert load_pipeline_variables(str(tmp_path), variables, pcfg) == ["gf"]
    pipe = RegistrationPipeline(pcfg, variables, device="cpu")
    sd = pipe.nets["gf"].state_dict()
    assert all(torch.equal(v, sd[k]) for k, v in t.state.net.state_dict().items())


@pytest.mark.parametrize("comp", ["gf", "rm"])
def test_resume_is_step_accurate(tmp_path, comp):
    """4 steps in one run equal 2 steps, a save, a restore into a new
    trainer and 2 more: the parameters, the running statistics, Adam's
    moments and the step count."""
    batches = [_batches(np.random.default_rng(10 + i))[comp] for i in range(4)]
    kw = dict(group_size=G, total_steps=4, save_interval=2, log_interval=100, val_interval=100)
    one = Trainer(TrainConfig.defaults(comp, model_dir=str(tmp_path / "one"), **kw), iter(batches), device="cpu")
    one.run()
    split_dir = str(tmp_path / "split")
    first = Trainer(TrainConfig.defaults(comp, model_dir=split_dir, **kw), iter(batches[:2]), device="cpu")
    first.run(steps=2)
    second = Trainer(TrainConfig.defaults(comp, model_dir=split_dir, **kw), iter(batches[2:]), device="cpu")
    second.run()
    assert second.state.step == one.state.step == 4
    a, b = flatten_variables(one.state.variables()), flatten_variables(second.state.variables())
    assert a.keys() == b.keys()
    for k in a:
        assert np.allclose(a[k], b[k], rtol=1e-6, atol=1e-8), k
    sa, sb = one.state.optimizer.state, second.state.optimizer.state
    for pa, pb in zip(one.state.net.parameters(), second.state.net.parameters()):
        for slot in ("exp_avg", "exp_avg_sq"):
            assert torch.allclose(sa[pa][slot], sb[pb][slot], rtol=1e-6, atol=1e-12)
        assert float(sa[pa]["step"]) == float(sb[pb]["step"]) == 4
