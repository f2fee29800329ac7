"""JAX variables <-> the port's modules.

The JAX package's variables, given as nested dicts of numpy arrays
(``{"params": {...}, "batch_stats": {...}}`` per network), map one to one
onto the port's modules, whose submodules carry the flax names:

* flax ``Dense`` and group-conv kernels ``(in, out)`` <-> ``nn.Linear.weight``
  ``(out, in)``, biases as they are;
* sparse-conv kernels keep ``(27|343, Cin, Cout)``;
* batch norm: ``params/{scale,bias}`` and ``batch_stats/{mean,var}`` <->
  ``weight``, ``bias``, ``running_mean``, ``running_var``;
* instance norm (no statistics): ``params/{scale,bias}`` <-> ``weight``,
  ``bias``.

* RM's learned dustbin score: ``params/bin_score`` <-> ``bin_score``.

A backbone's training state converts the same way: its ``params`` and
``batch_stats`` load into every variant of the zoo (``load_variables``)
and come back in the JAX layout (``export_variables``).

Nothing here imports flax or orbax: callers restore checkpoints themselves
and pass numpy arrays; :func:`flatten_variables` gives any tree as a flat
state_dict. :func:`load_checkpoint_dir` reads a converted checkpoint set
(one float32 ``.npz`` of flat keys per network and the set's
``config_tag.json``), such as the committed quality weights in
``checkpoints/quality_full/`` (written by ``tests/test_torch_quality_weights.py``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterator

import numpy as np
import torch
from torch import nn

from roreg_tpu_torch.core.group import get_group
from roreg_tpu_torch.layers import BatchNorm
from roreg_tpu_torch.models.et import EquivariantTransformer
from roreg_tpu_torch.models.gf import GroupFeatNetwork
from roreg_tpu_torch.models.ops import GroupConv
from roreg_tpu_torch.models.rd import RotationDetector
from roreg_tpu_torch.models.rm import RotationCoherenceMatcher
from roreg_tpu_torch.pipeline.config import PipelineConfig, rm_row_block
from roreg_tpu_torch.pipeline.extractor import make_backbone
from roreg_tpu_torch.sparse.conv import MaskedInstanceNorm

__all__ = [
    "build_modules",
    "load_variables",
    "export_variables",
    "flatten_variables",
    "unflatten_variables",
    "init_variables",
    "init_module_variables",
    "load_checkpoint_dir",
    "load_components",
    "CHECKPOINT_COMPONENTS",
    "QUALITY_FULL_DIR",
]

CHECKPOINT_COMPONENTS = ("backbone", "gf", "rd", "rm", "et")
# the committed quality weights, trained under quality_full_config()
QUALITY_FULL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "checkpoints", "quality_full")


def build_modules(cfg: PipelineConfig) -> dict[str, nn.Module]:
    """The pipeline's networks at the shapes ``cfg`` gives, on the CPU: the
    backbone of the engine (``cfg.engine``; both engines' ResUNets have one
    parameter tree), GF, RD, ET, and RM when ``cfg.use_rm``."""
    group = get_group(cfg.group_size)
    nets = {
        "backbone": make_backbone(cfg, cfg.engine),
        "gf": GroupFeatNetwork(group),
        "rd": RotationDetector(group),
        "et": EquivariantTransformer(group),
    }
    if cfg.use_rm:
        nets["rm"] = RotationCoherenceMatcher(
            group, coor_norm_step=cfg.coor_norm_step, sinkhorn_iters=cfg.sinkhorn_iters,
            row_block=rm_row_block(cfg),
        )
    return nets


def _leaves(module: nn.Module) -> Iterator[tuple[torch.Tensor, tuple[str, ...], bool]]:
    """(tensor, JAX path, transposed) for every parameter and buffer that
    the JAX variables hold."""
    for name, m in module.named_modules():
        path = tuple(name.split(".")) if name else ()
        if isinstance(m, nn.Linear):
            yield m.weight, ("params",) + path + ("kernel",), True
            if m.bias is not None:
                yield m.bias, ("params",) + path + ("bias",), False
        elif isinstance(m, BatchNorm):
            yield m.weight, ("params",) + path + ("scale",), False
            yield m.bias, ("params",) + path + ("bias",), False
            yield m.running_mean, ("batch_stats",) + path + ("mean",), False
            yield m.running_var, ("batch_stats",) + path + ("var",), False
        elif isinstance(m, MaskedInstanceNorm):
            yield m.weight, ("params",) + path + ("scale",), False
            yield m.bias, ("params",) + path + ("bias",), False
        elif "kernel" in m._parameters:
            yield m.kernel, ("params",) + path + ("kernel",), False
        elif "bin_score" in m._parameters:
            yield m.bin_score, ("params",) + path + ("bin_score",), False


def flatten_variables(tree: dict, prefix: tuple[str, ...] = ()) -> dict[str, np.ndarray]:
    """Nested dict -> {"a/b/c": array}."""
    out: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_variables(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def unflatten_variables(flat: dict[str, Any]) -> dict:
    """{"a/b/c": array} -> nested dict."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


@torch.no_grad()
def load_variables(module: nn.Module, variables: dict) -> None:
    """Copy JAX variables into ``module``; raises on a missing, extra or
    mis-shaped leaf."""
    flat = flatten_variables(variables)
    used = set()
    for t, path, transposed in _leaves(module):
        key = "/".join(path)
        if key not in flat:
            raise KeyError(f"variables lack {key}")
        a = flat[key].T if transposed else flat[key]
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{key}: variables {a.shape} vs module {tuple(t.shape)}")
        t.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))
        used.add(key)
    extra = sorted(set(flat) - used)
    if extra:
        raise KeyError(f"variables hold leaves the module has no place for: {extra}")


def export_variables(module: nn.Module) -> dict:
    """The module's parameters and statistics in the JAX layout."""
    flat = {}
    for t, path, transposed in _leaves(module):
        a = t.detach().cpu().numpy()
        flat["/".join(path)] = np.array(a.T if transposed else a, order="C")
    return unflatten_variables(flat)


def _truncated_normal(rng: np.random.Generator, shape, std: float) -> np.ndarray:
    """N(0, std^2) truncated at +-2 std, with flax's variance correction."""
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2
    return (x * std / 0.87962566103423978).astype(np.float32)


def _init_module(net: nn.Module, rng: np.random.Generator) -> dict:
    """Random variables of one network in the JAX layout (see
    :func:`init_variables`)."""
    dense_paths = {
        ("params",) + tuple(n.split(".")) + ("kernel",)
        for n, m in net.named_modules()
        if isinstance(m, nn.Linear) and not isinstance(m, GroupConv)
    }
    flat = {}
    for t, path, transposed in _leaves(net):
        shape = tuple(t.shape[::-1]) if transposed else tuple(t.shape)
        leaf = path[-1]
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            scale = 1.0 if path in dense_paths else 2.0
            a = _truncated_normal(rng, shape, np.sqrt(scale / fan_in))
        elif leaf in ("scale", "var"):
            a = np.ones(shape, np.float32)
        elif leaf == "bin_score":  # the module's init_bin_score
            a = t.detach().numpy().astype(np.float32)
        else:
            a = np.zeros(shape, np.float32)
        flat["/".join(path)] = a
    return unflatten_variables(flat)


def init_variables(cfg: PipelineConfig, seed: int = 0) -> dict[str, dict]:
    """Random variables for the pipeline's networks, drawn with numpy from
    ``seed`` at the JAX package's initialiser scales: fan-in truncated
    normals (scale 2 for sparse and group convs, 1 for dense layers), zero
    biases, unit norms and statistics, and RM's dustbin score at its
    initial 0.2."""
    rng = np.random.default_rng(seed)
    return {name: _init_module(net, rng) for name, net in build_modules(cfg).items()}


def init_module_variables(net: nn.Module, seed: int = 0) -> dict:
    """:func:`init_variables`' draws for one network (a head to train)."""
    return _init_module(net, np.random.default_rng(seed))


def _check_tag(path: str, cfg: PipelineConfig) -> None:
    """Raise ``ValueError`` when the set's ``config_tag.json`` names another
    configuration than ``cfg`` (small against full, voxel size or group
    size): parameter shapes do not depend on them, so such a set would load
    silently and skew every number."""
    from roreg_tpu_torch.pipeline.quality_config import quality_small_config

    with open(os.path.join(path, "config_tag.json")) as f:
        tag = json.load(f)
    small = cfg.voxel_size == quality_small_config(cfg.group_size).voxel_size
    have = {"small": small, "voxel_size": cfg.voxel_size, "group_size": cfg.group_size}
    bad = {k: (tag[k], v) for k, v in have.items() if k in tag and tag[k] != v}
    if bad:
        raise ValueError(f"checkpoint config mismatch in {path}: (tag, config) {bad}")


def _read_npz(fn: str) -> dict:
    with np.load(fn) as z:
        return unflatten_variables({k: z[k] for k in z.files})


def load_checkpoint_dir(path: str, cfg: PipelineConfig) -> dict[str, dict]:
    """A converted checkpoint set -> ``{component: nested numpy variables}``
    for all five networks. Raises ``ValueError`` when the set's
    ``config_tag.json`` names another configuration than ``cfg``."""
    _check_tag(path, cfg)
    missing = [c for c in CHECKPOINT_COMPONENTS if not os.path.exists(os.path.join(path, f"{c}.npz"))]
    if missing:
        raise FileNotFoundError(f"{path} lacks {missing}")
    return {comp: _read_npz(os.path.join(path, f"{comp}.npz")) for comp in CHECKPOINT_COMPONENTS}


def load_components(
    path: str, cfg: PipelineConfig, variables: dict[str, dict],
    components: tuple[str, ...] = CHECKPOINT_COMPONENTS,
) -> list[str]:
    """Replace in ``variables`` each of ``components`` that ``variables``
    holds and whose ``<comp>.npz`` lies in ``path``; the others keep their
    values (the counterpart of the JAX package's
    ``load_pipeline_variables``). Each loaded set must have the shapes of
    the entry it replaces, and the set's ``config_tag.json``, where there
    is one, must name ``cfg``'s configuration. Returns the loaded names."""
    if os.path.exists(os.path.join(path, "config_tag.json")):
        _check_tag(path, cfg)
    loaded = []
    for comp in components:
        fn = os.path.join(path, f"{comp}.npz")
        if comp not in variables or not os.path.exists(fn):
            continue
        new = _read_npz(fn)
        want = {k: v.shape for k, v in flatten_variables(variables[comp]).items()}
        got = {k: v.shape for k, v in flatten_variables(new).items()}
        if got != want:
            bad = sorted(k for k in set(want) | set(got) if want.get(k) != got.get(k))
            raise ValueError(f"{fn}: shapes differ from the configuration's at {bad[:5]}")
        variables[comp] = new
        loaded.append(comp)
    return loaded
