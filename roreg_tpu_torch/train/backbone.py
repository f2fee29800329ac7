"""FCGF backbone training: hardest-contrastive metric learning.

Counterpart of ``roreg_tpu/train/backbone.py``. A step runs two forwards
of the backbone (``pipeline.extractor.make_backbone``) in training mode,
cloud 0 then cloud 1, each normalising with its own masked batch
statistics and moving the running statistics after it; the
hardest-contrastive loss over the mutual-NN voxel correspondences of the
pair; one backward and one update. On a GPU every gather conv runs its
kernel forward and its two backward kernels (``kernels.gather_conv``
``GatherConvFn``), on the CPU their plain versions.

Optimizers as the reference's: SGD with momentum 0.8 (no Nesterov) at
``lr * 0.99 ** (step / 1000)``, or Adam (betas 0.9 / 0.999, epsilon 1e-8)
at ``lr * 0.97 ** (step / 1000)``; the rate is read from the update count
before each update, as optax's schedules are.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from roreg_tpu_torch.data.synthetic import _random_rotation
from roreg_tpu_torch.device import resolve_device
from roreg_tpu_torch.native.lib import voxel_nn_host, voxelize_host
from roreg_tpu_torch.native.pyramid import alloc_pyramid_buffers, fill_pyramid_host
from roreg_tpu_torch.pipeline.config import PipelineConfig
from roreg_tpu_torch.pipeline.extractor import make_backbone, upload_pyramid
from roreg_tpu_torch.train.trainer import TrainState
from roreg_tpu_torch.weights import init_module_variables, load_variables

__all__ = ["hardest_contrastive_loss", "make_backbone_train_step", "backbone_pair_batches",
           "backbone_learning_rate"]

_BIG = 1e9
# (decay rate per 1000 steps) of each optimizer's exponential schedule
_DECAY = {"sgd": 0.99, "adam": 0.97}


def hardest_contrastive_loss(
    f0: torch.Tensor,
    f1: torch.Tensor,
    pair_mask: torch.Tensor,
    pos_margin: float = 0.1,
    neg_margin: float = 1.4,
    pos0: torch.Tensor | None = None,
    pos1: torch.Tensor | None = None,
    safe_radius: float = 0.0,
) -> tuple[torch.Tensor, dict]:
    """FCGF's hardest-contrastive loss on matched feature rows f0, f1 (P, C)
    with a validity mask (P,). Positives: the matched rows, hinged at
    ``pos_margin``. Negatives: for each anchor, the nearest row of the
    other side among the valid pairs, excluding itself and, with ``pos0``
    and ``pos1`` (P, 3) in a common frame, every candidate within
    ``safe_radius`` of the anchor; hinged at ``neg_margin``. An anchor
    without any candidate gets the distance 1e9 (no loss). Returns the
    loss and ``pos_loss``, ``neg_loss``, ``pos_dist``, ``neg_dist``."""
    d2 = ((f0[:, None, :] - f1[None, :, :]) ** 2).sum(-1)
    d = torch.sqrt(d2.clamp_min(1e-12))
    p = d.shape[0]
    eye = torch.eye(p, dtype=torch.bool, device=d.device)
    valid = pair_mask[:, None] & pair_mask[None, :]
    if pos0 is not None and safe_radius > 0.0:
        sp2 = ((pos0[:, None, :] - pos1[None, :, :]) ** 2).sum(-1)
        valid = valid & (sp2 > safe_radius * safe_radius)
    zero = torch.zeros((), dtype=d.dtype, device=d.device)

    pos = torch.diagonal(d)
    denom = pair_mask.sum().clamp_min(1).to(d.dtype)
    pos_loss = torch.where(pair_mask, (pos - pos_margin).clamp_min(0.0) ** 2, zero).sum() / denom

    neg_d = torch.where(valid & ~eye, d, torch.full((), _BIG, dtype=d.dtype, device=d.device))
    # amin splits the gradient evenly between ties, as jnp.min does: no tie order
    hard0 = torch.amin(neg_d, dim=1)  # hardest f1 for each f0
    hard1 = torch.amin(neg_d, dim=0)
    neg0 = torch.where(pair_mask, (neg_margin - hard0).clamp_min(0.0) ** 2, zero)
    neg1 = torch.where(pair_mask, (neg_margin - hard1).clamp_min(0.0) ** 2, zero)
    neg_loss = 0.5 * (neg0.sum() + neg1.sum()) / denom
    return pos_loss + neg_loss, {
        "pos_loss": pos_loss,
        "neg_loss": neg_loss,
        "pos_dist": torch.where(pair_mask, pos, zero).sum() / denom,
        "neg_dist": torch.where(pair_mask, hard0, zero).sum() / denom,
    }


def backbone_learning_rate(lr: float, optimizer: str, count: int) -> float:
    """``optax.exponential_decay(lr, 1000, rate)`` at update ``count`` (no
    staircase), with the optimizer's rate."""
    return lr * _DECAY[optimizer] ** (count / 1000)


def make_backbone_train_step(cfg: PipelineConfig, lr: float = 1e-1, optimizer: str = "sgd", device=None):
    """Returns ``(init_fn, step_fn)`` for FCGF training of ``cfg``'s backbone:

    * ``init_fn(variables=None, seed=0) -> TrainState``: the backbone from
      ``variables`` (its ``params`` and ``batch_stats``, nested numpy in
      the JAX layout) or from the port's numpy initialiser at ``seed``;
    * ``step_fn(state, batch) -> metrics``: one update of ``state`` in
      place; ``batch`` is one of :func:`backbone_pair_batches`' dicts;
      metrics are detached tensors (``loss`` and the four parts).

    ``optimizer``: "sgd" (FCGF's recipe) or "adam". Runs on CUDA unless
    ``device="cpu"``, at ``cfg.backbone_compute_dtype`` (bf16, or f32 with
    None) on either."""
    if optimizer not in _DECAY:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    dev = resolve_device(device)

    def init_fn(variables: dict | None = None, seed: int = 0) -> TrainState:
        net = make_backbone(cfg)
        if not any(n.endswith("running_mean") for n, _ in net.named_buffers()):
            raise ValueError(
                f"backbone {cfg.backbone_variant!r} has no batch statistics, and the reference's "
                "backbone train step reads them (its init fails there too)")
        load_variables(net, variables if variables is not None else init_module_variables(net, seed))
        net.to(dev).train()
        if optimizer == "adam":
            opt = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
        else:
            opt = torch.optim.SGD(net.parameters(), lr=lr, momentum=0.8, nesterov=False)
        return TrainState(net, opt, 0, cfg.group_size)

    def step_fn(state: TrainState, batch: dict) -> dict:
        t = {k: torch.as_tensor(np.asarray(batch[k])).to(dev)
             for k in ("pairs", "pair_mask", "pos0", "pos1")}
        pyr0, pyr1 = upload_pyramid(batch["pyr0"], dev), upload_pyramid(batch["pyr1"], dev)
        for g in state.optimizer.param_groups:
            g["lr"] = backbone_learning_rate(lr, optimizer, state.step)
        state.optimizer.zero_grad(set_to_none=True)
        state.net.train()
        out0 = state.net(pyr0)
        out1 = state.net(pyr1)
        pairs = t["pairs"].long()
        loss, aux = hardest_contrastive_loss(
            out0[pairs[:, 0]], out1[pairs[:, 1]], t["pair_mask"],
            pos0=t["pos0"], pos1=t["pos1"], safe_radius=2.0 * cfg.voxel_size,
        )
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}

    return init_fn, step_fn


def _host_pyramid(points: np.ndarray, cfg: PipelineConfig):
    pyr = alloc_pyramid_buffers(cfg.capacities, cfg.conv1_kernel_size)
    fill_pyramid_host(points, cfg.voxel_size, pyr, conv1_kernel_size=cfg.conv1_kernel_size)
    return pyr


def _mutual_nn(a: np.ndarray, b: np.ndarray, radius: float) -> np.ndarray:
    """Mutual nearest neighbours within ``radius`` by the native 27-cell
    voxel search: (P, 2) int32 rows [index in a, index in b]."""
    tv_b, _, vc_b = voxelize_host(b, radius)
    nn_ab = voxel_nn_host(b, tv_b, vc_b, radius, a, radius)
    tv_a, _, vc_a = voxelize_host(a, radius)
    nn_ba = voxel_nn_host(a, tv_a, vc_a, radius, b, radius)
    ia = np.where(nn_ab >= 0)[0]
    mutual = nn_ba[nn_ab[ia]] == ia
    return np.stack([ia[mutual], nn_ab[ia][mutual]], -1).astype(np.int32)


def backbone_pair_batches(
    scenes, cfg: PipelineConfig, rng: np.random.Generator, max_pairs: int = 1024,
    match_dist: float | None = None,
) -> Iterator[dict]:
    """Fragment-pair batches, the reference's draws from ``rng`` in its
    order: a pair of a scene, a joint orientation R (cloud 0 at R, cloud 1
    at R @ R_gt, so that corresponding patches share their orientation),
    the two host pyramids, the mutual-NN voxel representative points under
    gt within ``match_dist`` (default the voxel size; a pair with fewer
    than 32 is drawn again), and a random subset of at most ``max_pairs``.
    Yields numpy: ``pyr0``, ``pyr1`` (host SparsePyramids), ``pairs``
    (max_pairs, 2) int32 level-0 rows [i0, i1] (zero past the valid
    ones), ``pair_mask`` (max_pairs,), ``pos0``, ``pos1`` (max_pairs, 3)
    f32 positions of the paired voxels in cloud 0's frame."""
    match_dist = match_dist or cfg.voxel_size
    pair_list = [(ds, p) for ds in scenes for p in ds.pair_ids]
    while True:
        ds, (id0, id1) = pair_list[rng.integers(len(pair_list))]
        T = ds.get_transform(id0, id1)
        pc0 = ds.get_pc(id0).astype(np.float32)
        pc1 = ds.get_pc(id1).astype(np.float32)
        R0 = _random_rotation(rng).astype(np.float32)
        R1 = (R0 @ T[:3, :3]).astype(np.float32)
        pyr0 = _host_pyramid(pc0 @ R0.T, cfg)
        pyr1 = _host_pyramid(pc1 @ R1.T, cfg)
        n0, n1 = int(pyr0.grid.num_voxels), int(pyr1.grid.num_voxels)
        rep0 = np.asarray(pyr0.grid.rep_point)[:n0] @ R0  # back to world
        rep1 = np.asarray(pyr1.grid.rep_point)[:n1] @ R1
        rep1_in0 = (rep1 @ T[:3, :3].T + T[:3, 3]).astype(np.float32)  # cloud 0's frame
        pairs = _mutual_nn(rep1_in0, rep0, match_dist)  # (P, 2) [i1, i0]
        if len(pairs) < 32:
            continue
        pairs = pairs[rng.permutation(len(pairs))[:max_pairs]]
        n = len(pairs)
        pair_arr = np.concatenate([pairs[:, ::-1], np.zeros((max_pairs - n, 2), np.int32)], 0)
        p0 = np.zeros((max_pairs, 3), np.float32)
        p1 = np.zeros((max_pairs, 3), np.float32)
        p0[:n] = rep0[pair_arr[:n, 0]]
        p1[:n] = rep1_in0[pair_arr[:n, 1]]
        yield {"pyr0": pyr0, "pyr1": pyr1, "pairs": pair_arr.astype(np.int32),
               "pair_mask": np.arange(max_pairs) < n, "pos0": p0, "pos1": p1}
