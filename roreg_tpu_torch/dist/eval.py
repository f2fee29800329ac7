"""Pair-batched evaluation on one device.

Counterpart of ``roreg_tpu/dist/eval.py``: ``batched_pair_stage`` runs the
match-and-estimate stage on B pairs at once (a leading pair axis on every
tensor), and ``pair_batch_from_stacks`` gathers each pair's two clouds from
per-cloud descriptor stacks that stay on the device, inside the call. The
reference vmaps its one-pair stage; the port carries explicit batched
tensors through RM, mutual matching, ET and both RANSACs
(``pipeline.registration.batched_pair_stage``).

The reference folds ``(p0, p1, side)`` into a JAX key for the per-pair
keypoint draws of ``per_pair_sample``; torch cannot reproduce threefry, so
here the sampling noise is an input of shape (B, 2, K), one row per (pair,
side), drawn by the caller (the evaluator draws it from its generator in a
fixed order) or from ``generator``. Pairs that share a cloud draw
independent subsets either way.

The sharded variants (``eval_pairs_sharded``, ``pair_stacks_sharded``)
split the pair axis over a ``dist.mesh.Mesh``: each rank runs its
contiguous shard of the pairs, with its shard of the draws, and the
results are gathered on every rank in pair order, so with the draws given
they equal the batched stage's.
"""

from __future__ import annotations

import torch

from roreg_tpu_torch.dist.collectives import gather_rows, shard_rows
from roreg_tpu_torch.pipeline.matcher import top_k_indices
from roreg_tpu_torch.pipeline.registration import RegistrationPipeline

__all__ = ["batched_pair_stage", "pair_batch_from_stacks", "eval_pairs_sharded", "pair_stacks_sharded"]


def batched_pair_stage(pipe: RegistrationPipeline, bb0, bb1, gf0, gf1, k0, k1, **draws) -> dict:
    """The pair stage over a leading pair axis: all inputs (B, keynum, ...);
    ``draws`` as :meth:`RegistrationPipeline.batched_pair_stage` takes them
    (``perm``, ``buckets``, ``gumbel``, ``generator``). Returns the stacked
    pair-stage dict (transform (B, 4, 4), overlap (B,), m0/m1, est_valid and
    match_scores (B, M), ...)."""
    return pipe.batched_pair_stage(bb0, bb1, gf0, gf1, k0, k1, **draws)


@torch.inference_mode()
def pair_batch_from_stacks(
    pipe: RegistrationPipeline,
    i0: torch.Tensor,
    i1: torch.Tensor,
    all_bb: torch.Tensor,
    all_gf: torch.Tensor,
    all_kp: torch.Tensor,
    *,
    noise: torch.Tensor | None = None,
    per_pair_sample: bool = False,
    perm=None,
    buckets=None,
    gumbel=None,
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """The pair stage of B pairs whose clouds are rows ``(i0, i1)`` (B,) of
    the device-resident stacks ``all_bb``, ``all_gf`` (C, R, G, 32) and
    ``all_kp`` (C, R, 3). Without ``per_pair_sample`` the stacks hold each
    cloud's sampled set (R = keynum, the deterministic RD + NMS path) and
    rows are used as they are; with it they hold the full descriptors
    (R = K keypoints) and each (pair, side) takes the top ``keynum`` of its
    row of ``noise`` (B, 2, K), drawn from ``generator`` when not given.

    Returns ``transform`` (B, 4, 4), ``overlap`` (B,), the matched keypoint
    coordinates ``keys_m0``/``keys_m1`` (B, M, 3) and ``est_valid`` (B, M):
    everything FMR, IR and RR need."""
    dev = all_kp.device
    i0 = torch.as_tensor(i0).to(device=dev, dtype=torch.long)
    i1 = torch.as_tensor(i1).to(device=dev, dtype=torch.long)
    if per_pair_sample:
        if noise is None:
            draw_dev = generator.device if generator is not None else torch.device("cpu")
            noise = torch.rand((i0.shape[0], 2, all_kp.shape[1]), generator=generator, device=draw_dev)
        s = top_k_indices(torch.as_tensor(noise, dtype=torch.float32).to(dev), pipe.cfg.keynum)
        s0, s1 = s[:, 0], s[:, 1]
        c0, c1 = i0[:, None], i1[:, None]
        sets = [(all_bb[c0, s0], all_gf[c0, s0], all_kp[c0, s0]), (all_bb[c1, s1], all_gf[c1, s1], all_kp[c1, s1])]
    else:
        sets = [(all_bb[i0], all_gf[i0], all_kp[i0]), (all_bb[i1], all_gf[i1], all_kp[i1])]
    (bb0, gf0, k0), (bb1, gf1, k1) = sets
    out = pipe.batched_pair_stage(bb0, bb1, gf0, gf1, k0, k1, perm=perm, buckets=buckets, gumbel=gumbel,
                                  generator=generator)
    b = torch.arange(i0.shape[0], device=dev)[:, None]
    return {
        "transform": out["transform"],
        "overlap": out["overlap"],
        "keys_m0": k0[b, out["m0"]],
        "keys_m1": k1[b, out["m1"]],
        "est_valid": out["est_valid"],
    }


def _shard(mesh, x):
    """This rank's shard of a pair-axis input (None stays None)."""
    if x is None:
        return None
    return shard_rows(torch.as_tensor(x), None)


def _gathered(mesh, out: dict) -> dict:
    """Every rank's pair-axis outputs, in pair order, on every rank."""
    return {k: gather_rows(v.contiguous(), None) for k, v in out.items()}


def _check_pairs(mesh, b: int) -> None:
    if b % mesh.size:
        raise ValueError(f"{b} pairs do not divide among {mesh.size} ranks: pad the pair axis "
                         "(duplicate pairs) to a multiple of the mesh size")


@torch.inference_mode()
def eval_pairs_sharded(mesh, pipe: RegistrationPipeline, bb0, bb1, gf0, gf1, k0, k1, *, perm=None,
                       buckets=None, gumbel=None, generator: torch.Generator | None = None) -> dict:
    """:func:`batched_pair_stage` with the pair axis split over ``mesh``:
    the inputs (B, keynum, ...) and the draws (``perm`` (B, M), ``buckets``
    (B, max_iter), ``gumbel`` (B, max_iter, M)) are cut into the ranks'
    contiguous shards; each rank runs its shard, and every rank gets the
    stacked outputs of all B pairs. B must be a multiple of the mesh size,
    as in the reference. Draws not given are drawn per shard from
    ``generator``, so only given draws reproduce the batched stage."""
    _check_pairs(mesh, bb0.shape[0])
    cut = lambda x: _shard(mesh, x)  # noqa: E731
    out = pipe.batched_pair_stage(*map(cut, (bb0, bb1, gf0, gf1, k0, k1)), perm=cut(perm),
                                  buckets=cut(buckets), gumbel=cut(gumbel), generator=generator)
    return _gathered(mesh, out)


@torch.inference_mode()
def pair_stacks_sharded(mesh, pipe: RegistrationPipeline, i0, i1, all_bb, all_gf, all_kp, *, noise=None,
                        per_pair_sample: bool = False, perm=None, buckets=None, gumbel=None,
                        generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
    """:func:`pair_batch_from_stacks` with the pair axis split over
    ``mesh``: every rank holds the scene's descriptor stacks whole, takes
    its contiguous shard of the pairs ``(i0, i1)`` and of their draws
    (``noise`` (B, 2, K), ``perm``, ``buckets``, ``gumbel``), and every rank
    gets all B pairs' outputs in pair order. B must be a multiple of the
    mesh size."""
    _check_pairs(mesh, len(i0))
    cut = lambda x: _shard(mesh, x)  # noqa: E731
    out = pair_batch_from_stacks(pipe, cut(i0), cut(i1), all_bb, all_gf, all_kp, noise=cut(noise),
                                 per_pair_sample=per_pair_sample, perm=cut(perm), buckets=cut(buckets),
                                 gumbel=cut(gumbel), generator=generator)
    return _gathered(mesh, out)
