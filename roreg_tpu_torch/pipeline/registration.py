"""End-to-end pair registration: extract -> describe -> detect -> match ->
estimate, on the compute device.

Counterpart of ``roreg_tpu/pipeline/registration.py`` (``gf_apply``,
``rd_apply``, ``rm_apply``, ``et_apply``, ``describe_tail`` and
``RegistrationPipeline``):
the RM matcher with its top-match selection (``use_rm=True``, the
default) or mutual nearest neighbours of group-mean descriptors
(``use_rm=False``), then the ET residual quaternions and yohoo RANSAC, or
yohoc RANSAC (``estimator="yohoc"``). ``RegistrationPipeline.batched_pair_stage``
(match and estimate on B pairs of sampled keypoint sets, a leading pair
axis on every tensor) is the one code path of every entry point:
``pair_stage`` is its B = 1 case, which ``register_pair`` (two clouds) and
``register_pair_from_descriptors`` (two clouds' stored descriptors) run,
and ``dist.eval.pair_batch_from_stacks`` runs it for the evaluator and the
bench.
Side convention as in the reference: gt satisfies ``pts0 = R @ pts1 + t``,
and RM and ET take cloud 1 as their source.

The describe runs the block engine (``engine="block"``, the default) or
the gather engine (``engine="gather"``).

Random draws are inputs: ``perm`` (yohoo's hypothesis order), ``buckets``
and ``gumbel`` (yohoc's group indices and triple noise) and, with
``use_rd=False``, ``noise0``/``noise1`` (the keypoint sampling
priorities). When they are not given they are drawn from ``generator``, on
its device (yohoo's ``perm`` as the argsort of uniform draws, one row a
pair).
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from roreg_tpu_torch.core.group import get_group
from roreg_tpu_torch.device import resolve_device
from roreg_tpu_torch.models.et import EquivariantTransformer
from roreg_tpu_torch.models.gf import GroupFeatNetwork
from roreg_tpu_torch.models.rd import RotationDetector
from roreg_tpu_torch.models.rm import RotationCoherenceMatcher
from roreg_tpu_torch.pipeline import estimator as est
from roreg_tpu_torch.pipeline.config import PipelineConfig, check_supported
from roreg_tpu_torch.pipeline.extractor import extract
from roreg_tpu_torch.pipeline.matcher import (
    mutual_match,
    nms_sample,
    rank_normalize,
    top_k_indices,
    top_match_subset,
)
from roreg_tpu_torch.weights import build_modules, load_variables

__all__ = [
    "RegistrationPipeline", "gf_apply", "rd_apply", "rm_apply", "et_apply", "sample_keypoints", "describe_tail",
]


def _draw_device(generator: torch.Generator | None) -> torch.device:
    """Where draws from ``generator`` are made (the CPU's default generator
    when there is none)."""
    return generator.device if generator is not None else torch.device("cpu")


def _chunks(n: int, bs: int):
    bs = max(1, min(bs, n))
    return [(i, min(i + bs, n)) for i in range(0, n, bs)]


def gf_apply(gf: GroupFeatNetwork, group_feats: torch.Tensor, cfg: PipelineConfig) -> torch.Tensor:
    """(K, G, 32) backbone group feats -> (K, G, 32) eqv descriptors, in
    ``bs_gf`` batches."""
    k = group_feats.shape[0]
    return torch.cat([gf(group_feats[a:b])["eqv"] for a, b in _chunks(k, cfg.bs_gf)])


def rd_apply(rd: RotationDetector, eqv: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Saliency scores, rank-normalised to [0, 1)."""
    return rank_normalize(rd(eqv), mask)


def rm_apply(
    rm: RotationCoherenceMatcher, eqv0: torch.Tensor, eqv1: torch.Tensor,
    keys0: torch.Tensor, keys1: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The RM matcher on sampled keypoint sets (B, M, G, 32) and keys
    (B, M, 3), each pair with its own masks, with the reference's side swap
    (source = cloud 1). Returns matches (B, M, 2) [index into sample 0,
    index into sample 1], their validity (B, M) and their Sinkhorn matching
    scores (B, M)."""
    b, m = eqv1.shape[:2]
    out = rm(
        eqv1, eqv0, keys1, keys0,
        torch.ones((b, m), dtype=torch.bool, device=eqv1.device),
        torch.ones((b, eqv0.shape[1]), dtype=torch.bool, device=eqv0.device),
    )
    matches0 = out["matches0"]  # index into sample 0, -1 where invalid
    valid = matches0 >= 0
    ids = torch.arange(m, device=eqv1.device).expand(b, m)
    pair = torch.stack([torch.where(valid, matches0, 0), ids], -1)
    return pair, valid, out["matching_scores0"]


def et_apply(
    et: EquivariantTransformer, bb0_m, bb1_m, gf0_m, gf1_m, idx, cfg: PipelineConfig
) -> torch.Tensor:
    """Residual quaternions (..., 4) of matched pairs (..., G, 32), with the
    reference's side exchange (before0 = cloud-1 features). Leading axes
    are folded into one axis of rows, which run in ``bs_et`` batches."""
    lead = idx.shape
    rows = [x.reshape(-1, *x.shape[-2:]) for x in (bb1_m, bb0_m, gf1_m, gf0_m)]
    idx = idx.reshape(-1)
    q = torch.cat([et(*(x[a:b] for x in rows), idx[a:b]) for a, b in _chunks(idx.shape[0], cfg.bs_et)])
    return q.reshape(*lead, 4)


def sample_keypoints(
    keys: torch.Tensor, det_scores, kp_mask: torch.Tensor, cfg: PipelineConfig,
    noise=None, generator: torch.Generator | None = None,
) -> torch.Tensor:
    """``keynum`` keypoint indices: NMS on the detector scores, or with
    ``use_rd=False`` the top ``noise`` priorities (uniform draws from
    ``generator`` when not given) among the masked-in keypoints. Without
    RD, ``noise`` may carry leading axes (one draw per row), and so does the
    result."""
    if cfg.use_rd:
        return nms_sample(keys, det_scores, kp_mask, cfg.keynum, cfg.nms_k)
    if noise is None:
        noise = torch.rand(keys.shape[0], generator=generator, device=_draw_device(generator))
    noise = torch.as_tensor(noise, dtype=torch.float32).to(keys.device)
    prio = torch.where(kp_mask, noise, torch.full_like(noise, -1.0))
    return top_k_indices(prio, cfg.keynum)


def describe_tail(
    nets: dict, bb: torch.Tensor, keypoints: torch.Tensor, cfg: PipelineConfig,
    noise=None, generator: torch.Generator | None = None,
):
    """Backbone group feats (K, G, 32) of one cloud -> the sampled triple
    ``(bb_s, gf_s, kp_s)`` (``keynum`` rows each): GF, then RD and NMS (or,
    with ``use_rd=False``, the top ``keynum`` of ``noise``), then the three
    gathers."""
    gf = gf_apply(nets["gf"], bb, cfg)
    ones = torch.ones(keypoints.shape[0], dtype=torch.bool, device=keypoints.device)
    det = rd_apply(nets["rd"], gf, ones) if cfg.use_rd else None
    s = sample_keypoints(keypoints, det, ones, cfg, noise, generator)
    return bb[s], gf[s], keypoints[s]


def _pair_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, M, ...) at rows idx (B, M') -> (B, M', ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


class RegistrationPipeline:
    """Holds the networks of the ported slice and registers scan pairs.

    ``variables``: the JAX package's variables as nested dicts of numpy
    arrays, with keys ``backbone``, ``gf``, ``rd``, ``et`` and, with
    ``use_rm=True``, ``rm`` (others are ignored). ``device``: CUDA unless
    ``"cpu"`` is passed.
    """

    def __init__(self, cfg: PipelineConfig, variables: dict[str, Any], device=None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        group = get_group(cfg.group_size)
        self.cayley = torch.as_tensor(group.cayley, dtype=torch.long, device=self.device)
        self.rotations = torch.as_tensor(group.rotations, dtype=torch.float32, device=self.device)
        self.nets = build_modules(cfg)
        for name, net in self.nets.items():
            load_variables(net, variables[name])
            net.to(self.device).eval()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _host(self, x) -> np.ndarray:
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device)

    # ---- stages ----

    @torch.inference_mode()
    def extract(self, points, point_mask, keypoints, timings=None, dropped=None) -> torch.Tensor:
        """Cloud -> (K, G, 32) backbone group features. On the block engine
        the cloud's dropped block count is appended to ``dropped`` (a list)
        when one is given."""
        return extract(self.nets["backbone"], points, point_mask, keypoints, self.cfg, self.device,
                       timings, dropped)

    @torch.inference_mode()
    def describe(self, points, point_mask, keypoints):
        """Cloud -> (backbone group features, GF eqv descriptors), both
        (K, G, 32)."""
        bb = self.extract(points, point_mask, keypoints)
        return bb, gf_apply(self.nets["gf"], bb, self.cfg)

    @torch.inference_mode()
    def detect(self, gf_eqv: torch.Tensor, kp_mask: torch.Tensor) -> torch.Tensor:
        return rd_apply(self.nets["rd"], gf_eqv, kp_mask)

    @torch.inference_mode()
    def sample_keypoints(self, keys, det_scores, kp_mask, noise=None, generator=None):
        """:func:`sample_keypoints` under this pipeline's config."""
        return sample_keypoints(keys, det_scores, kp_mask, self.cfg, noise, generator)

    @torch.inference_mode()
    def describe_tail(self, bb, keypoints, noise=None, generator=None):
        """:func:`describe_tail` with this pipeline's networks; ``keypoints``
        may be a host array."""
        return describe_tail(self.nets, bb, self._tensor(keypoints), self.cfg, noise, generator)

    @torch.inference_mode()
    def batched_pair_stage(
        self, bb0_s, bb1_s, gf0_s, gf1_s, k0_s, k1_s, *, perm=None, buckets=None, gumbel=None,
        generator: torch.Generator | None = None,
    ) -> dict[str, torch.Tensor]:
        """Match and estimate on B pairs of sampled keypoint sets at once:
        descriptors (B, keynum, G, 32), keys (B, keynum, 3). Each pair keeps
        its own masks, draws and tie orders, so row b equals the one-pair stage
        of pair b (up to the order of f32 sums). The draws (``perm`` (B, M)
        for yohoo, ``buckets`` (B, max_iter) and ``gumbel`` (B, max_iter, M)
        for yohoc) are drawn from ``generator`` when not given.

        Returns ``transform`` (B, 4, 4), ``overlap`` (B,), ``winner`` (B,) (the
        winning hypothesis: a match for yohoo, an iteration for yohoc), ``m0``
        and ``m1`` (B, M) (each match's rows in the two sets), ``match_valid``,
        ``match_scores``, ``est_valid`` and ``dr_index`` (B, M)."""
        cfg = self.cfg
        b, m = gf1_s.shape[:2]
        dev = self.device
        if cfg.use_rm:
            pair, mvalid, mscores = rm_apply(self.nets["rm"], gf0_s, gf1_s, k0_s, k1_s)
            m0, m1 = pair[..., 0], pair[..., 1]
            est_valid = top_match_subset(mscores, mvalid, cfg.match_n)
        else:
            ones = torch.ones((b, m), dtype=torch.bool, device=dev)
            nn01, mvalid = mutual_match(gf0_s, gf1_s, ones, ones)
            m0, m1 = torch.arange(m, device=dev).expand(b, m), nn01
            mscores = torch.ones((b, m), device=dev)
            est_valid = mvalid
        keys_m0, keys_m1 = _pair_rows(k0_s, m0), _pair_rows(k1_s, m1)
        gf0_m, gf1_m = _pair_rows(gf0_s, m0), _pair_rows(gf1_s, m1)
        dr = est.dr_index(gf0_m, gf1_m, self.cayley)
        if cfg.estimator == "yohoo":
            quats = et_apply(self.nets["et"], _pair_rows(bb0_s, m0), _pair_rows(bb1_s, m1), gf0_m, gf1_m, dr, cfg)
            T_hyp = est.local_transforms(quats, dr, keys_m0, keys_m1, self.rotations)
            if perm is None:  # a uniform permutation per pair
                perm = torch.argsort(torch.rand((b, m), generator=generator, device=_draw_device(generator)), -1)
            T, overlap, winner = est.yohoo_ransac(
                self._tensor(perm, torch.long), T_hyp, est_valid, keys_m0, keys_m1, mscores, est_valid, cfg.ransac_ird, cfg.max_iter,
            )
        else:
            if buckets is None or gumbel is None:
                buckets, gumbel = est.yohoc_draws(dr, est_valid, cfg.max_iter, cfg.group_size, generator)
            T, overlap, winner = est.yohoc_ransac(
                self._tensor(buckets, torch.long), self._tensor(gumbel), dr, keys_m0, keys_m1,
                mscores, est_valid, cfg.ransac_ird, cfg.group_size,
            )
        return {
            "transform": T,
            "overlap": overlap,
            "winner": winner,
            "m0": m0,
            "m1": m1,
            "match_valid": mvalid,
            "match_scores": mscores,
            "est_valid": est_valid,
            "dr_index": dr,
        }

    @torch.inference_mode()
    def pair_stage(
        self,
        bb0_s, bb1_s, gf0_s, gf1_s, k0_s, k1_s,
        *,
        perm=None,
        buckets=None,
        gumbel=None,
        generator: torch.Generator | None = None,
    ) -> dict[str, torch.Tensor]:
        """Match and estimate on one pair of sampled keypoint sets
        (``keynum`` rows each): the B = 1 case of :meth:`batched_pair_stage`.
        RM with its top-match selection or mutual NN, the group index of
        each match, then ET and yohoo or yohoc. The draws (``perm`` (M,) for
        yohoo, ``buckets`` (max_iter,) and ``gumbel`` (max_iter, M) for
        yohoc) are drawn from ``generator`` when not given.

        Returns ``transform``, ``overlap``, ``winner`` (the winning
        hypothesis: a match for yohoo, an iteration for yohoc), ``m0`` and
        ``m1`` (each match's rows in the two sets), ``match_valid``,
        ``match_scores``, ``est_valid`` and ``dr_index``."""
        one = lambda x: None if x is None else torch.as_tensor(x)[None]  # noqa: E731
        out = self.batched_pair_stage(
            *(x[None] for x in (bb0_s, bb1_s, gf0_s, gf1_s, k0_s, k1_s)),
            perm=one(perm), buckets=one(buckets), gumbel=one(gumbel), generator=generator,
        )
        return {k: v[0] for k, v in out.items()}

    @torch.inference_mode()
    def register_pair_from_descriptors(
        self,
        bb0, gf0, det0, kp0,
        bb1, gf1, det1, kp1,
        *,
        noise0=None,
        noise1=None,
        perm=None,
        buckets=None,
        gumbel=None,
        generator: torch.Generator | None = None,
    ) -> dict[str, torch.Tensor]:
        """From each cloud's full descriptors (``bb``, ``gf`` (K, G, 32),
        ``det`` (K,) or None without RD, keypoints ``kp`` (K, 3)) to the
        transform: keypoint sampling (NMS, or with ``use_rd=False`` the top
        ``noise`` priorities), then :meth:`pair_stage`. Adds ``sample0`` and
        ``sample1`` to its outputs."""
        kp0, kp1 = self._tensor(kp0), self._tensor(kp1)
        s = [
            self.sample_keypoints(
                kp, det, torch.ones(kp.shape[0], dtype=torch.bool, device=self.device), noise, generator
            )
            for kp, det, noise in ((kp0, det0, noise0), (kp1, det1, noise1))
        ]
        out = self.pair_stage(
            bb0[s[0]], bb1[s[1]], gf0[s[0]], gf1[s[1]], kp0[s[0]], kp1[s[1]],
            perm=perm, buckets=buckets, gumbel=gumbel, generator=generator,
        )
        out["sample0"], out["sample1"] = s
        return out

    @torch.inference_mode()
    def register_pair(
        self,
        points0, mask0, keys0,
        points1, mask1, keys1,
        kp_mask0=None, kp_mask1=None,
        *,
        perm=None,
        noise0=None,
        noise1=None,
        buckets=None,
        gumbel=None,
        generator: torch.Generator | None = None,
        timings: dict[str, float] | None = None,
    ) -> dict[str, torch.Tensor]:
        """Full pipeline on one scan pair; returns the transform and
        diagnostics. Host arrays in, device tensors out. With ``timings``,
        the seconds of each stage are written into it (the device is
        synchronised at each stage boundary), and ``host_wait`` holds the
        seconds describe waited for host pyramid builds. On the block
        engine, ``dropped_blocks`` holds each cloud's dropped block count
        (capacity overflow)."""
        cfg = self.cfg
        clock = [time.perf_counter()]

        def lap(name: str) -> None:
            if timings is not None:
                self._sync()
                now = time.perf_counter()
                timings[name] = now - clock[0]
                clock[0] = now

        k0 = self._tensor(keys0)
        k1 = self._tensor(keys1)
        ones0 = torch.ones(k0.shape[0], dtype=torch.bool, device=self.device)
        ones1 = torch.ones(k1.shape[0], dtype=torch.bool, device=self.device)
        kp_mask0 = ones0 if kp_mask0 is None else self._tensor(kp_mask0, torch.bool)
        kp_mask1 = ones1 if kp_mask1 is None else self._tensor(kp_mask1, torch.bool)

        dropped: list[int] = []
        bb0 = self.extract(points0, mask0, keys0, timings, dropped)
        lap("describe0")
        bb1 = self.extract(points1, mask1, keys1, timings, dropped)
        lap("describe1")

        gf0 = gf_apply(self.nets["gf"], bb0, cfg)
        gf1 = gf_apply(self.nets["gf"], bb1, cfg)
        det0 = self.detect(gf0, kp_mask0) if cfg.use_rd else None
        det1 = self.detect(gf1, kp_mask1) if cfg.use_rd else None
        s0 = self.sample_keypoints(k0, det0, kp_mask0, noise0, generator)
        s1 = self.sample_keypoints(k1, det1, kp_mask1, noise1, generator)
        lap("gf_rd_nms")

        out = self.pair_stage(
            bb0[s0], bb1[s1], gf0[s0], gf1[s1], k0[s0], k1[s1],
            perm=perm, buckets=buckets, gumbel=gumbel, generator=generator,
        )
        lap("match_et_ransac")
        out["matches"] = torch.stack([s0[out.pop("m0")], s1[out.pop("m1")]], -1)
        out.update(sample0=s0, sample1=s1, bb0=bb0, gf0=gf0)
        if dropped:
            out["dropped_blocks"] = torch.tensor(dropped, device=self.device)
        return out
