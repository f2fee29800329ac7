"""Registration quality metrics: FMR / IR and PointDSC-style RR / RRE / RTE.

A copy of ``roreg_tpu/eval/metrics.py``: host-side numpy on one pair's
small arrays after the device pipeline.
"""

from __future__ import annotations

import numpy as np

__all__ = ["fmr_ir", "registration_errors", "rotation_error_deg"]


def rotation_error_deg(R0: np.ndarray, R1: np.ndarray) -> float:
    tr = float(np.einsum("ij,ij->", R0, R1))
    return float(np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0))))


def fmr_ir(
    keys0_m: np.ndarray,
    keys1_m: np.ndarray,
    valid: np.ndarray,
    T_gt: np.ndarray,
    tau_1: float = 0.05,
    tau_2: float = 0.1,
) -> tuple[float, float]:
    """(FMR indicator, inlier ratio) of one pair's matches under gt: IR is
    the share of kept matches within ``tau_2`` after gt, and the pair counts
    as a feature match when IR > ``tau_1``."""
    valid = valid.astype(bool)
    if valid.sum() == 0:
        return 0.0, 0.0
    k0 = keys0_m[valid]
    k1 = keys1_m[valid]
    k1t = k1 @ T_gt[:3, :3].T + T_gt[:3, 3]
    dist = np.sqrt(np.sum((k0 - k1t) ** 2, axis=-1))
    ir = float(np.mean(dist < tau_2))
    return (1.0 if ir > tau_1 else 0.0), ir


def registration_errors(
    T_pre: np.ndarray, T_gt: np.ndarray
) -> tuple[float, float]:
    """(rotation error in degrees, translation error in metres)."""
    rre = rotation_error_deg(T_pre[:3, :3], T_gt[:3, :3])
    rte = float(np.linalg.norm(T_pre[:3, 3] - T_gt[:3, 3]))
    return rre, rte
