"""Registration visualization: a copy of ``roreg_tpu/data/visualize.py``.

The headless analog of the reference's open3d glue
(``utils/utils_o3d.py:8-35`` ``draw_registration_result`` /
``draw_registration_result_with_keys``): orthographic scatter projections
(three axes) of the two clouds before and after the estimated transform,
written to a PNG. Colors mirror the reference (source gold, target blue,
keypoints red). matplotlib is imported inside the functions: nothing on
the card's path calls them.
"""

from __future__ import annotations

import numpy as np

__all__ = ["draw_registration", "draw_registration_with_keys"]

_SRC_COLOR = (1.0, 0.706, 0.0)
_TGT_COLOR = (0.0, 0.651, 0.929)
_KEY_COLOR = (1.0, 0.0, 0.0)


def _transform(pc: np.ndarray, T: np.ndarray) -> np.ndarray:
    return pc @ np.asarray(T)[:3, :3].T + np.asarray(T)[:3, 3]


def _scatter_panel(ax, clouds, axes_pair, title):
    i, j = axes_pair
    for pc, color, size in clouds:
        ax.scatter(pc[:, i], pc[:, j], s=size, c=[color], linewidths=0)
    ax.set_title(title, fontsize=9)
    ax.set_aspect("equal")
    ax.set_xticks([])
    ax.set_yticks([])


def draw_registration(
    source: np.ndarray,
    target: np.ndarray,
    transform: np.ndarray,
    out_png: str,
    max_points: int = 20000,
    keys: np.ndarray | None = None,
) -> str:
    """Render before/after registration projections to ``out_png``.

    source/target (N, 3); transform (4, 4) applied to source (the
    reference convention: target = T @ source). Returns out_png.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(0)

    def sub(pc):
        pc = np.asarray(pc, np.float32)
        if len(pc) > max_points:
            pc = pc[rng.choice(len(pc), max_points, replace=False)]
        return pc

    src, tgt = sub(source), sub(target)
    src_t = _transform(src, transform)
    fig, axs = plt.subplots(2, 3, figsize=(9, 6), dpi=110)
    for col, pair in enumerate([(0, 1), (0, 2), (1, 2)]):
        before = [(src, _SRC_COLOR, 0.3), (tgt, _TGT_COLOR, 0.3)]
        after = [(src_t, _SRC_COLOR, 0.3), (tgt, _TGT_COLOR, 0.3)]
        if keys is not None:
            k = np.asarray(keys, np.float32)
            after = after + [(_transform(k, transform), _KEY_COLOR, 2.0)]
        _scatter_panel(axs[0][col], before, pair, f"before (axes {pair})")
        _scatter_panel(axs[1][col], after, pair, f"after (axes {pair})")
    fig.tight_layout()
    fig.savefig(out_png)
    plt.close(fig)
    return out_png


def draw_registration_with_keys(source, target, keys, transform, out_png,
                                max_points: int = 20000) -> str:
    """Reference ``draw_registration_result_with_keys`` analog."""
    return draw_registration(
        source, target, transform, out_png, max_points=max_points, keys=keys
    )
