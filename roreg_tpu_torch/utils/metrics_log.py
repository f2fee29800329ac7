"""Scalar metric streaming: the tensorboardX Logger equivalent.

A copy of ``roreg_tpu/utils/metrics_log.py``: an append-only JSONL stream
``scalars.jsonl`` (one object per write: wall seconds since the log was
opened, step, split, and each scalar) and a human-readable
``{split}.txt`` mirror, the same lines the JAX package writes. Values
that do not convert to ``float`` (arrays, strings) are skipped.
"""

from __future__ import annotations

import json
import os
import time

__all__ = ["ScalarLog"]


class ScalarLog:
    """Append-only scalar stream: ``dir/scalars.jsonl`` + ``dir/{split}.txt``.

    Usage::

        log = ScalarLog(model_dir)
        log.write(step, {"loss": 0.5}, split="train")
    """

    def __init__(self, log_dir: str):
        self.dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._txt = {}
        self._t0 = time.time()

    def write(self, step: int, scalars: dict, split: str = "train") -> None:
        rec = {
            "wall": round(time.time() - self._t0, 3),
            "step": int(step),
            "split": split,
        }
        vals = {}
        for k, v in scalars.items():
            try:
                vals[k] = float(v)
            except (TypeError, ValueError):
                continue  # non-scalars (arrays/strings) are not streamed
        rec.update(vals)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if split not in self._txt:
            self._txt[split] = open(os.path.join(self.dir, f"{split}.txt"), "a")
        msg = f"step {step} " + " ".join(f"{k} {v:.6g}" for k, v in vals.items())
        self._txt[split].write(msg + "\n")
        self._txt[split].flush()

    def close(self) -> None:
        self._f.close()
        for f in self._txt.values():
            f.close()
