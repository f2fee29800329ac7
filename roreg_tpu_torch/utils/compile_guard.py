"""Cold-start contract: say loudly when a run starts cold.

Counterpart of ``roreg_tpu/utils/compile_guard.py``. The JAX package keeps
a manifest of describe-program signatures known to sit in its persistent
XLA cache. The port compiles no program per configuration; what a cold
start costs it is building its kernels: ``nvcc`` of each CUDA source the
run launches (and ``g++`` of the host voxel hash) into the gitignored
``_build/`` beside the package, seconds a source and serial at first use.
Entry points (``bench.py``) call :func:`check_describe_signature` before
the first describe: a configuration that ran to completion in this
checkout proceeds silently, an unknown one prints a warning naming that
cost, and :func:`record_describe_signature` records it once the run
succeeds. The signature hashes the same configuration fields as the JAX
package's, so the two name one configuration alike.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

from roreg_tpu_torch.build import BUILD_DIR

__all__ = ["MANIFEST_DIR", "describe_signature", "check_describe_signature", "record_describe_signature"]

_MANIFEST = "describe_manifest.json"
MANIFEST_DIR = BUILD_DIR


def describe_signature(cfg, extra: dict | None = None) -> str:
    """Stable hash of every config field that shapes the describe (the JAX
    package's fields and layout revision)."""
    payload = {
        "layout_rev": 3,
        "engine": cfg.engine,
        "block_caps": list(cfg.block_caps),
        "block_caps_fallback": list(cfg.block_caps_fallback) if cfg.block_caps_fallback else None,
        "capacities": list(cfg.capacities),
        "group_size": cfg.group_size,
        "group_chunk": cfg.group_chunk,
        "backbone_variant": cfg.backbone_variant,
        "conv1_kernel_size": cfg.conv1_kernel_size,
        "compute_dtype": cfg.backbone_compute_dtype,
        "num_keypoints": cfg.num_keypoints,
        "host_maps": cfg.host_maps,
    }
    if cfg.rot_vmap > 1:  # omitted at the default (1), as in the JAX package
        payload["rot_vmap"] = cfg.rot_vmap
    if extra:
        payload.update(extra)
    return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]


def _manifest_path(cache_dir: str) -> str:
    return os.path.join(cache_dir, _MANIFEST)


def _load(cache_dir: str) -> dict:
    try:
        with open(_manifest_path(cache_dir)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def check_describe_signature(cfg, cache_dir: str = MANIFEST_DIR, extra: dict | None = None,
                             label: str = "describe") -> bool:
    """True when this configuration's describe has run to completion in this
    checkout; else a warning on stderr naming the cold start's cost, and
    False (the caller may go on)."""
    sig = describe_signature(cfg, extra)
    manifest = _load(cache_dir)
    if sig in manifest:
        return True
    known = {k: v.get("label", "?") for k, v in manifest.items()}
    print(
        f"[compile-guard] {label} signature {sig} is not in the manifest "
        f"({_manifest_path(cache_dir)}).\n"
        f"[compile-guard] A cold start builds the kernels this run launches with nvcc (and the host "
        f"voxel hash with g++) into {cache_dir}, seconds a source, serial at first use; no program is "
        f"compiled per configuration. Known signatures: {known or 'none'}.\n"
        f"[compile-guard] The signature is recorded when the run succeeds.",
        file=sys.stderr, flush=True,
    )
    return False


def record_describe_signature(cfg, cache_dir: str = MANIFEST_DIR, extra: dict | None = None,
                              label: str = "describe") -> None:
    """Record a signature after the run succeeded."""
    sig = describe_signature(cfg, extra)
    manifest = _load(cache_dir)
    if sig in manifest:
        return
    manifest[sig] = {"label": label}
    os.makedirs(cache_dir, exist_ok=True)
    with open(_manifest_path(cache_dir), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
