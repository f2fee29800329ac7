"""The committed quality weights of the port equal the JAX package's
checkpoints bit for bit.

``convert_checkpoints(src, dst)`` restores each of the five
``*_variables`` orbax checkpoints of ``src`` through the JAX package
(templates from ``quality_small_config()``: parameter shapes do not depend
on voxel size or capacities) and writes them as plain float32 ``.npz``
files with flat keys (``weights.flatten_variables``), plus a copy of
``config_tag.json``, which ``weights.load_checkpoint_dir`` reads without
JAX. Regenerate the committed set on a machine with JAX and orbax:

    python tests/test_torch_quality_weights.py
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from roreg_tpu_torch.weights import (  # noqa: E402
    CHECKPOINT_COMPONENTS,
    QUALITY_FULL_DIR,
    flatten_variables,
    load_checkpoint_dir,
)

SRC = os.path.join(REPO, "checkpoints_quality_full")


def restore_checkpoints(src: str) -> dict:
    """{component: flat {key: numpy array}} restored from ``src`` with orbax
    through the JAX package."""
    import jax
    import orbax.checkpoint as ocp

    from roreg_tpu.pipeline.quality_config import quality_small_config
    from roreg_tpu.pipeline.registration import RegistrationPipeline

    templates = RegistrationPipeline(quality_small_config(), {}).init_variables(jax.random.PRNGKey(0))
    ckptr = ocp.StandardCheckpointer()
    out = {}
    for comp in CHECKPOINT_COMPONENTS:
        v = ckptr.restore(os.path.join(src, f"{comp}_variables"), templates[comp])
        out[comp] = flatten_variables(jax.tree_util.tree_map(np.asarray, v))
    return out


def convert_checkpoints(src: str, dst: str) -> None:
    """Write ``src``'s five checkpoints as ``dst/<component>.npz`` (float32,
    flat keys) and copy its ``config_tag.json``."""
    os.makedirs(dst, exist_ok=True)
    for comp, flat in restore_checkpoints(src).items():
        for k, a in flat.items():
            if a.dtype != np.float32:
                raise ValueError(f"{comp}/{k}: {a.dtype}, expected float32")
        np.savez_compressed(os.path.join(dst, f"{comp}.npz"), **flat)
    shutil.copyfile(os.path.join(src, "config_tag.json"), os.path.join(dst, "config_tag.json"))


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.dtype, a.shape, a.tobytes()


def test_committed_weights_equal_a_fresh_restore():
    pytest.importorskip("orbax.checkpoint")
    from roreg_tpu_torch.pipeline.quality_config import quality_full_config

    restored = restore_checkpoints(SRC)
    committed = load_checkpoint_dir(QUALITY_FULL_DIR, quality_full_config())
    assert committed.keys() == restored.keys()
    for comp, flat in restored.items():
        got = flatten_variables(committed[comp])
        assert got.keys() == flat.keys() and len(flat) > 10, comp
        for k in flat:
            assert _bits(got[k]) == _bits(flat[k]), f"{comp}/{k}"
    with open(os.path.join(SRC, "config_tag.json")) as f, \
            open(os.path.join(QUALITY_FULL_DIR, "config_tag.json")) as g:
        assert json.load(f) == json.load(g)


def test_loader_refuses_a_mismatched_config_tag(tmp_path):
    """The small config's voxel size against the full set's tag: refused,
    as parameter shapes alone would load it silently."""
    from roreg_tpu_torch.pipeline.quality_config import quality_full_config, quality_small_config

    with pytest.raises(ValueError, match="config mismatch"):
        load_checkpoint_dir(QUALITY_FULL_DIR, quality_small_config())
    with pytest.raises(ValueError, match="config mismatch"):
        load_checkpoint_dir(QUALITY_FULL_DIR, quality_full_config(group_size=24))
    # a tag that says small, beside the full config
    shutil.copyfile(os.path.join(QUALITY_FULL_DIR, "config_tag.json"), tmp_path / "config_tag.json")
    tag = json.loads((tmp_path / "config_tag.json").read_text())
    (tmp_path / "config_tag.json").write_text(json.dumps({**tag, "small": True}))
    with pytest.raises(ValueError, match="config mismatch"):
        load_checkpoint_dir(str(tmp_path), quality_full_config())
    (tmp_path / "config_tag.json").write_text(json.dumps(tag))
    with pytest.raises(FileNotFoundError, match="'rm'"):
        load_checkpoint_dir(str(tmp_path), quality_full_config())


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    convert_checkpoints(SRC, QUALITY_FULL_DIR)
    print(f"wrote {QUALITY_FULL_DIR}")
