"""BlockResUNet under ResUNetBN2D and ResUNetBN2E against the JAX package's
(the checks and tolerances of tests/test_torch_block_variants.py), and the
widest variant, ResUNetBN2E, through the block-engine describe.

The describe runs ``extract_group_features_blocks`` at G = 12, block
capacities (256, 128, 64, 32) and conv1 kernel 3 on both sides, with the
BN2E variables of the forward cases, at f32: the features within
tests/test_torch_block_slice.py's 1e-4, no block dropped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_block_variants import BCAPS, CONV1_K, check_bf16, check_f32, variables
from test_torch_reference_native import reference_native  # noqa: E402,F401 (autouse: the JAX host library, built whole)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu.pipeline.config import PipelineConfig as JConfig  # noqa: E402
from roreg_tpu.pipeline.extractor import extract_group_features_blocks as jax_describe  # noqa: E402
from roreg_tpu_torch.data.synthetic import synthetic_pair  # noqa: E402
from roreg_tpu_torch.pipeline.config import PipelineConfig  # noqa: E402
from roreg_tpu_torch.pipeline.extractor import extract_group_features_blocks, make_backbone  # noqa: E402
from roreg_tpu_torch.weights import load_variables, unflatten_variables  # noqa: E402

WIDE = ("ResUNetBN2D", "ResUNetBN2E")
SMALL = dict(
    voxel_size=0.05, group_size=12, block_caps=BCAPS, conv1_kernel_size=CONV1_K, group_chunk=4,
    num_keypoints=128, engine="block", backbone_compute_dtype=None, backbone_variant="ResUNetBN2E",
)
TOL = 1e-4


@pytest.mark.parametrize("variant", WIDE)
def test_block_resunet_f32_matches_jax(variant):
    check_f32(variant)


@pytest.mark.parametrize("variant", WIDE)
def test_block_resunet_bf16_matches_jax(variant):
    check_bf16(variant)


def test_bn2e_block_describe_matches_jax():
    pair = synthetic_pair(3, points_per_cloud=2500, num_keypoints=128, surface_extent=1.3)
    nested = unflatten_variables(variables("ResUNetBN2E"))
    jcfg = JConfig(**SMALL)
    ref = np.asarray(jax_describe(jax.tree_util.tree_map(jnp.asarray, nested), pair["points0"], pair["keys0"], jcfg))

    cfg = PipelineConfig(**SMALL)
    net = make_backbone(cfg, engine="block")
    load_variables(net, nested)
    with torch.no_grad():
        out, dropped = extract_group_features_blocks(net.eval(), pair["points0"], pair["keys0"], cfg,
                                                     torch.device("cpu"))
    out = out.numpy()
    assert dropped == 0
    assert out.shape == ref.shape == (128, 12, 32)
    assert np.abs(out - ref).max() <= TOL
    norms = np.linalg.norm(out, axis=-1)
    assert np.allclose(norms[norms > 0], 1.0, atol=1e-5) and (norms > 0).mean() > 0.9
