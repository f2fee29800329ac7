"""The committed checkpoints convert into the port's state_dicts bit-exact.

Each of ``checkpoints_quality/``'s five ``*_variables`` is restored on the
CPU through the JAX package (templates as in test_checkpoint_compat.py).
Backbone, GF, RD and ET load into the port's modules and export back; RM,
which has no module in the port yet, converts to a flat state_dict and
back. Every leaf must come back bit for bit.
"""

import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu_torch.pipeline.config import PipelineConfig  # noqa: E402
from roreg_tpu_torch.weights import (  # noqa: E402
    build_modules,
    export_variables,
    flatten_variables,
    load_variables,
    unflatten_variables,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_DIR = os.path.join(REPO, "checkpoints_quality")
COMPONENTS = ("backbone", "gf", "rd", "rm", "et")


@pytest.fixture(scope="module")
def restored():
    import orbax.checkpoint as ocp

    from roreg_tpu.pipeline.quality_config import quality_small_config
    from roreg_tpu.pipeline.registration import RegistrationPipeline

    jcfg = quality_small_config()
    templates = RegistrationPipeline(jcfg, {}).init_variables(jax.random.PRNGKey(0))
    ckptr = ocp.StandardCheckpointer()
    out = {}
    for comp in COMPONENTS:
        v = ckptr.restore(os.path.join(CKPT_DIR, f"{comp}_variables"), templates[comp])
        out[comp] = jax.tree_util.tree_map(np.asarray, v)
    cfg = PipelineConfig(
        voxel_size=jcfg.voxel_size, group_size=jcfg.group_size, capacities=jcfg.capacities,
        conv1_kernel_size=jcfg.conv1_kernel_size, engine="gather", use_rm=False,
    )
    return cfg, out


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.dtype, a.shape, a.tobytes()


@pytest.mark.parametrize("comp", ["backbone", "gf", "rd", "et"])
def test_module_round_trip_bit_exact(restored, comp):
    cfg, variables = restored
    net = build_modules(cfg)[comp]
    load_variables(net, variables[comp])
    ref = flatten_variables(variables[comp])
    back = flatten_variables(export_variables(net))
    assert back.keys() == ref.keys()
    for k in ref:
        assert _bits(back[k]) == _bits(ref[k]), k
    # the state_dict itself holds the same bits, transposed for Linear
    sd = net.state_dict()
    assert len(sd) == len(ref)


def test_rm_flat_state_dict_round_trip(restored):
    _, variables = restored
    flat = flatten_variables(variables["rm"])
    sd = {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}
    back = flatten_variables(unflatten_variables({k: t.numpy() for k, t in sd.items()}))
    assert back.keys() == flat.keys() and len(flat) > 20
    for k in flat:
        assert _bits(back[k]) == _bits(flat[k]), k
