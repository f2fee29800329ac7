"""roreg_tpu_torch: the PyTorch/CUDA port of ``roreg_tpu`` for NVIDIA Hopper.

The JAX package ``roreg_tpu`` is the reference; this package keeps its
module structure, names and public layouts (``(K, G, 32)`` group features,
``(27, Cin, Cout)`` sparse-conv kernels) so that each piece has a visible
counterpart. It imports ``torch`` and numpy only.

Implemented: inference registration of one scan pair through either
describe engine, the block-dense engine (``engine="block"``, the default)
or the gather engine (``engine="gather"``), over host-built maps, with the
mutual-NN matcher (``use_rm=False``) and the yohoo estimator. On the GPU
every gather conv of the gather engine runs the hand-written CUDA kernel
of ``csrc/gather_conv.cu``; every same-level and stride-2 conv of the block
engine runs ``csrc/halo_conv.cu`` and every block-table gather (conv1's
occupancy, the up convs' coarse regions) ``csrc/block_gather.cu``.

Entry points run on CUDA unless the caller passes ``device="cpu"``; they
raise when CUDA is absent and no CPU was asked for.
"""

__version__ = "0.1.0"
