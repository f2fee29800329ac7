"""roreg_tpu_torch: the PyTorch/CUDA port of ``roreg_tpu`` for NVIDIA Hopper.

The JAX package ``roreg_tpu`` is the reference; this package keeps its
module structure, names and public layouts (``(K, G, 32)`` group features,
``(27, Cin, Cout)`` sparse-conv kernels) so that each piece has a visible
counterpart. It imports ``torch`` and numpy only.

Implemented: inference registration of one scan pair through either
describe engine, the block-dense engine (``engine="block"``, the default)
or the gather engine (``engine="gather"``), over host-built maps, with the
RM matcher (``use_rm=True``, the default) or the mutual-NN matcher
(``use_rm=False``), and the yohoo or yohoc estimator: ``PipelineConfig()``
with no argument runs. ``eval.evaluator.Evaluator`` describes each cloud of
a scene once and registers its pairs from the stored descriptors, and
``python -m roreg_tpu_torch.quality`` runs the JAX package's held-out
quality benchmark with the committed trained weights
(``checkpoints/quality_full/``). On the GPU every gather conv of the gather engine runs the
hand-written CUDA kernel of ``csrc/gather_conv.cu``; on the block engine
every same-level and stride-2 conv runs ``csrc/halo_conv.cu``, every
block-table gather (conv1's occupancy, the up convs' coarse regions)
``csrc/block_gather.cu``, the up convs' parity-class products
``csrc/up_conv.cu``, the decoder's bf16 skip concatenations
``csrc/skip_concat.cu`` and its per-cell dense layers ``csrc/cell_dense.cu``.

Entry points run on CUDA unless the caller passes ``device="cpu"``; they
raise when CUDA is absent and no CPU was asked for.
"""

__version__ = "0.1.0"
