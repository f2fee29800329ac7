"""roreg_tpu_torch: the PyTorch/CUDA port of ``roreg_tpu`` for NVIDIA Hopper.

The JAX package ``roreg_tpu`` is the reference; this package keeps its
module structure, names and public layouts (``(K, G, 32)`` group features,
``(27, Cin, Cout)`` sparse-conv kernels) so that each piece has a visible
counterpart. It imports ``torch`` and numpy only.

Implemented: inference registration of one scan pair through the
gather-engine describe (``engine="gather"``, ``host_maps=True``), with the
mutual-NN matcher (``use_rm=False``) and the yohoo estimator. Every gather
convolution of the backbone runs through the hand-written CUDA kernel in
``csrc/gather_conv.cu`` when its tensors live on the GPU.

Entry points run on CUDA unless the caller passes ``device="cpu"``; they
raise when CUDA is absent and no CPU was asked for.
"""

__version__ = "0.1.0"
