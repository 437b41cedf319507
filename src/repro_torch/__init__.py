"""PyTorch/CUDA port of the bounded deformable-convolution system.

The JAX package ``repro`` is the reference; this package keeps its module
layout and its public layouts (NHWC activations, HWIO conv weights,
``(K*K, C, M)`` deform weights, offsets ``(N, Ho, Wo, 2*K*K)`` as
``(dy, dx)`` pairs per tap) so every function has a direct counterpart.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``repro_torch.device.resolve_device``).  On the CPU every kernel wrapper
runs its plain PyTorch version; on a CUDA tensor it launches the
hand-written kernel or raises.
"""
