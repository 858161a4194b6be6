"""PyTorch/CUDA port of the PICNIC serving path.

A second package beside ``repro`` (the JAX reference), with the same
layout and names.  It imports ``torch`` and numpy, never ``jax`` and
nothing of ``repro``.  Attention runs through hand-written Hopper kernels
(``repro_torch.kernels``) on a CUDA tensor and through their plain
PyTorch versions on a CPU tensor.
"""
