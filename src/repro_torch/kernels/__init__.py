"""Hand-written Hopper kernels (``csrc/``) for the TPU kernels of
``repro.kernels``, each beside its plain PyTorch version; ``ops`` is the
dispatch.  Nothing here compiles or imports a GPU toolchain at import."""
