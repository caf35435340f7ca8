"""RelJoin on PyTorch and CUDA: the port of the JAX package ``repro``.

Tables live on the CUDA card unless the caller names another device
(``device="cpu"``); the local-join and exchange hot spots run as
hand-written Hopper kernels (``kernels/``, sources in ``csrc/``).
"""
