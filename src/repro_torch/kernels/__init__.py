"""Hand-written Hopper kernels (``../csrc/*.cu``) with their wrappers
(``partition_hist``, ``tiled_probe``, ``bitonic_sort``), the reference's
shape dispatch (``ops``) and their plain PyTorch versions (``ref``)."""
