"""Hand-written Hopper kernels (``../csrc/*.cu``) with their wrappers
(``partition_hist``, ``tiled_probe``, ``bitonic_sort``, ``bloom``,
``zone_map``), the reference's shape dispatch (``ops``) and their plain
PyTorch versions (``ref``)."""
