"""Launchers and placement: ``mesh`` (mesh builders over the caller's
process group), ``specs`` (input stand-ins and spec trees), ``serve`` and
``train`` (command-line entry points that start their own ranks); and the
cost tools: ``hlo_cost`` (per-device FLOPs, bytes, collectives and memory
of a call), ``roofline``, ``dryrun`` (every cell on the production meshes,
on meta tensors) and ``report``."""
