"""Runnable examples of the port, each a twin of the script of the same name
under ``examples/``: ``python -m repro_torch.examples.<name> [--device cpu]``.
"""
