"""Launchers and placement: ``mesh`` (mesh builders over the caller's
process group), ``specs`` (input stand-ins and spec trees), ``serve`` and
``train`` (command-line entry points that start their own ranks)."""
