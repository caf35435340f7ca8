"""Serving substrate: batched request scheduling over prefill/decode."""

from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
