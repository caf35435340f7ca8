"""Model composition: config dataclasses, the decoder-LM composer, and
modality-frontend stubs."""

from .config import (Family, ModelConfig, SHAPES, SHAPE_BY_NAME, ShapeConfig,
                     shape_applicable)

__all__ = ["Family", "ModelConfig", "SHAPES", "SHAPE_BY_NAME", "ShapeConfig",
           "shape_applicable"]
