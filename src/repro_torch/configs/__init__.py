from .base import ModelConfig, ARCHS, get_config, SHAPES, ShapeConfig  # noqa: F401
