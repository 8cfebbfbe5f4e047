from .config import (SHAPES, ModelConfig, ShapeConfig, get_config, register,
                     resolve_config)
from .transformer import Model

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "get_config", "register",
           "resolve_config", "Model"]
