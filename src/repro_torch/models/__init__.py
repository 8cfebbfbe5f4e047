from .config import (SHAPES, ModelConfig, ShapeConfig, all_configs,
                     cell_is_applicable, get_config, register, resolve_config)
from .transformer import Model

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "all_configs",
           "cell_is_applicable", "get_config", "register", "resolve_config",
           "Model"]
