from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, InputShape,
                                      get_config, list_archs)

__all__ = ["INPUT_SHAPES", "ArchConfig", "InputShape", "get_config",
           "list_archs"]
