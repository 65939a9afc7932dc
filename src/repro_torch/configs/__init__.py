from repro_torch.configs.base import ArchConfig, get_config, list_archs

__all__ = ["ArchConfig", "get_config", "list_archs"]
