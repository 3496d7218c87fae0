from .registry import ARCH_IDS, get_config
