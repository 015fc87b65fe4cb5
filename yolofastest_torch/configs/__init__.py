from yolofastest_torch.configs.config import (
    AugmentConfig,
    Config,
    IOConfig,
    TrainConfig,
    config_256x320,
    config_512x640,
    get_config,
)

__all__ = [
    "AugmentConfig",
    "Config",
    "IOConfig",
    "TrainConfig",
    "config_256x320",
    "config_512x640",
    "get_config",
]
