from yolofastest_torch.utils.logging import config_logger
from yolofastest_torch.utils.visualize import plot_one_box

__all__ = ["config_logger", "plot_one_box"]
