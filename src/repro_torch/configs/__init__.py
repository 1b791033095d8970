from repro_torch.configs.base import FedConfig
from repro_torch.configs.forecast import MLP_H1, MLP_H24, ForecastConfig

__all__ = ["FedConfig", "ForecastConfig", "MLP_H1", "MLP_H24"]
