from repro_torch.data.synthetic_traffic import DATASETS, make_dataset
from repro_torch.data.windowing import (FeatureScaler, build_windows,
                                        client_batches, rmse_mae)

__all__ = ["DATASETS", "FeatureScaler", "build_windows", "client_batches",
           "make_dataset", "rmse_mae"]
