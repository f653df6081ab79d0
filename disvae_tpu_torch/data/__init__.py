from disvae_tpu_torch.data.datasets import (ArrayDataset, DataLoader,
                                            DATASETS, get_dataloaders,
                                            get_dataset, get_img_size)

__all__ = ["ArrayDataset", "DataLoader", "DATASETS", "get_dataloaders",
           "get_dataset", "get_img_size"]
