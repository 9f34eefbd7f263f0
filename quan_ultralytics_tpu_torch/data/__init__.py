from quan_ultralytics_tpu_torch.data.build import build_dataloader
from quan_ultralytics_tpu_torch.data.dataset import YOLODataset

__all__ = ["YOLODataset", "build_dataloader"]
