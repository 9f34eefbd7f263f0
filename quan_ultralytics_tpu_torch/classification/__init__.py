"""Classification stack of the PyTorch port: Q-WRN / Q-ResNet on CIFAR, SVHN
and ImageNet (counterpart of the JAX package's ``classification/``)."""

from quan_ultralytics_tpu_torch.classification.models import MODEL_FACTORIES, create_model

__all__ = ["create_model", "MODEL_FACTORIES"]
