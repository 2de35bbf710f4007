"""The MLP router and its training."""

from tpulmi_torch.models.mlp import MLP, StackedMLP, make_model
from tpulmi_torch.models.train import BucketClassifier, train_lr_sweep

__all__ = ["MLP", "StackedMLP", "make_model", "BucketClassifier",
           "train_lr_sweep"]
