"""MLP bucket-classifier family: hidden Linear+ReLU layers, then a Linear
logit layer over the buckets.

MLP-9 is the [8, 16] stack (the reference wires its second layer to the
input width, which cannot run). `StackedMLP` holds G such MLPs of one
architecture, their weights on a leading axis (the hierarchical index's
inner routers; `models.train.train_lr_sweep`'s one model per learning
rate).
"""

import math
from typing import List, Sequence

import torch
from torch import nn

MODEL_HIDDEN_DIMS = {
    "MLP": (128,),
    "MLP-2": (64,),
    "MLP-3": (256,),
    "MLP-4": (512,),
    "MLP-5": (256, 128),
    "MLP-6": (32,),
    "MLP-7": (16,),
    "MLP-8": (8,),
    "MLP-9": (8, 16),
}

# stddev of a unit normal truncated to [-2, 2], the correction flax's
# variance_scaling applies so the truncated draw keeps the target variance
_TRUNC_STD = 0.87962566103423978


class MLP(nn.Module):
    """ReLU MLP classifier with float32 logits."""

    def __init__(self, input_dim: int, hidden_dims: Sequence[int],
                 n_classes: int):
        super().__init__()
        widths = [input_dim, *hidden_dims, n_classes]
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.hidden_dims = tuple(hidden_dims)
        self.n_classes = n_classes

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        """flax ``nn.Dense`` defaults: lecun-normal kernels drawn from a
        truncated normal, zero biases."""
        with torch.no_grad():
            for layer in self.layers:
                std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
                w = torch.empty(layer.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                layer.weight.copy_(w)
                layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)


def make_model(model_type: str, input_dim: int, n_classes: int,
               generator: torch.Generator = None) -> MLP:
    """Build and initialize the named architecture variant."""
    if model_type not in MODEL_HIDDEN_DIMS:
        raise ValueError(
            f"Unknown model_type {model_type!r}; expected one of "
            f"{sorted(MODEL_HIDDEN_DIMS)}")
    model = MLP(input_dim, MODEL_HIDDEN_DIMS[model_type], n_classes)
    model.reset_parameters(generator)
    return model


class StackedMLP(nn.Module):
    """G ReLU MLPs of one architecture, their weights stacked on a leading
    (G,) axis: ``weights[i]`` is (G, out, in) (a Linear's weight per
    group), ``biases[i]`` (G, out). Maps (Q, d) to (G, Q, n_classes) with
    one batched product per layer."""

    def __init__(self, n_models: int, input_dim: int, hidden_dims,
                 n_classes: int):
        super().__init__()
        widths = [input_dim, *hidden_dims, n_classes]
        self.weights = nn.ParameterList(
            nn.Parameter(torch.zeros(n_models, b, a))
            for a, b in zip(widths[:-1], widths[1:]))
        self.biases = nn.ParameterList(
            nn.Parameter(torch.zeros(n_models, b)) for b in widths[1:])
        self.n_models = n_models

    @classmethod
    def stack(cls, models: List[MLP]) -> "StackedMLP":
        """One stack holding the params of `models` (on their device)."""
        first = models[0]
        out = cls(len(models), first.layers[0].in_features,
                  first.hidden_dims, first.n_classes)
        with torch.no_grad():
            for i in range(len(first.layers)):
                out.weights[i] = nn.Parameter(torch.stack(
                    [m.layers[i].weight.detach() for m in models]))
                out.biases[i] = nn.Parameter(torch.stack(
                    [m.layers[i].bias.detach() for m in models]))
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float().unsqueeze(0).expand(self.n_models, -1, -1)
        last = len(self.weights) - 1
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            h = torch.baddbmm(b.unsqueeze(1), h, w.transpose(1, 2))
            if i < last:
                h = torch.relu(h)
        return h
