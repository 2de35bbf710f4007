"""Carry a built index across from the JAX package, given as numpy arrays.

- `mlp_state_from_flax`: flax ``Dense_i`` params -> the MLP's state_dict
  (a Dense ``kernel (in, out)`` is a Linear ``weight (out, in)``).
- `store_from_arrays`: the bucket store's arrays -> `BucketStore`; a
  quantized store's codes and scales cross bit for bit.
- `index_from_arrays`: router params and store arrays -> a built
  `LearnedIndex`.
- `joint_router_from_flax`: the hierarchical index's ``{"outer",
  "inner"}`` params (the inner stacked on a leading group axis) -> a
  `JointRouter`.
"""

from typing import Mapping, Optional

import numpy as np
import torch

from tpulmi_torch.buckets import BucketStore, bucket_stats
from tpulmi_torch.index import BuiltIndex, LearnedIndex
from tpulmi_torch.models.mlp import MLP
from tpulmi_torch.models.train import BucketClassifier
from tpulmi_torch.utils.config import IndexConfig
from tpulmi_torch.utils.profiling import resolve_device


def _dense_layers(params: Mapping):
    n = len([name for name in params if name.startswith("Dense_")])
    if n == 0 or set(params) != {f"Dense_{i}" for i in range(n)}:
        raise ValueError(f"expected flax params Dense_0..Dense_{n - 1}, "
                         f"got {sorted(params)}")
    return [params[f"Dense_{i}"] for i in range(n)]


def mlp_state_from_flax(params: Mapping) -> dict:
    """state_dict of `MLP` from flax MLP params."""
    state = {}
    for i, layer in enumerate(_dense_layers(params)):
        kernel = np.asarray(layer["kernel"], np.float32)
        state[f"layers.{i}.weight"] = torch.from_numpy(kernel.T.copy())
        state[f"layers.{i}.bias"] = torch.from_numpy(
            np.asarray(layer["bias"], np.float32).copy())
    return state


def mlp_from_flax(params: Mapping) -> MLP:
    """An `MLP` holding the flax params (widths read from them)."""
    layers = _dense_layers(params)
    shapes = [np.shape(layer["kernel"]) for layer in layers]
    model = MLP(shapes[0][0], [s[1] for s in shapes[:-1]], shapes[-1][1])
    model.load_state_dict(mlp_state_from_flax(params))
    return model


def joint_router_from_flax(params: Mapping, outer_model_type: str,
                           inner_model_type: str, n_groups: int, n_cat: int):
    """A `JointRouter` (outer weight and mass temperature 1) holding the
    JAX package's ``{"outer": MLP params, "inner": stacked MLP params}``,
    as numpy arrays; each group's slice of the stack converts as one MLP,
    and `StackedMLP.stack` stacks them. Params of other widths than the
    model types' raise."""
    from tpulmi_torch.hierarchical import JointRouter, StackedMLP

    outer = mlp_from_flax(params["outer"])
    inner = StackedMLP.stack([
        mlp_from_flax({name: {key: np.asarray(v)[g]
                              for key, v in layer.items()}
                       for name, layer in params["inner"].items()})
        for g in range(n_groups)])
    router = JointRouter.empty(outer_model_type, inner_model_type,
                               outer.layers[0].in_features, n_groups, n_cat)
    # the model types' shapes: a state of other widths raises here
    router.load_state_dict(
        JointRouter(outer, inner, n_groups, n_cat).state_dict())
    return router


def store_from_arrays(data_sorted, ids_sorted, offsets, counts, n: int,
                      pad_rows: int, row_align: int, device="cuda",
                      scales=None, quant_bits: int = 8) -> BucketStore:
    """`scales` (one float32 per store row) marks a quantized store:
    `data_sorted` then holds its int8 codes ((rows, d/2) packed bytes when
    ``quant_bits == 4``) and is kept as int8."""
    device = resolve_device(device)

    def t(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    return BucketStore(
        data_sorted=t(data_sorted,
                      torch.float32 if scales is None else torch.int8),
        ids_sorted=t(ids_sorted, torch.int32),
        offsets=t(offsets, torch.int32), counts=t(counts, torch.int32),
        n=int(n), pad_rows=int(pad_rows), row_align=int(max(row_align, 1)),
        scales=None if scales is None else t(scales, torch.float32),
        quant_bits=int(quant_bits))


def index_from_arrays(params: Mapping, data_sorted, ids_sorted, offsets,
                      counts, n: int, pad_rows: int, row_align: int, *,
                      config: IndexConfig = IndexConfig(),
                      centroids=None, pred_categories=None,
                      device="cuda", scales=None,
                      quant_bits: int = 8) -> LearnedIndex:
    """A built `LearnedIndex` from router params and store arrays (codes
    and `scales` for a quantized store)."""
    index = LearnedIndex(config, device=device)
    dev = index.device
    model = mlp_from_flax(params)
    store = store_from_arrays(data_sorted, ids_sorted, offsets, counts, n,
                              pad_rows, row_align, device=dev, scales=scales,
                              quant_bits=quant_bits)
    classifier = BucketClassifier(
        model.layers[0].in_features, model.n_classes, lr=config.lr,
        model_type=config.model_type, seed=config.seed, device=dev,
        model=model)

    def opt(x, dtype) -> Optional[torch.Tensor]:
        return (None if x is None else
                torch.as_tensor(np.array(x), dtype=dtype, device=dev))

    index.built = BuiltIndex(
        centroids=opt(centroids, torch.float32), classifier=classifier,
        store=store, pred_categories=opt(pred_categories, torch.int32),
        config=config, max_bucket=bucket_stats(store)[0])
    return index
