"""The fused build: the whole index build as one sequence of tensor stages
on the build device, with no host round trips between them.

    1. k-means partition   (stratified sample -> Lloyd -> chunked assign)
    2. MLP init + training (one Adam step per batch)
    3. full-data argmax predict (chunked)
    4. bucket-store layout (stable argsort -> CSR, row_align padding)

``include_store=False`` runs stages 1-3 only, the same ops as the full
build, so that its ``pred_categories`` equal the full build's to the bit:
the store is then laid out on the host (`LearnedIndex.build_with_host_store`).

The stages keep the JAX package's fused-build semantics: the stratified
k-means sample ``arange(n_train)*stride + randint(stride)``, initial
centroids at every ``(n_train // k)``-th sample point, the
``train_sample_cap`` row stride, and per-epoch permutations truncated to
``steps_per_epoch * batch`` rows. The random draws come from a
``torch.Generator``; `StageInputs` replaces them with given indices and
weights (the tests feed both packages the same ones).
"""

import hashlib
from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import torch

from tpulmi_torch.buckets import layout_store
from tpulmi_torch.models.mlp import MLP, make_model
from tpulmi_torch.models.train import (epoch_batches, make_optimizer,
                                       run_epochs, train_plan)
from tpulmi_torch.ops.distance import l2_normalize
from tpulmi_torch.ops.kmeans import _lloyd_step, kmeans_assign


@dataclass(frozen=True)
class BuildPlan:
    sample_stride: int    # MLP trains on every sample_stride-th row
    train_rows: int       # rows in that training sample
    n_train: int          # k-means sample size
    epochs: int
    steps_per_epoch: int
    eff_batch: int


def build_plan(n: int, *, kmeans_train_points: int, epochs: int,
               batch_size: int, max_train_steps=None,
               reference_step_semantics: bool = False,
               train_sample_cap: int = 8_388_608) -> BuildPlan:
    sample_stride = max(1, -(-n // train_sample_cap))
    train_rows = -(-n // sample_stride)
    epochs, spe, _ = train_plan(train_rows, epochs, batch_size,
                                max_train_steps, reference_step_semantics)
    return BuildPlan(sample_stride, train_rows,
                     min(train_rows, kmeans_train_points), epochs, spe,
                     min(batch_size, train_rows))


@dataclass
class StageInputs:
    """The build's random draws, given explicitly."""

    train_idx: torch.Tensor        # (n_train,) k-means sample rows
    batches: List[torch.Tensor]    # per epoch: (steps_per_epoch, batch) rows
    init_state: dict               # MLP state_dict before training


def draw_stage_inputs(plan: BuildPlan, model: MLP,
                      generator: torch.Generator) -> StageInputs:
    """Seeded draws for the k-means sample and the epoch shuffles."""
    if plan.n_train < plan.train_rows:
        stride = plan.train_rows // plan.n_train
        train_idx = (torch.arange(plan.n_train) * stride
                     + torch.randint(0, stride, (plan.n_train,),
                                     generator=generator))
    else:
        train_idx = torch.arange(plan.n_train)
    batches = [epoch_batches(plan.train_rows, plan.steps_per_epoch,
                             plan.eff_batch, generator)
               for _ in range(plan.epochs)]
    return StageInputs(train_idx, batches,
                       {k: v.clone() for k, v in model.state_dict().items()})


class BuildResult(NamedTuple):
    centroids: torch.Tensor        # (k, d_nav)
    model: MLP                     # trained router
    losses: torch.Tensor           # (epochs,) mean CE per epoch
    pred_categories: torch.Tensor  # (n,) int32 model-argmax bucket per row
    data_sorted: torch.Tensor      # (rows, d_search) bucket-sorted
    ids_sorted: torch.Tensor       # (rows,) int32; -1 padding
    offsets: torch.Tensor          # (k + 1,) int32
    counts: torch.Tensor           # (k,) int32
    pad_rows: int


def build_digest(centroids: torch.Tensor, model: MLP,
                 data_sorted: torch.Tensor, ids_sorted: torch.Tensor,
                 offsets: torch.Tensor) -> str:
    """sha256 of the bytes a build made: the centroids, the router's
    parameters (by name) and the store. Two builds with equal digests are
    equal to the bit, wherever they ran."""
    h = hashlib.sha256()
    params = [v for _, v in sorted(model.state_dict().items())]
    for t in (centroids, *params, data_sorted, ids_sorted, offsets):
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _chunked(fn, x: torch.Tensor, chunk: int) -> torch.Tensor:
    """fn over row chunks of x (cast to float32), concatenated."""
    return torch.cat([fn(x[s:s + chunk].float())
                      for s in range(0, x.shape[0], chunk)])


def fused_build(
    data_nav: torch.Tensor,
    data_search: torch.Tensor,
    *,
    model_type: str,
    lr: float,
    n_categories: int,
    kmeans_iters: int = 25,
    kmeans_train_points: int = 31232,
    epochs: int = 12,
    batch_size: int = 1024,
    chunk: int = 262144,
    pad_rows: int = 4096,
    row_align: int = 1,
    reference_step_semantics: bool = False,
    normalize_search: bool = True,
    max_train_steps=None,
    train_sample_cap: int = 8_388_608,
    seed: int = 2023,
    stage_inputs: Optional[StageInputs] = None,
    include_store: bool = True,
) -> BuildResult:
    """Build on the device `data_nav` lies on. `data_search` is laid out
    in float32 (normalized unless ``normalize_search=False``).

    ``include_store=False`` stops after the predict: `data_search` is not
    read (it may be None), the store arrays come back empty, and ``counts``
    and ``offsets`` are the raw (unaligned) bucket sizes and their
    exclusive sum, as in the JAX package's navigation-only program."""
    dev = data_nav.device
    n, d_nav = data_nav.shape
    plan = build_plan(n, kmeans_train_points=kmeans_train_points,
                      epochs=epochs, batch_size=batch_size,
                      max_train_steps=max_train_steps,
                      reference_step_semantics=reference_step_semantics,
                      train_sample_cap=train_sample_cap)
    gen = torch.Generator().manual_seed(seed)
    model = make_model(model_type, d_nav, n_categories, generator=gen)
    if stage_inputs is None:
        stage_inputs = draw_stage_inputs(plan, model, gen)
    else:
        model.load_state_dict(stage_inputs.init_state)
    model = model.to(dev)
    nav_train = data_nav[::plan.sample_stride]

    # ---- 1. k-means on the stratified sample, assign the training rows ----
    train_x = nav_train[stage_inputs.train_idx.to(dev)].float()
    init_stride = max(1, plan.n_train // n_categories)
    centroids = train_x[::init_stride][:n_categories]
    for _ in range(kmeans_iters):
        centroids = _lloyd_step(train_x, centroids)
    labels = kmeans_assign(nav_train, centroids, chunk=chunk)

    # ---- 2. MLP training ----
    model.train()
    losses = run_epochs(model, make_optimizer(model, lr), nav_train, labels,
                        stage_inputs.batches)

    # ---- 3. bucket of every row = the model's argmax ----
    model.eval()
    with torch.no_grad():
        pred = _chunked(lambda b: torch.argmax(model(b), dim=1), data_nav,
                        chunk).to(torch.int32)

    if not include_store:
        counts = torch.bincount(pred.long(), minlength=n_categories).to(
            torch.int32)
        offsets = torch.cat([counts.new_zeros(1),
                             torch.cumsum(counts, 0).to(torch.int32)])
        return BuildResult(
            centroids, model, losses, pred,
            torch.zeros((0, 1), dtype=torch.float32, device=dev),
            torch.zeros((0,), dtype=torch.int32, device=dev), offsets,
            counts, 0)

    # ---- 4. bucket store ----
    data_search = data_search.float()
    if normalize_search:
        data_search = l2_normalize(data_search)
    data_sorted, ids_sorted, offsets, counts, pad_rows = layout_store(
        pred, data_search, n_categories, pad_rows, row_align)
    return BuildResult(centroids, model, losses, pred, data_sorted,
                       ids_sorted, offsets, counts, pad_rows)
