"""The data-parallel navigation build: every navigation stage of an index
build runs over a mesh of ``"data"`` entries, each holding ``n_local`` rows
(the last shard padded with zero rows, which take part in every stage as
they do in the JAX program):

1. k-means: a local subsample of ``m_local`` rows per shard, gathered in
   mesh order; Lloyd on the gathered sample, replicated (the one-hot
   `_lloyd_step`, whose fixed summing order keeps the build
   bit-reproducible); then each shard assigns its own rows;
2. data-parallel Adam (`sharded.DPTrainStep`): local batches of
   ``batch_size // S`` rows, the schedule of `train_plan` in local terms;
3. each shard's argmax predict, gathered in mesh order.

The draws: the initial parameters from ``Generator(seed)``, shared by every
shard; shard s's subsample and epoch permutations from its own
``Generator(seed + 1 + s)`` (the JAX program's ``fold_in(key, s)``).
`draw_dist_inputs` makes them; ``stage_inputs`` replaces them (the tests
feed the JAX program's own).
"""

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from tpulmi_torch.build import StageInputs
from tpulmi_torch.models.mlp import MLP, make_model
from tpulmi_torch.models.train import train_plan
from tpulmi_torch.ops.kmeans import _lloyd_step, kmeans_assign
from tpulmi_torch.parallel.mesh import Mesh, check_mesh, gather_entries
from tpulmi_torch.parallel.sharded import DPTrainStep


class DistNavResult(NamedTuple):
    centroids: torch.Tensor  # (k, d) replicated
    model: MLP               # the trained router
    losses: torch.Tensor     # (epochs,) mean CE per epoch
    pred: torch.Tensor       # (S * n_local,) int32 bucket per row, mesh order


class DistPlan(NamedTuple):
    n_shards: int
    n_local: int
    m_local: int             # k-means subsample rows per shard
    local_batch: int
    epochs: int
    steps_per_epoch: int


def dist_plan(n_shards: int, n_local: int, *, kmeans_train_points: int,
              epochs: int, batch_size: int,
              max_train_steps=None) -> DistPlan:
    """The JAX program's sizes: the global batch split over the shards and
    the schedule in local terms, so that an epoch's permutation slice
    always covers steps * batch rows."""
    local_batch = min(max(batch_size // n_shards, 1), n_local)
    epochs, spe, _ = train_plan(n_local, epochs, local_batch,
                                max_train_steps)
    return DistPlan(n_shards, n_local,
                    max(min(n_local, kmeans_train_points // n_shards), 1),
                    local_batch, epochs, spe)


def draw_dist_inputs(plan: DistPlan, model: MLP, seed: int) -> StageInputs:
    """Seeded draws of every shard, with a leading shard axis:
    ``train_idx`` (S, m_local) and, per epoch, ``batches`` (S,
    steps_per_epoch, local_batch)."""
    gens = [torch.Generator().manual_seed(seed + 1 + s)
            for s in range(plan.n_shards)]
    train_idx = torch.stack([torch.randperm(plan.n_local, generator=g)[
        :plan.m_local] for g in gens])
    rows = plan.steps_per_epoch * plan.local_batch
    per_shard = [[torch.randperm(plan.n_local, generator=g)[:rows]
                  for _ in range(plan.epochs)] for g in gens]
    batches = [torch.stack([per_shard[s][e] for s in range(plan.n_shards)])
               .reshape(plan.n_shards, plan.steps_per_epoch,
                        plan.local_batch) for e in range(plan.epochs)]
    return StageInputs(train_idx, batches,
                       {k: v.clone() for k, v in model.state_dict().items()})


def shard_rows(data, mesh: Mesh):
    """(n, d) host rows -> (per mesh entry, an (n_local, d) float32 tensor
    on its device, None where another process owns it; n_local). The last
    shard is padded with zero rows."""
    check_mesh(mesh)
    data = np.asarray(data, np.float32)
    n, d = data.shape
    n_local = -(-n // mesh.size)
    local = set(mesh.local_entries())
    out: List[Optional[torch.Tensor]] = []
    for s, dev in enumerate(mesh.devices.flat):
        if s not in local:
            out.append(None)
            continue
        part = torch.zeros((n_local, d), dtype=torch.float32, device=dev)
        rows = data[s * n_local:(s + 1) * n_local]
        part[:len(rows)] = torch.from_numpy(rows)
        out.append(part)
    return out, n_local


def dist_nav(shards: List[Optional[torch.Tensor]], mesh: Mesh, *,
             model_type: str, lr: float, n_categories: int,
             kmeans_iters: int, kmeans_train_points: int, epochs: int,
             batch_size: int, max_train_steps=None, seed: int = 2023,
             stage_inputs: Optional[StageInputs] = None,
             chunk: int = 262144) -> DistNavResult:
    """The navigation stages over `mesh` on `shards` (from `shard_rows`).
    Every process returns the same result."""
    local = mesh.local_entries()
    n_local, d_nav = (int(x) for x in shards[local[0]].shape)
    plan = dist_plan(mesh.size, n_local,
                     kmeans_train_points=kmeans_train_points, epochs=epochs,
                     batch_size=batch_size, max_train_steps=max_train_steps)
    model = make_model(model_type, d_nav, n_categories,
                       generator=torch.Generator().manual_seed(seed))
    if stage_inputs is None:
        stage_inputs = draw_dist_inputs(plan, model, seed)
    else:
        model.load_state_dict(stage_inputs.init_state)
    home = shards[local[0]].device

    # ---- 1. k-means: local subsamples, gathered; replicated Lloyd; local
    # assignment ----
    train_x = gather_entries(
        [shards[s][stage_inputs.train_idx[s].to(shards[s].device)]
         for s in local], mesh, home).reshape(-1, d_nav)
    centroids = train_x[:n_categories]
    for _ in range(kmeans_iters):
        centroids = _lloyd_step(train_x, centroids)
    labels = {s: kmeans_assign(shards[s], centroids, chunk=chunk)
              for s in local}

    # ---- 2. data-parallel training: each device's entries stacked ----
    step = DPTrainStep(model, lr, mesh)
    xs, ys, idx = [], [], []
    for dev, group in zip(step.devices, step.groups):
        xs.append(torch.stack([shards[s] for s in group]))
        ys.append(torch.stack([labels[s].to(dev) for s in group]))
        idx.append(torch.cat([b[group] for b in stage_inputs.batches],
                             dim=1).to(dev))   # (n_g, steps, batch)
    rows = [torch.arange(x.shape[0], device=x.device)[:, None] for x in xs]
    step_losses = []
    for t in range(plan.epochs * plan.steps_per_epoch):
        step_losses.append(step.step_groups(
            [x[r, i[:, t]] for x, r, i in zip(xs, rows, idx)],
            [y[r, i[:, t]] for y, r, i in zip(ys, rows, idx)]))
    losses = torch.stack(step_losses).reshape(
        plan.epochs, plan.steps_per_epoch).mean(1)

    # ---- 3. each shard's argmax predict ----
    with torch.no_grad():
        preds = [torch.cat([
            torch.argmax(step.replica(shards[s].device)(shards[s][r:r + chunk]),
                         dim=1) for r in range(0, n_local, chunk)]).to(
                             torch.int32) for s in local]
    pred = gather_entries(preds, mesh, home).reshape(-1)
    return DistNavResult(centroids, step.model, losses, pred)
