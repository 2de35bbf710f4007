"""Training and inference for the bucket classifier.

One Adam step per batch by default; ``reference_step_semantics=True`` runs
one step per epoch, the reference's last-batch-only loop. Each epoch's batch
order is a permutation of the training rows truncated to
``steps_per_epoch * batch`` rows, as in the JAX package. The optimizer is
``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``, the same update as
optax's ``adam``; the loss is the mean cross-entropy.

`train_lr_sweep` trains one MLP per learning rate at once, as a
`StackedMLP` (one batched product a layer for all of them) under one Adam
step whose learning rate is broadcast on the stack's leading axis.
"""

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from tpulmi_torch.models.mlp import MLP, StackedMLP, make_model
from tpulmi_torch.utils.logging import get_logger
from tpulmi_torch.utils.profiling import resolve_device

log = get_logger("tpulmi_torch.models.train")


def train_plan(
    n: int,
    epochs: int,
    batch_size: int,
    max_train_steps: Optional[int] = None,
    reference_step_semantics: bool = False,
) -> Tuple[int, int, int]:
    """Resolve the training schedule: (epochs, steps_per_epoch, total_steps).

    One Adam step per batch, `n // batch_size` steps per epoch;
    `max_train_steps` caps the total, truncated to whole epochs (at least
    one). With `reference_step_semantics` one step runs per epoch."""
    steps_per_epoch = 1 if reference_step_semantics else max(n // batch_size, 1)
    if max_train_steps:
        capped = max(max_train_steps // steps_per_epoch, 1)
        if capped < epochs:
            log.info(
                "train plan: %d epochs x %d steps exceeds max_train_steps=%d; "
                "training %d epochs (%d steps)",
                epochs, steps_per_epoch, max_train_steps, capped,
                capped * steps_per_epoch,
            )
        epochs = min(epochs, capped)
    return epochs, steps_per_epoch, epochs * steps_per_epoch


def make_optimizer(model: MLP, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def epoch_batches(n: int, steps_per_epoch: int, batch: int,
                  generator: torch.Generator) -> torch.Tensor:
    """One epoch's (steps_per_epoch, batch) shuffled row indices."""
    perm = torch.randperm(n, generator=generator)
    return perm[: steps_per_epoch * batch].reshape(steps_per_epoch, batch)


def run_epochs(model: MLP, opt: torch.optim.Optimizer, X: torch.Tensor,
               y: torch.Tensor, batches: Sequence[torch.Tensor]) -> torch.Tensor:
    """Train over each epoch's (steps, batch) index array in turn; returns
    the (epochs,) mean loss per epoch."""
    losses = []
    for idx in batches:
        idx = idx.to(X.device)
        step_losses = []
        for b in idx:
            loss = F.cross_entropy(model(X[b]), y[b].long())
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            step_losses.append(loss.detach())
        losses.append(torch.stack(step_losses).mean())
    return torch.stack(losses)


def train_lr_sweep(model: Union[str, MLP], X, y, lrs, epochs: int = 8,
                   batch_size: int = 1024, seed: int = 2023,
                   max_train_steps: Optional[int] = None, device="cuda",
                   init_models: Optional[Sequence[MLP]] = None,
                   batches: Optional[Sequence[torch.Tensor]] = None
                   ) -> Tuple[StackedMLP, torch.Tensor]:
    """Train one classifier per learning rate in `lrs` together: every
    model sees the same batches, and one Adam step (optax's ``adam``: b1
    0.9, b2 0.999, eps 1e-8, bias-corrected) updates all of them with its
    own learning rate.

    `model` is a model type name (the classes are the labels' range) or an
    `MLP` whose architecture is used. Each model starts from its own draw
    of a ``torch.Generator`` seeded with `seed`, and each epoch's batches
    are a permutation drawn from one seeded with ``seed + 1`` (the step
    count from `train_plan`). The hooks replace those draws:
    `init_models` (one `MLP` per learning rate) and `batches` (one (steps,
    batch) index array per epoch, as `BucketClassifier.train` takes).

    Returns (stacked, losses): a `StackedMLP` whose leading axis is
    ``len(lrs)``, and the (len(lrs), epochs) mean loss of every epoch."""
    device = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32, device=device)
    y = torch.as_tensor(y, device=device).long()
    n = int(X.shape[0])
    if init_models is None:
        gen = torch.Generator().manual_seed(seed)
        if isinstance(model, str):
            init_models = [make_model(model, int(X.shape[1]),
                                      int(y.max()) + 1, generator=gen)
                           for _ in lrs]
        else:
            init_models = [MLP(model.layers[0].in_features,
                               model.hidden_dims, model.n_classes)
                           for _ in lrs]
            for m in init_models:
                m.reset_parameters(gen)
    if batches is None:
        epochs, spe, _ = train_plan(n, epochs, batch_size, max_train_steps)
        gen = torch.Generator().manual_seed(seed + 1)
        batches = [epoch_batches(n, spe, min(batch_size, n), gen)
                   for _ in range(epochs)]
    stacked = StackedMLP.stack([m.to(device) for m in init_models])
    params = list(stacked.parameters())
    lr = torch.tensor([float(v) for v in lrs], dtype=torch.float32,
                      device=device)
    # each parameter's learning rates, broadcast over its leading axis
    lr_of = [lr.view(-1, *([1] * (p.dim() - 1))) for p in params]
    exp_avg = [torch.zeros_like(p) for p in params]
    exp_avg_sq = [torch.zeros_like(p) for p in params]
    b1, b2, eps = 0.9, 0.999, 1e-8
    step, losses = 0, []
    for idx in batches:
        idx = idx.to(device)
        step_losses = []
        for b in idx:
            logits = stacked(X[b])                       # (L, B, C)
            per_model = F.cross_entropy(
                logits.transpose(1, 2), y[b].expand(len(lr), -1),
                reduction="none").mean(1)
            # the models share no parameter: each one's gradient of the
            # sum is the gradient of its own loss
            grads = torch.autograd.grad(per_model.sum(), params)
            step += 1
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            with torch.no_grad():
                for p, g, m, v, r in zip(params, grads, exp_avg,
                                         exp_avg_sq, lr_of):
                    m.lerp_(g, 1 - b1)
                    v.mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v.sqrt() / math.sqrt(bc2)).add_(eps)
                    p.addcdiv_(m * (r / -bc1), denom)
            step_losses.append(per_model.detach())
        losses.append(torch.stack(step_losses).mean(0))
    return stacked, torch.stack(losses, 1)


class BucketClassifier:
    """Train/serve wrapper around the MLP."""

    def __init__(self, input_dim: int, n_classes: int, lr: float = 0.009,
                 model_type: str = "MLP", seed: int = 2023,
                 device="cuda", model: Optional[MLP] = None):
        """`model` wraps an already trained router instead of a freshly
        initialized one (drawn from `seed`)."""
        self.model_type = model_type
        self.input_dim = input_dim
        self.n_classes = n_classes
        self.lr = lr
        self.seed = seed
        self.device = resolve_device(device)
        if model is None:
            model = make_model(model_type, input_dim, n_classes,
                               generator=torch.Generator().manual_seed(seed))
        self.model = model.to(self.device)
        self.opt = make_optimizer(self.model, lr)

    def train(self, X, y, epochs: int = 100, batch_size: int = 256,
              reference_step_semantics: bool = False,
              max_train_steps: Optional[int] = None,
              batches: Optional[Sequence[torch.Tensor]] = None
              ) -> torch.Tensor:
        """Train on the full dataset; returns per-epoch mean losses.
        `batches` (one (steps, batch) index array per epoch) replaces the
        seeded shuffles."""
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        y = torch.as_tensor(y, device=self.device)
        n = int(X.shape[0])
        if batches is None:
            epochs, spe, _ = train_plan(n, epochs, batch_size,
                                        max_train_steps,
                                        reference_step_semantics)
            gen = torch.Generator().manual_seed(self.seed + 1)
            batches = [epoch_batches(n, spe, min(batch_size, n), gen)
                       for _ in range(epochs)]
        self.model.train()
        return run_epochs(self.model, self.opt, X, y, batches)

    @torch.no_grad()
    def logits(self, X) -> torch.Tensor:
        return self.model(torch.as_tensor(X, device=self.device))

    @torch.no_grad()
    def predict(self, X, chunk: int = 131072) -> torch.Tensor:
        """Argmax bucket of every row, in row chunks (int32)."""
        X = torch.as_tensor(X, device=self.device)
        out = [torch.argmax(self.model(X[s:s + chunk]), dim=1)
               for s in range(0, X.shape[0], chunk)]
        return torch.cat(out).to(torch.int32)

    @torch.no_grad()
    def predict_proba(self, X, top: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Softmax probabilities of each query's `top` best buckets, in
        descending order (ties to the lower bucket id)."""
        probs = torch.softmax(self.logits(X).float(), dim=-1)
        top = self.n_classes if top is None else top
        idx = torch.argsort(probs, dim=1, descending=True, stable=True)[:, :top]
        return torch.gather(probs, 1, idx), idx.to(torch.int32)
