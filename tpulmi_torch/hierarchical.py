"""Two-level hierarchical learned index: a factorized router over one flat
store.

An outer MLP scores G groups, G inner MLPs (one architecture, their weights
stacked on a leading group axis) score C buckets within each group, and the
joint score of global bucket ``g * C + b`` is

    score(g, b) = w * log P(g | q) + log P(b | q, g)

one (Q, G*C) logit matrix. Everything after the routing (the probe kernels,
the merge, quantization and the host rerank, `search_stream`, checkpoints)
is the flat `LearnedIndex`'s, unchanged: the hierarchy adds no kernel.

- `JointRouter`: the router as one `nn.Module`; the inner stack is applied
  with one batched product per layer, no loop over groups.
- `HierarchicalIndex.build` / `build_with_host_store`: the outer router on
  the whole corpus, one inner build per group (rows padded to a size class
  by resampling the group), the joint argmax of every row as its bucket;
  ``router_restarts > 1`` builds that many candidates and keeps the one
  with the best pseudo-query containment.
- `calibrate_outer_weight`: the outer weight w and the probe-mass
  temperature fitted against each pseudo-query's nearest neighbour's
  stored bucket, with no labelled queries.

Spans (`utils/profiling.py`): ``hier.outer`` (the outer router's build),
``hier.inner`` (the G inner builds, one after another) and
``hier.calibrate``, whose host-clock seconds a build also keeps in
``last_build_stages`` as ``outer``, ``inner`` and ``calibrate`` (summed
over the candidates of a build with restarts); ``route.joint`` around
`JointRouter.forward`, which adds Q * G * C to the counter
``route_joint_scores``.

The JAX package's twin is ``tpulmi/hierarchical.py``; numpy draws (the
size-class fill, the pseudo-queries) are the same in both packages.
"""

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tpulmi_torch.buckets import bucket_stats, build_bucket_store
from tpulmi_torch.build import BuildPlan, StageInputs, build_plan, fused_build
from tpulmi_torch.index import BuiltIndex, LearnedIndex
# StackedMLP lives beside MLP; imported here under its old home too
from tpulmi_torch.models.mlp import MLP, MODEL_HIDDEN_DIMS, StackedMLP
from tpulmi_torch.ops.distance import l2_normalize
from tpulmi_torch.search import size_class
from tpulmi_torch.utils.config import IndexConfig
from tpulmi_torch.utils.logging import get_logger
from tpulmi_torch.utils.profiling import count, span, sync

log = get_logger("tpulmi_torch.hierarchical")

# the w grid of the calibration and of the restart scorer
CALIBRATION_GRID = (0.0, 0.1, 0.25, 0.4, 0.55, 0.7, 0.85, 1.0)
# Past this many rows an inner build trains on at most INNER_CAP rows of
# its group, sampled: the JAX package's rule, kept because it decides
# which rows train
GATHER_SAFE_ROWS = 8_388_608
INNER_CAP = 1_048_576


@dataclass(frozen=True)
class HierarchicalConfig:
    n_groups: int = 8
    outer_epochs: int = 8
    outer_lr: float = 0.003
    outer_model_type: str = "MLP-5"
    inner: IndexConfig = field(default_factory=IndexConfig)
    seed: int = 2023
    # calibrate_outer_weight at this probe budget at the end of every
    # build; 0 disables
    calibrate_budget: int = 16
    # build the navigation stack (outer + inners) this many times under
    # seeds seed + 1000 r and keep the candidate with the best pseudo-query
    # containment at calibrate_budget (16 when that is 0) probes; 1
    # disables
    router_restarts: int = 1


class JointRouter(nn.Module):
    """``forward(x)``: the (Q, G*C) joint logits ``outer_weight * log
    P(g|q) + log P(b|q,g)``, group-major (column ``g * C + b``).

    ``outer_weight`` (w) flattens the group term so that the top probes
    spread over plausible groups (w=1 concentrates them in the top group);
    ``mass_temp`` is the temperature of the truncation mass of
    ``SearchConfig.probe_mass`` (`search.routing_logits`). Both are plain
    attributes read at every call: `calibrate_outer_weight` fits them."""

    def __init__(self, outer: MLP, inner: StackedMLP, n_groups: int,
                 n_cat: int, outer_weight: float = 1.0,
                 mass_temp: float = 1.0):
        super().__init__()
        self.outer = outer
        self.inner = inner
        self.n_groups = n_groups
        self.n_cat = n_cat
        self.outer_weight = float(outer_weight)
        self.mass_temp = float(mass_temp)

    @classmethod
    def empty(cls, outer_model_type: str, inner_model_type: str,
              input_dim: int, n_groups: int, n_cat: int) -> "JointRouter":
        """A router of the given shape to load a state_dict into."""
        for t in (outer_model_type, inner_model_type):
            if t not in MODEL_HIDDEN_DIMS:
                raise ValueError(f"Unknown model_type {t!r}; expected one "
                                 f"of {sorted(MODEL_HIDDEN_DIMS)}")
        return cls(MLP(input_dim, MODEL_HIDDEN_DIMS[outer_model_type],
                       n_groups),
                   StackedMLP(n_groups, input_dim,
                              MODEL_HIDDEN_DIMS[inner_model_type], n_cat),
                   n_groups, n_cat)

    def components(self, x: torch.Tensor):
        """(outer log-softmax (Q, G), inner log-softmax (Q, G, C)),
        unweighted."""
        x = x.float()
        lo = torch.log_softmax(self.outer(x), dim=-1)
        li = torch.log_softmax(self.inner(x), dim=-1)      # (G, Q, C)
        return lo, li.transpose(0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("route.joint"):
            count("route_joint_scores",
                  int(x.shape[0]) * self.n_groups * self.n_cat)
            lo, li = self.components(x)
            joint = self.outer_weight * lo[:, :, None] + li
            return joint.reshape(x.shape[0], self.n_groups * self.n_cat)


class JointRouterClassifier:
    """What the flat index needs of its router (`model`, `input_dim`,
    `n_classes`, `model_type`, `predict`), over a `JointRouter`."""

    def __init__(self, model: JointRouter, input_dim: int, model_type: str):
        self.model = model
        self.input_dim = input_dim
        self.n_classes = model.n_groups * model.n_cat
        self.model_type = model_type

    @torch.no_grad()
    def predict(self, X, chunk: int = 131072) -> torch.Tensor:
        """Joint-argmax global bucket of every row (int32, on the router's
        device), in row chunks, each cast to float32 on the device: a
        bfloat16 corpus needs no float32 copy. The outer weight is read
        at the call."""
        dev = self.model.outer.layers[0].weight.device
        out = [torch.argmax(self.model(
                   torch.as_tensor(X[s:s + chunk], device=dev).float()), 1)
               for s in range(0, X.shape[0], chunk)]
        return torch.cat(out).to(torch.int32)


def _rows(data_nav, idx) -> np.ndarray:
    """Rows `idx` of a host array (numpy, a memory map or a `HostBF16`) as
    float32; only those rows are read."""
    return np.asarray(data_nav[idx], np.float32)


class HierarchicalIndex(LearnedIndex):
    """A flat `LearnedIndex` over G*C buckets with a `JointRouter`. Search,
    quantization, rerank, the stream and checkpoints are inherited.

    ``stage_inputs``: None, or a callable ``(seed, plan, model_type,
    n_categories, d_nav) -> StageInputs`` that replaces the random draws
    of each navigation stage's `fused_build` (the tests feed the JAX
    package's)."""

    def __init__(self, config: HierarchicalConfig = HierarchicalConfig(),
                 device="cuda"):
        super().__init__(config.inner, device=device)
        self.hconfig = config
        # host seconds of the hierarchy's build stages (`_stage`) in the
        # build under way
        self._stage_s = {}
        # per-candidate containment of the last build with restarts > 1
        self._router_restart_scores = None
        self.stage_inputs: Optional[Callable[..., StageInputs]] = None

    # ------------------------------------------------------------------ build
    @contextmanager
    def _stage(self, name: str):
        """A build stage: the span ``hier.<name>``, its host seconds added
        to ``_stage_s[name]``. It adds no synchronization: a stage that
        ends in a read from the card (the outer build's groups, the
        calibration's components) waits for its work there."""
        start = time.perf_counter()
        with span(f"hier.{name}"):
            yield
        self._stage_s[name] = (self._stage_s.get(name, 0.0)
                               + time.perf_counter() - start)

    def _calibrate_stage(self, data_nav, stages: dict) -> None:
        """The calibration at ``calibrate_budget`` probes, when it is set,
        as the stage ``calibrate``; then ``last_build_stages`` is `stages`
        (the build's own) with the hierarchy's."""
        if self.hconfig.calibrate_budget:
            with self._stage("calibrate"):
                self.calibrate_outer_weight(
                    data_nav, probe_budget=self.hconfig.calibrate_budget)
        self.last_build_stages = {**stages, **self._stage_s}

    def _build_navigation(self, data_nav):
        """The outer router, one inner router per group and the joint
        argmax of every row; with ``router_restarts > 1`` the best of that
        many candidates: the params of a loser (or a dethroned winner)
        move to the CPU at once, its centroids are dropped. Returns
        (classifier, pred (numpy int32), outer centroids)."""
        hcfg = self.hconfig
        self._router_restart_scores = None
        self._stage_s = {}
        nav = self._nav_tensor(data_nav)
        restarts = max(1, int(hcfg.router_restarts))
        if restarts == 1:
            classifier, centroids = self._build_nav_candidate(nav, hcfg.seed)
        else:
            budget = hcfg.calibrate_budget or 16
            qidx, nn_global = self._nn_pseudo_queries(data_nav,
                                                      seed=hcfg.seed + 311)
            best, scores = None, []
            for r in range(restarts):
                cand, cents = self._build_nav_candidate(
                    nav, hcfg.seed + 1000 * r)
                score, per_w = self._containment_score(
                    cand, data_nav, qidx, nn_global, budget)
                scores.append(score)
                log.info("router restart %d/%d: containment@%d = %.4f "
                         "(per-w %s)", r + 1, restarts, budget, score,
                         ["%.4f" % c for c in per_w])
                if best is None or score > best[0]:
                    if best is not None:
                        best[1].model.to("cpu")
                    best = (score, cand, cents)
                else:
                    cand.model.to("cpu")
                del cand, cents
            log.info("router restarts: selected containment@%d = %.4f",
                     budget, best[0])
            self._router_restart_scores = scores
            _, classifier, centroids = best
        pred = classifier.predict(nav).cpu().numpy()
        return classifier, pred, centroids

    def _nav_stage(self, nav: torch.Tensor, seed: int, model_type: str,
                   lr: float, n_categories: int, epochs: int):
        """One navigation-only `fused_build` (k-means, training, predict)
        with the inner config's batch, step cap and k-means settings."""
        cfg = self.hconfig.inner
        kpts = cfg.kmeans_max_points_per_centroid * n_categories
        inputs = None
        if self.stage_inputs is not None:
            plan: BuildPlan = build_plan(
                int(nav.shape[0]), kmeans_train_points=kpts, epochs=epochs,
                batch_size=cfg.batch_size,
                max_train_steps=cfg.max_train_steps)
            inputs = self.stage_inputs(seed, plan, model_type, n_categories,
                                       int(nav.shape[1]))
        return fused_build(
            nav, None, model_type=model_type, lr=lr,
            n_categories=n_categories, kmeans_iters=cfg.kmeans_iters,
            kmeans_train_points=kpts, epochs=epochs,
            batch_size=cfg.batch_size, max_train_steps=cfg.max_train_steps,
            seed=seed, stage_inputs=inputs, include_store=False)

    def _build_nav_candidate(self, nav: torch.Tensor, seed: int):
        """One navigation stack built under `seed`: the outer build at G
        categories, then one inner build per group on its rows, padded to
        ``size_class(max(rows, batch_size))`` by rows drawn from the group
        (``default_rng(seed + 17)``, the JAX package's draws). Returns
        (classifier on the index's device, outer centroids)."""
        hcfg, cfg = self.hconfig, self.hconfig.inner
        G, C = hcfg.n_groups, cfg.n_categories
        n, d_nav = int(nav.shape[0]), int(nav.shape[1])
        with self._stage("outer"):
            outer = self._nav_stage(nav, seed, hcfg.outer_model_type,
                                    hcfg.outer_lr, G, hcfg.outer_epochs)
            groups = outer.pred_categories.cpu().numpy()
        log.info("outer router: %d groups, sizes %s", G,
                 np.bincount(groups, minlength=G).tolist())
        rng = np.random.default_rng(seed + 17)
        gather_safe = n <= GATHER_SAFE_ROWS
        inner = []
        with self._stage("inner"):
            for g in range(G):
                idx = np.where(groups == g)[0]
                if not gather_safe and idx.size > INNER_CAP:
                    idx = np.sort(rng.choice(idx, size=INNER_CAP,
                                             replace=False))
                m_pad = size_class(max(idx.size, cfg.batch_size))
                if idx.size:
                    idx_pad = np.concatenate(
                        [idx, rng.choice(idx, size=m_pad - idx.size,
                                         replace=True)])
                else:
                    idx_pad = np.zeros((m_pad,), np.int64)
                rows = nav[torch.as_tensor(idx_pad, device=nav.device)]
                res = self._nav_stage(rows, seed + 100 + g, cfg.model_type,
                                      cfg.lr, C, cfg.epochs)
                inner.append(res.model)
                log.info("inner %d/%d: %d rows (padded %d)", g + 1, G,
                         idx.size, m_pad)
        router = JointRouter(outer.model, StackedMLP.stack(inner), G, C)
        classifier = JointRouterClassifier(
            router, d_nav,
            model_type=f"hier{G}:{hcfg.outer_model_type}:{cfg.model_type}")
        return classifier, outer.centroids

    def build(self, data_nav, data_search=None, **_ignored
              ) -> Tuple[np.ndarray, float]:
        """The store on the index's device (`build_bucket_store` over G*C
        buckets), then the calibration. Returns (pred_categories,
        build_seconds); ``last_build_stages`` holds the hierarchy's
        stages."""
        start = time.perf_counter()
        hcfg, cfg = self.hconfig, self.hconfig.inner
        classifier, pred, centroids = self._build_navigation(data_nav)
        if data_search is None:
            data_search = data_nav
        store = build_bucket_store(
            torch.as_tensor(pred, device=self.device),
            l2_normalize(self._tensor(np.asarray(data_search, np.float32))),
            hcfg.n_groups * cfg.n_categories, row_align=cfg.row_align)
        sync(self.device)
        build_time = time.perf_counter() - start
        mx, mn, mean = bucket_stats(store)
        log.info("hierarchical build: N=%d groups=%d buckets=%d size "
                 "max/mean/min=%d/%.0f/%d; %.1fs", store.n, hcfg.n_groups,
                 store.n_categories, mx, mean, mn, build_time)
        self._set_built(BuiltIndex(
            centroids, classifier, store,
            torch.as_tensor(pred, device=self.device), cfg, mx))
        self._calibrate_stage(data_nav, {})
        return pred, build_time

    def build_with_host_store(self, data_nav, data_search_host,
                              normalized: bool = False,
                              store_dtype: str = "bfloat16",
                              overlap_upload: bool = False, mesh=None
                              ) -> Tuple[np.ndarray, float]:
        """`LearnedIndex.build_with_host_store` over G*C buckets with this
        index's navigation stages, then the calibration. A ``mesh`` of G
        entries places one group per shard (``cat_pad == C``): the
        configuration whose store no single card holds.
        ``last_build_stages`` gains ``outer``, ``inner`` (both inside
        ``nav``) and ``calibrate`` (after ``total``)."""
        out = super().build_with_host_store(
            data_nav, data_search_host, normalized=normalized,
            store_dtype=store_dtype, overlap_upload=overlap_upload,
            mesh=mesh)
        self._calibrate_stage(data_nav, self.last_build_stages)
        return out

    # ------------------------------------------------------------ calibration
    @torch.no_grad()
    def _nn_pseudo_queries(self, data_nav, n_queries: int = 2048,
                           n_corpus_sample: int = 131072, seed: int = 97
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Label-free routing targets: `n_queries` corpus rows as
        pseudo-queries and each one's self-excluded nearest neighbour
        (cosine, navigation space) among `n_corpus_sample` sampled rows,
        found on the index's device. Returns (qidx, nn_global), global row
        indices."""
        rng = np.random.default_rng(seed)
        n = int(data_nav.shape[0])
        n_queries = min(n_queries, n)
        n_corpus_sample = min(n_corpus_sample, n)
        qidx = rng.choice(n, size=n_queries, replace=False)
        sidx = rng.choice(n, size=n_corpus_sample, replace=False)
        corpus = l2_normalize(self._tensor(_rows(data_nav, sidx)))
        sidx_dev = torch.as_tensor(sidx, device=self.device)
        nn_local = []
        for lo in range(0, n_queries, 512):
            part = qidx[lo:lo + 512]
            q = l2_normalize(self._tensor(_rows(data_nav, part)))
            sims = q @ corpus.T
            own = sidx_dev[None, :] == torch.as_tensor(
                part, device=self.device)[:, None]
            sims = sims.masked_fill(own, -torch.inf)
            nn_local.append(torch.argmax(sims, dim=1).cpu().numpy())
        return qidx, sidx[np.concatenate(nn_local)]

    @staticmethod
    @torch.no_grad()
    def _router_components(classifier, data_nav, qidx, chunk: int = 512):
        """The router's outer and inner log-softmax at the rows `qidx`:
        ((Qs, G), (Qs, G, C)) numpy float32."""
        model = classifier.model
        dev = model.outer.layers[0].weight.device
        lo_parts, li_parts = [], []
        for s in range(0, len(qidx), chunk):
            x = torch.as_tensor(_rows(data_nav, qidx[s:s + chunk]),
                                device=dev)
            lo, li = model.components(x)
            lo_parts.append(lo.cpu().numpy())
            li_parts.append(li.cpu().numpy())
        return np.concatenate(lo_parts), np.concatenate(li_parts)

    @staticmethod
    def _contained(lo_all, li_all, target, budget: int, grid) -> list:
        """Per w of `grid`: the share of rows whose `target` bucket is
        among the `budget` best of ``w * lo + li``."""
        n_q, gxc = len(target), lo_all.shape[1] * li_all.shape[2]
        out = []
        for w in grid:
            joint = (w * lo_all[:, :, None] + li_all).reshape(n_q, gxc)
            top = np.argpartition(-joint, budget - 1, axis=1)[:, :budget]
            out.append(float(np.mean((top == target[:, None]).any(axis=1))))
        return out

    def _containment_score(self, classifier, data_nav, qidx: np.ndarray,
                           nn_global: np.ndarray, budget: int,
                           grid: Tuple[float, ...] = CALIBRATION_GRID
                           ) -> Tuple[float, list]:
        """Score a candidate router before any store exists: the target of
        each pseudo-query is the candidate's own joint argmax of its
        neighbour, the score the best containment at `budget` probes over
        the w grid (what calibration would realize). Only the distinct
        neighbour rows are predicted. Returns (max, per-w list). Fair only
        between candidates of one recipe: a count of probes does not price
        bucket sizes."""
        nn_unique, inv = np.unique(nn_global, return_inverse=True)
        tb = classifier.predict(_rows(data_nav, nn_unique)).cpu().numpy()
        lo_all, li_all = self._router_components(classifier, data_nav, qidx)
        budget = min(budget, lo_all.shape[1] * li_all.shape[2])
        per_w = self._contained(lo_all, li_all, tb[inv], budget, grid)
        return max(per_w), per_w

    def set_outer_weight(self, w: float) -> None:
        """Set the router's outer weight; drops the search programs made
        for the old one."""
        if self.built is None:
            raise ValueError("Index is not built, call `build` first.")
        self.built.classifier.model.outer_weight = float(w)
        self._search_programs = {}

    def set_mass_temp(self, t: float) -> None:
        """Set the probe-mass temperature (`JointRouter.mass_temp`); drops
        the search programs."""
        if self.built is None:
            raise ValueError("Index is not built, call `build` first.")
        self.built.classifier.model.mass_temp = float(t)
        self._search_programs = {}

    def calibrate_outer_weight(self, data_nav, probe_budget: int = 16,
                               n_queries: int = 2048,
                               n_corpus_sample: int = 131072,
                               grid: Tuple[float, ...] = CALIBRATION_GRID,
                               seed: int = 97, apply: bool = True) -> dict:
        """Pick the outer weight that maximizes routing containment at the
        probe budget with no labelled queries: for each w of `grid`, the
        share of pseudo-queries whose nearest neighbour's stored bucket
        (`pred_categories`) is among their top `probe_budget` joint
        scores. Then fit the probe-mass temperature: the smallest of 1, 2,
        4, ..., 128 at which, for every target mass m of 0.8, 0.9, 0.95,
        at least a share m of the contained targets has less than m of the
        softmax(score / tau) mass ranked before it.

        Returns {"weights", "containment", "best", "best_containment",
        "baseline_w1", "probe_budget", "mass_temp"}; applies w and the
        temperature unless ``apply=False``."""
        if self.built is None:
            raise ValueError("Index is not built, call `build` first.")
        qidx, nn_global = self._nn_pseudo_queries(
            data_nav, n_queries=n_queries, n_corpus_sample=n_corpus_sample,
            seed=seed)
        n_queries = len(qidx)
        target = self.built.pred_categories.cpu().numpy()[nn_global]
        lo_all, li_all = self._router_components(self.built.classifier,
                                                 data_nav, qidx)
        gxc = lo_all.shape[1] * li_all.shape[2]
        budget = min(probe_budget, gxc)
        containment = self._contained(lo_all, li_all, target, budget, grid)
        best_i = int(np.argmax(containment))
        baseline = containment[grid.index(1.0)] if 1.0 in grid else None

        w_best = float(grid[best_i])
        joint = (w_best * lo_all[:, :, None] + li_all).reshape(n_queries, gxc)
        order = np.argsort(-joint, axis=1)
        ranks = np.empty_like(order)
        np.put_along_axis(
            ranks, order, np.broadcast_to(np.arange(gxc), order.shape), 1)
        r_t = ranks[np.arange(n_queries), target]
        in_budget = r_t < budget
        mass_temp = None
        if in_budget.any():
            rows = np.arange(n_queries)
            for tau in (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0):
                z = joint / tau
                z -= z.max(axis=1, keepdims=True)
                p = np.exp(z)
                p /= p.sum(axis=1, keepdims=True)
                sp = np.take_along_axis(p, order, 1)
                cum = np.cumsum(sp, axis=1)
                cb = (cum[rows, r_t] - sp[rows, r_t])[in_budget]
                if all(float(np.mean(cb < m)) >= m for m in (0.8, 0.9, 0.95)):
                    mass_temp = tau
                    break
            if mass_temp is None:
                mass_temp = 128.0

        result = {
            "weights": list(grid),
            "containment": containment,
            "best": w_best,
            "best_containment": containment[best_i],
            "baseline_w1": baseline,
            "probe_budget": budget,
            "mass_temp": mass_temp,
        }
        log.info("router calibration @%d probes: %s -> w=%.2f (containment "
                 "%.4f, w=1 %.4f), mass_temp=%s", budget,
                 ["%.2f:%.4f" % (w, c) for w, c in zip(grid, containment)],
                 w_best, result["best_containment"],
                 -1.0 if baseline is None else baseline, mass_temp)
        if apply:
            self.set_outer_weight(w_best)
            if mass_temp is not None:
                self.set_mass_temp(mass_temp)
        return result

    # ----------------------------------------------------------------- search
    def search(self, queries_nav, queries_search=None, n_buckets: int = 4,
               k: int = 10, n_groups: Optional[int] = None,
               search_config=None, queries_search_host=None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """The flat search over the joint router's top `n_buckets` global
        buckets; ``n_groups`` multiplies the budget (``n_groups *
        n_buckets`` probes), the staged two-level reading of it. A sharded
        index searches its shards."""
        if n_groups:
            n_buckets = n_groups * n_buckets
        return super().search(queries_nav, queries_search,
                              n_buckets=n_buckets, k=k,
                              search_config=search_config,
                              queries_search_host=queries_search_host)

    # ------------------------------------------------------------ checkpoint
    def save(self, path: str, include_corpus: bool = False) -> None:
        """The flat checkpoint plus ``hier.json``: the hierarchy's config,
        the outer weight and the probe-mass temperature."""
        super().save(path, include_corpus=include_corpus)
        hcfg, model = self.hconfig, self.built.classifier.model
        with open(Path(path).absolute() / "hier.json", "w") as f:
            json.dump({
                "n_groups": hcfg.n_groups,
                "outer_epochs": hcfg.outer_epochs,
                "outer_lr": hcfg.outer_lr,
                "outer_model_type": hcfg.outer_model_type,
                "seed": hcfg.seed,
                "calibrate_budget": hcfg.calibrate_budget,
                "router_restarts": hcfg.router_restarts,
                "outer_weight": float(model.outer_weight),
                "mass_temp": float(model.mass_temp),
            }, f)

    @classmethod
    def _restore_router(cls, path: Path, meta: dict, params: dict, device):
        with open(path / "hier.json") as f:
            h = json.load(f)
        outer_weight = float(h.pop("outer_weight", 1.0))
        mass_temp = float(h.pop("mass_temp", 1.0))
        inner = IndexConfig(**meta["config"])
        cfg = HierarchicalConfig(inner=inner, **h)
        index = cls(cfg, device=device)
        router = JointRouter.empty(cfg.outer_model_type, inner.model_type,
                                   meta["input_dim"], cfg.n_groups,
                                   inner.n_categories)
        router.load_state_dict({name: torch.as_tensor(p)
                                for name, p in params.items()})
        router.outer_weight, router.mass_temp = outer_weight, mass_temp
        return index, JointRouterClassifier(router.to(index.device),
                                            meta["input_dim"],
                                            meta["model_type"])
