"""The system under test: `tpulmi_torch.LearnedIndex`, built and searched
as a configuration file says. This is the only module that imports the
program.

A configuration's ``build.method`` is the facade's entry point
(``build`` or ``build_with_host_store``) and its other keys that entry's
arguments; ``index`` is the `IndexConfig`, ``search`` the `SearchConfig`
with ``n_buckets``, ``quantize`` an optional `LearnedIndex.quantize`
after the build. An optional ``hierarchy`` holds `HierarchicalConfig`'s
fields but ``inner``: the index is then a `HierarchicalIndex` whose inner
routers take ``index``, over ``n_groups * index.n_categories`` buckets,
and ``search.n_buckets`` counts probes over all of them. ``control``
names what the control switches: the program's own path one precision
below the configuration's.
"""

import copy
import gc

import numpy as np
import torch

from tpulmi_torch.hierarchical import HierarchicalConfig, HierarchicalIndex
from tpulmi_torch.hoststore import HostBF16
from tpulmi_torch.index import LearnedIndex
from tpulmi_torch.utils.config import IndexConfig, SearchConfig

from lmibench.workmodel import Layout


def with_control(config: dict) -> dict:
    """The configuration with its control's switches applied."""
    out = copy.deepcopy(config)
    for part, values in config["control"]["switch"].items():
        if values is None:
            out[part] = None
        else:
            out[part] = {**(out.get(part) or {}), **values}
    return out


def _host(array, dtype):
    """A benchmark host array as the program takes it: bfloat16 bits as a
    `HostBF16`, float32 as it is."""
    return HostBF16(array) if dtype == "bfloat16" else array


class System:
    def __init__(self, config: dict, device):
        self.config = config
        hierarchy = config.get("hierarchy")
        if hierarchy is None:
            self.index = LearnedIndex(IndexConfig(**config["index"]),
                                      device=device)
        else:
            # an unknown key, ``inner`` among them, raises here
            self.index = HierarchicalIndex(
                HierarchicalConfig(inner=IndexConfig(**config["index"]),
                                   **hierarchy), device=device)
        search = dict(config["search"])
        self.n_buckets = search.pop("n_buckets")
        self.k = config["k"]
        self.scfg = SearchConfig(k=self.k, n_buckets=self.n_buckets,
                                 **search)

    def build(self, search_rows, nav_rows) -> None:
        """The build, from the benchmark's host arrays to an index ready
        for search (the facade synchronizes the card before it returns)."""
        data = self.config["data"]
        build = dict(self.config["build"])
        method = build.pop("method")
        search_rows = _host(search_rows, data["search_dtype"])
        nav_rows = _host(nav_rows, data["nav_dtype"])
        getattr(self.index, method)(nav_rows, search_rows, **build)
        quantize = self.config.get("quantize")
        if quantize:
            self.index.quantize(**quantize)
        if self.index.device.type == "cuda":
            torch.cuda.synchronize(self.index.device)

    def search(self, queries_nav: np.ndarray, queries_search: np.ndarray):
        """One request: host float32 queries in, (dists, 1-based ids) on
        the host out."""
        return self.index.search(queries_nav, queries_search,
                                 n_buckets=self.n_buckets, k=self.k,
                                 search_config=self.scfg)

    def build_stages(self) -> dict:
        return dict(getattr(self.index, "last_build_stages", None) or {})

    @torch.no_grad()
    def route(self, queries_nav: np.ndarray) -> np.ndarray:
        """The buckets the built router sends each query to (Q, P): one
        routing outside the window, for the work model. Under a hierarchy
        the model is the joint router, whose logits span all G*C
        buckets."""
        model = self.index.built.classifier.model
        q = torch.as_tensor(queries_nav, dtype=torch.float32,
                            device=self.index.device)
        logits = model(q)
        p = min(self.n_buckets, logits.shape[1])
        return torch.topk(logits, p, dim=1).indices.cpu().numpy()

    def layout(self) -> Layout:
        """The built store as the work model counts it."""
        store = self.index.built.store
        d = int(self.config["d_search"])
        quant_bits = store.quant_bits if store.is_quantized else 0
        if quant_bits:
            row_bytes = d * quant_bits / 8 + 4 + 4       # codes, scale, id
        else:
            row_bytes = d * 2 + 4     # searched in bfloat16 (the cast copy)
        int8_queries = bool(quant_bits and self.scfg.int8_queries)
        query_bytes = d + 4 if int8_queries else d * 2
        rerank = (quant_bits and self.scfg.rerank
                  and self.index._host_corpus is not None)
        list_k = self.k + (self.index._resolve_rerank_extra(self.scfg)
                           if rerank else 0)
        return Layout(rows=store.counts.cpu().numpy().astype(np.int64), d=d,
                      row_bytes=row_bytes, query_bytes=query_bytes,
                      list_k=list_k)

    def close(self) -> None:
        """Free the index: its card memory and its host copies."""
        self.index = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
