"""tpulmi_torch stands alone: it imports neither JAX nor the JAX package,
and its entry points never fall back from the card to the CPU."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpulmi_torch
from tpulmi_torch import LearnedIndex
from tpulmi_torch.convert import store_from_arrays
from tpulmi_torch.models.train import BucketClassifier

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "tpulmi"):
    sys.modules[name] = None
import numpy as np, torch
torch.set_num_threads(1)
import tpulmi_torch
from tpulmi_torch import IndexConfig, LearnedIndex
from tpulmi_torch.data import synthetic_dataset
ds = synthetic_dataset(n=3000, n_queries=20, d_nav=16, d_search=32,
                       n_clusters=6, seed=1)
li = LearnedIndex(IndexConfig(n_categories=6, epochs=2), device="cpu")
li.build(ds["data_nav"], ds["data_search"])
d, ids = li.search(ds["queries_nav"], ds["queries_search"], n_buckets=2)
assert d.shape == ids.shape == (20, 10) and ids.min() >= 1
import tempfile
from tpulmi_torch import SearchConfig
li.quantize(host_corpus=ds["data_search"], normalized=True, bits=4)
with tempfile.TemporaryDirectory() as tmp:
    li.save(tmp, include_corpus=True)
    li = LearnedIndex.load(tmp, device="cpu")
d, ids = li.search(ds["queries_nav"], ds["queries_search"], n_buckets=2,
                   search_config=SearchConfig(int8_queries=True))
assert d.shape == ids.shape == (20, 10) and ids.min() >= 1
scfg = SearchConfig(pallas_worklist=True, pallas_mc=128, pallas_pair=True,
                    pallas_pool=True)
batches = [(ds["queries_nav"], ds["queries_search"])] * 3
got = list(li.search_stream(batches, n_buckets=2, search_config=scfg))
assert len(got) == 3 and all((g[1] == got[0][1]).all() for g in got)
from tpulmi_torch.parallel import make_mesh
li.shard(make_mesh(devices=[torch.device("cpu")] * 2))
d2, ids2 = li.search(ds["queries_nav"], ds["queries_search"], n_buckets=2,
                     search_config=SearchConfig(int8_queries=True))
assert (ids2 == ids).all()
import tpulmi_torch.cli, tpulmi_torch.sweep
from tpulmi_torch import Baseline
from tpulmi_torch.baseline import exact_knn_streamed
from tpulmi_torch.models import train_lr_sweep
_, gt, _ = Baseline(device="cpu").search(ds["queries_search"],
                                         ds["data_search"])
_, sids = exact_knn_streamed(ds["queries_search"], ds["data_search"],
                             chunk=1024, compute_dtype=torch.float32,
                             device="cpu")
assert (sids + 1 == gt).mean() > 0.99
_, losses = train_lr_sweep("MLP-7", ds["data_nav"], np.arange(3000) % 4,
                           (0.001, 0.01), epochs=1, batch_size=512,
                           device="cpu")
assert losses.shape == (2, 1)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "tpulmi")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""


def test_runs_without_jax_or_tpulmi():
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|flax|optax|tpulmi)\b"
    r"|from\s+(jax|jaxlib|flax|optax|tpulmi)(\.|\s))", re.M)
# a CUDA source includes nothing of either package
_FORBIDDEN_INCLUDE = re.compile(r"#\s*include\s*[<\"][^>\"]*(jax|tpulmi/)",
                                re.I)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT))
    for p in [*(ROOT / "tpulmi_torch").rglob("*.py"),
              *(ROOT / "tpulmi_torch" / "csrc").glob("*.cu*"),
              ROOT / "chip_smoke.py"]))
def test_source_imports_no_jax(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(text), path
    assert not _FORBIDDEN_INCLUDE.search(text), path


def test_new_sources_are_covered():
    """The serving module, the merge kernel and every library's source are
    among the files held to the rule above."""
    from tpulmi_torch.ops import _kernels

    names = {p.name for p in (ROOT / "tpulmi_torch").rglob("*.py")}
    assert {"serving.py", "index.py", "probe_topk.py", "mesh.py",
            "sharded.py", "dist_build.py", "baseline.py", "cli.py",
            "sweep.py"} <= names
    sources = {p.name for p in (ROOT / "tpulmi_torch" / "csrc").glob("*.cu*")}
    assert {f"{src}.cu" for src, _ in _kernels.LIBRARIES.values()} <= sources
    assert "merge_items.cu" in sources and "probe_common.cuh" in sources
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert "def phase_serving" in smoke and "search_stream" in smoke
    assert "def phase_shard" in smoke and "init_distributed" in smoke
    assert "def phase_baseline" in smoke and "exact_knn_streamed" in smoke
    assert "def phase_cli" in smoke and "tpulmi_torch.cli" in smoke
    assert "def phase_far" in smoke and "def phase_hier20m" in smoke
    assert 'backend="device"' in smoke
    assert "def phase_hier40m" in smoke and "phase_hier40m(dev" in smoke
    assert 'store_dtype="int4"' in smoke
    assert "def phase_flat10m" in smoke and "phase_flat10m(dev" in smoke


def test_default_device_without_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LearnedIndex()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LearnedIndex(device="cuda:0")
    assert LearnedIndex(device="cpu").device.type == "cpu"
    # the other public entry points that place tensors default to the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BucketClassifier(8, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        store_from_arrays(np.zeros((4, 8), np.float32), np.arange(4),
                          [0, 4], [4], 4, 0, 1)
    assert BucketClassifier(8, 4, device="cpu").device.type == "cpu"
    from tpulmi_torch.baseline import Baseline, exact_knn_streamed
    from tpulmi_torch.models import train_lr_sweep

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Baseline()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exact_knn_streamed(np.zeros((2, 8), np.float32),
                           np.zeros((16, 8), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lr_sweep("MLP", np.zeros((16, 8), np.float32),
                       np.arange(16) % 2, (0.01,))
    from tpulmi_torch.data import synthetic_dataset_big

    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_dataset_big(100, 4, d_nav=4, d_search=8, n_clusters=2,
                              cache_dir=str(tmp_path), backend="device")


def test_exports():
    assert set(tpulmi_torch.__all__) == {
        "LearnedIndex", "BuiltIndex", "HierarchicalIndex",
        "HierarchicalConfig", "IndexConfig", "SearchConfig", "Baseline",
        "__version__"}
    import tpulmi_torch.models as models

    assert {"StackedMLP", "train_lr_sweep"} <= set(models.__all__)
    for name in models.__all__:
        assert getattr(models, name) is not None


def test_chip_smoke_refuses_without_card():
    """chip_smoke.py exits non-zero and prints no result without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
