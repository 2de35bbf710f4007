"""Two processes of tpulmi_torch on the CPU over a gloo process group, the
scenario of tests/multihost_worker.py: `init_distributed`, a mesh over
both processes' entries (2 each), data-parallel training in lockstep (the
loss and a hash of the params equal on both ranks, to the bit), the
data-parallel build (its pred equal on both ranks), and the bucket-sharded
search over a store each process lands only its own shards of, equal to
the exact expectation computed on the host.

This file is also the worker: ``python tests/test_torch_dist.py RANK
WORLD PORT``. The worker imports nothing of JAX or the JAX package."""

import hashlib
import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 60   # seconds a process


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_over_gloo():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(rank), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    oks = [dict(kv.split("=") for kv in line.split()[1:])
           for out in outs for line in out.splitlines()
           if line.startswith("OK ")]
    assert [ok["rank"] for ok in oks] == ["0", "1"], outs
    for key in ("loss", "params", "pred"):
        assert oks[0][key] == oks[1][key], key


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def worker(rank: int, world: int, port: str) -> None:
    for name in ("jax", "jaxlib", "flax", "optax", "tpulmi"):
        sys.modules[name] = None        # the port stands alone
    import numpy as np
    import torch

    from tpulmi_torch.hoststore import layout_host_store
    from tpulmi_torch.models.mlp import make_model
    from tpulmi_torch.parallel import (init_distributed, make_dp_train_step,
                                       make_mesh, shard_store_from_host,
                                       sharded_probe_search)
    from tpulmi_torch.parallel.dist_build import dist_nav, shard_rows

    torch.set_num_threads(1)
    assert init_distributed("gloo", f"tcp://localhost:{port}", world,
                            rank) == rank
    cpu = torch.device("cpu")
    rng = np.random.default_rng(0)     # the same on every process (SPMD)

    # ---- 1. data-parallel training across the processes ----
    mesh = make_mesh(axis_names=("data",), devices=[cpu, cpu])
    assert mesh.size == 2 * world and mesh.local_entries() == [
        2 * rank, 2 * rank + 1]
    step = make_dp_train_step(
        make_model("MLP-5", 8, 6, generator=torch.Generator().manual_seed(0)),
        1e-2, mesh)
    for _ in range(3):
        xb = rng.normal(size=(4 * mesh.size, 8)).astype(np.float32)
        yb = rng.integers(0, 6, size=4 * mesh.size)
        loss = float(step(xb, yb))

    # ---- 2. the data-parallel build's navigation stages ----
    nav = rng.normal(size=(1001, 8)).astype(np.float32)
    shards, _ = shard_rows(nav, mesh)
    assert sum(s is not None for s in shards) == 2
    nav_result = dist_nav(shards, mesh, model_type="MLP-5", lr=0.003,
                          n_categories=4, kmeans_iters=5,
                          kmeans_train_points=256, epochs=2, batch_size=64,
                          seed=3)

    # ---- 3. the bucket-sharded search; each process lands its shards ----
    n, d, n_cat, q, k = 2000, 16, 2 * mesh.size, 24, 5
    data = rng.normal(size=(n, d)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    labels = rng.integers(0, n_cat, size=n).astype(np.int32)
    arrays = layout_host_store(labels, data, n_cat, row_align=1,
                               store_dtype="float32", normalized=True,
                               pad_rows=64)
    mesh_ep = make_mesh(axis_names=("buckets",), devices=[cpu, cpu])
    sstore = shard_store_from_host(arrays, mesh_ep)
    assert [s for s, _ in sstore.local()] == mesh_ep.local_entries()
    assert sum(st is None for st in sstore.shards) == 2 * (world - 1)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    probes = np.stack([rng.permutation(n_cat)[:3] for _ in range(q)]
                      ).astype(np.int32)
    for backend in ("xla", "torch"):
        dists, _ = sharded_probe_search(probes, queries, sstore, mesh_ep,
                                        k=k, backend=backend)
        want = np.empty((q, k), np.float32)
        for i in range(q):
            dd = 1.0 - data[np.isin(labels, probes[i])] @ queries[i]
            want[i] = np.sort(dd)[:k]
        np.testing.assert_allclose(dists.numpy(), want, atol=1e-5)

    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "tpulmi")
           and sys.modules[m] is not None]
    assert not bad, bad
    torch.distributed.destroy_process_group()
    print(f"OK rank={rank} loss={loss.hex()} "
          f"params={_digest(step.model.state_dict().values())} "
          f"pred={_digest([nav_result.pred, *nav_result.model.parameters()])}",
          flush=True)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
