#!/usr/bin/env python3
"""Drive tpulmi_torch on one NVIDIA card and check it end to end.

    python3 chip_smoke.py [--profile]

Phases, in order; any failure exits non-zero. ``--profile`` adds, after the
timing, one search's time by stage and by device kernel.

1. build   - compile every CUDA kernel of tpulmi_torch/csrc with nvcc;
2. kernels - each kernel against its plain PyTorch version on the card, on
             random bfloat16, float16 and float32 stores (the main path's
             shapes, skewed bucket sizes, buckets smaller than k, dumped
             slots);
3. main    - the main path at full size: LearnedIndex.build on a 300K x 768
             synthetic corpus with 122 buckets, then LearnedIndex.search of
             10k queries at 1, 2, 3, 4 and 7 probes, recall@10 against an
             exact oracle, and the launch count of every kernel;
4. timing  - each kernel, its plain version and one library call for the
             same function, on the main path's inputs at 2 probes, beside
             the least time the card could take for that work.

The last lines are one JSON object with every kernel's numbers, the card's
name and power limit as nvidia-smi reports them, and
{"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

SEED = 2023
N, N_QUERIES, D_NAV, D_SEARCH, N_CAT = 300_000, 10_000, 96, 768, 122
PROBES = (1, 2, 3, 4, 7)
RECALL_GATE = 0.90           # bench.py's recall gate, at 2 probes
# recall@10 of the JAX package at this shape (BENCH_r05.json), for context
REFERENCE_RECALL = {1: 0.8366, 2: 0.9511, 3: 0.9775, 4: 0.986, 7: 0.9938}
DIST_TOL = 1e-4   # bf16 inputs, f32 sums taken in another order

# Dense bf16 tensor-core rate and memory rate of each card (NVIDIA's data
# sheets); the first name fragment that matches the device name is used.
PEAKS = (("H100 PCIe", 756e12, 2.0e12), ("H100 NVL", 835e12, 3.9e12),
         ("H200", 989e12, 4.8e12), ("H100", 989e12, 3.35e12))
# float32 rate of the CUDA cores (no tensor cores) of an H100 SXM
F32_PEAK = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def peaks(name: str):
    for frag, flops, bw in PEAKS:
        if frag in name:
            return flops, bw
    raise RuntimeError(f"no peak rates known for {name!r}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warmup."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------------ phases
def phase_build():
    from tpulmi_torch.ops import _kernels

    t0 = time.perf_counter()
    paths = _kernels.build(_kernels.SIGNATURES)
    log(f"[build] {len(paths)} kernel libraries in "
        f"{time.perf_counter() - t0:.2f}s")
    for name, info in _kernels.build_info.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")
    return time.perf_counter() - t0


def random_store(d, counts, dev, gen, dtype):
    """A store of unit rows in `dtype`, bucket b holding counts[b] rows,
    with sentinel gaps between buckets."""
    import torch

    gaps = [7 * (b % 3) for b in range(len(counts))]
    offsets, row = [], 0
    for c, g in zip(counts, gaps):
        offsets.append(row)
        row += c + g
    x = torch.randn((row + 64, d), generator=gen, device=dev)
    x = (x / x.norm(dim=1, keepdim=True)).to(dtype)
    return (x, torch.tensor(offsets + [row], dtype=torch.int32, device=dev),
            torch.tensor(counts, dtype=torch.int32, device=dev))


def compare(kern, plain, q, qidx, data, layout, n_slots):
    """Max |distance| error over live slots; raises on a disagreement."""
    import torch

    (kd, ki), (pd, pi) = kern, plain
    live = layout.slot_of_row < n_slots
    kd, ki, pd, pi = kd[live], ki[live], pd[live], pi[live]
    err = float((kd - pd).abs().max()) if kd.numel() else 0.0
    if not err <= DIST_TOL:
        raise AssertionError(f"kernel distances differ by {err}")
    if not torch.equal(ki < 0, pi < 0):
        raise AssertionError("kernel and plain disagree on empty places")
    # every id the kernel returns carries its own distance
    real = ki >= 0
    qrows = q[qidx[live].long()].float()
    x = data[torch.clamp(ki, min=0).long()].float()
    own = 1.0 - torch.einsum("rd,rkd->rk", qrows, x)
    if not bool(((own - kd).abs() <= DIST_TOL)[real].all()):
        raise AssertionError("kernel ids do not carry their distances")
    # ids agree wherever the distance is apart from its neighbours
    k = pd.shape[1]
    gap = torch.full_like(pd, float("inf"))
    if k > 1:
        step = pd[:, 1:] - pd[:, :-1]
        gap[:, :-1] = torch.minimum(gap[:, :-1], step)
        gap[:, 1:] = torch.minimum(gap[:, 1:], step)
    gap[:, -1] = 0.0   # the k-th place may tie with the (k+1)-th
    apart = gap > DIST_TOL
    if not bool((ki == pi)[apart].all()):
        bad = int((ki != pi)[apart].sum())
        raise AssertionError(f"{bad} kernel ids differ where distances "
                             f"are apart")
    return err


def phase_kernels(dev):
    """Each kernel against its plain version on the card."""
    import torch
    from tpulmi_torch.ops.probe_topk import (group_slots, probe_topk,
                                             probe_topk_plain)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = torch.Generator().manual_seed(SEED)
    # skewed sizes totalling ~300K over 122 buckets, plus a bucket of 3
    # rows (< k) and an empty one
    sizes = (torch.rand(N_CAT, generator=rng) ** 3 * 9000).long() + 1
    sizes[5], sizes[9] = 3, 0
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    cases = [(768, 10, p, N_QUERIES, bf16) for p in (1, 2, 7)]
    cases += [(128, 128, 2, 2000, bf16), (768, 128, 1, 1000, bf16),
              (128, 10, 7, 2000, bf16)]
    # compute_dtype=None (float32) and float16 searches
    cases += [(768, 10, 2, N_QUERIES, f32), (128, 128, 2, 2000, f32),
              (768, 10, 2, 2000, f16)]
    max_err = 0.0
    for d, k, p, nq, dtype in cases:
        data, offsets, counts = random_store(d, sizes.tolist(), dev, gen,
                                             dtype)
        q = torch.randn((nq, d), generator=gen, device=dev)
        q = (q / q.norm(dim=1, keepdim=True)).to(dtype)
        probes = torch.argsort(torch.rand((nq, N_CAT), generator=gen,
                                          device=dev), dim=1)[:, :p]
        if p > 1:   # dump some later probes, as probe_mass does
            drop = torch.rand((nq, p), generator=gen, device=dev) < 0.2
            drop[:, 0] = False
            probes = torch.where(drop, N_CAT, probes)
        layout = group_slots(probes.int(), offsets, counts)
        kern = probe_topk(q, layout.qidx, data, layout.blocks, k)
        torch.cuda.synchronize()
        plain = probe_topk_plain(q, layout.qidx, data, layout.blocks, k)
        torch.cuda.synchronize()
        err = compare(kern, plain, q, layout.qidx, data, layout, nq * p)
        max_err = max(max_err, err)
        log(f"[kernels] probe_topk {dtype} d={d} k={k} probes={p} "
            f"queries={nq}: "
            f"max |err| {err:.3g}")
    return max_err


def phase_main(dev):
    """Build and search at full size through the user's entry points."""
    import numpy as np
    import torch
    from tpulmi_torch import IndexConfig, LearnedIndex, SearchConfig
    from tpulmi_torch.data import synthetic_dataset
    from tpulmi_torch.evaluate import recall_at_k
    from tpulmi_torch.ops.probe_topk import probe_topk

    t0 = time.perf_counter()
    ds = synthetic_dataset(n=N, n_queries=N_QUERIES, d_nav=D_NAV,
                           d_search=D_SEARCH, n_clusters=N_CAT, seed=SEED)
    log(f"[main] data {N} x {D_SEARCH} made in "
        f"{time.perf_counter() - t0:.1f}s")
    cfg = IndexConfig(n_categories=N_CAT, epochs=12, lr=0.003,
                      model_type="MLP-5", batch_size=1024, seed=SEED)

    probe_topk.launches = 0
    index = LearnedIndex(cfg, device=dev)
    _, build_s = index.build(ds["data_nav"], ds["data_search"])
    # host queries (numpy), and the same queries staged on the card first
    # as bench.py stages them for the JAX package
    host = (ds["queries_nav"], ds["queries_search"])
    staged = tuple(torch.as_tensor(x, device=dev) for x in host)
    searches = {}
    for p in PROBES:
        runs = []
        # first call of a shape, steady state, steady with staged queries
        for queries in (host, host, staged):
            before = probe_topk.launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            dists, ids = index.search(*queries, n_buckets=p, k=10)
            runs.append(time.perf_counter() - t)
            if probe_topk.launches <= before:
                raise AssertionError(f"search at {p} probes launched no "
                                     f"probe kernel")
        searches[p] = (runs, dists, ids)
    # a float32 search (compute_dtype=None) goes through the kernel too
    before = probe_topk.launches
    torch.cuda.synchronize()
    t = time.perf_counter()
    f32_ids = index.search(*host, n_buckets=2, k=10,
                           search_config=SearchConfig(compute_dtype=None))[1]
    f32_s = time.perf_counter() - t
    if probe_topk.launches <= before:
        raise AssertionError("float32 search launched no probe kernel")
    launches = probe_topk.launches

    store = index.built.store
    log(f"[main] build {build_s:.3f}s; store {tuple(store.data_sorted.shape)}"
        f" f32 ({store.data_sorted.numel() * 4 / 1e9:.3f} GB) + bf16 copy "
        f"({store.data_sorted.numel() * 2 / 1e9:.3f} GB)")
    gt, gt_bf16 = oracle(ds, dev), oracle(ds, dev, bf16_inputs=True)
    recalls = {}
    for p, (runs, dists, ids) in searches.items():
        if dists.shape != (N_QUERIES, 10) or not np.isfinite(dists).all():
            raise AssertionError(f"bad result at {p} probes: {dists.shape}")
        recalls[p] = recall_at_k(ids - 1, gt, 10)
        log(f"[main] probes={p}: recall@10 {recalls[p]:.4f}, against a "
            f"bf16-input oracle {recall_at_k(ids - 1, gt_bf16, 10):.4f} "
            f"(JAX package round 5: {REFERENCE_RECALL[p]}); search first call "
            f"{runs[0]:.4f}s, steady {runs[1]:.4f}s = "
            f"{N_QUERIES / runs[1]:.0f} QPS; queries staged on the card "
            f"{runs[2]:.4f}s = {N_QUERIES / runs[2]:.0f} QPS")
    log(f"[main] float32 search (compute_dtype=None) at probes=2: recall@10 "
        f"{recall_at_k(f32_ids - 1, gt, 10):.4f}; {f32_s:.4f}s (first call)")
    if not recalls[2] >= RECALL_GATE:
        raise AssertionError(f"recall@10 {recalls[2]} at 2 probes is under "
                             f"the {RECALL_GATE} gate")
    log(f"[main] probe_topk launches over build + searches: {launches}")
    return index, ds, launches


def oracle(ds, dev, k=10, bf16_inputs=False):
    """Exact top-k ids (0-based), off the main path: float32 matmul and
    topk on the card. `bf16_inputs` rounds both operands to bfloat16 first
    (products summed in float32), which is what the JAX package's oracle
    computes on a TPU at JAX's default matmul precision."""
    import torch

    qs = torch.as_tensor(ds["queries_search"], device=dev)
    xs = torch.as_tensor(ds["data_search"], device=dev)
    if bf16_inputs:
        qs, xs = (x.to(torch.bfloat16).float() for x in (qs, xs))
    best_s = torch.full((qs.shape[0], k), -2.0, device=dev)
    best_i = torch.zeros((qs.shape[0], k), dtype=torch.int64, device=dev)
    for s in range(0, xs.shape[0], 65536):
        sims = qs @ xs[s:s + 65536].T
        cat_s = torch.cat([best_s, sims], 1)
        cat_i = torch.cat([best_i, torch.arange(
            s, s + sims.shape[1], device=dev).expand(qs.shape[0], -1)], 1)
        best_s, top = torch.topk(cat_s, k, dim=1)
        best_i = torch.gather(cat_i, 1, top)
    return best_i.cpu().numpy()


def phase_timing(index, ds, dev, name):
    """probe_topk, its plain version and a library yardstick on the main
    path's probe inputs at 2 probes."""
    import torch
    from tpulmi_torch.ops.distance import l2_normalize
    from tpulmi_torch.ops.probe_topk import (bucket_runs, group_slots,
                                             probe_topk, probe_topk_plain)
    from tpulmi_torch.search import route_probes

    store = index.built.store
    k, p = 10, 2
    with torch.no_grad():
        logits = index.built.classifier.model(
            torch.as_tensor(ds["queries_nav"], device=dev))
        probes = route_probes(logits, p)
        qs = l2_normalize(torch.as_tensor(ds["queries_search"], device=dev))
    layout = group_slots(probes, store.offsets, store.counts)
    q = qs.to(torch.bfloat16).contiguous()
    data = store.data_as(torch.bfloat16)
    args = (q, layout.qidx, data, layout.blocks, k)

    err = compare(probe_topk(*args), probe_topk_plain(*args), q,
                  layout.qidx, data, layout, q.shape[0] * p)
    ms = cuda_ms(lambda: probe_topk(*args), 20)
    plain_ms = cuda_ms(lambda: probe_topk_plain(*args), 3)
    runs = bucket_runs(layout.blocks)

    def library():
        for start, cnt, rows in runs:
            sims = q[layout.qidx[rows].long()] @ data[start:start + cnt].T
            torch.topk(sims.float(), min(k, cnt), dim=1)

    library_ms = cuda_ms(library, 3)

    # the least time: each probed bucket's rows and the queries read once,
    # the slot layout read once and the per-slot results written once; and
    # 2 d slots rows operations per bucket on the tensor cores
    d = store.dim
    slots = layout.slot_counts.double()
    rows = store.counts.double()
    flops = float(2 * d * (slots * rows).sum())
    nbytes = float(rows[slots > 0].sum() * d * 2 + q.numel() * 2
                   + layout.qidx.numel() * 4 + layout.blocks.numel() * 4
                   + q.shape[0] * p * k * 8)
    peak_flops, peak_bw = peaks(name)
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    log(f"[timing] probe_topk at probes={p}: {ms:.4f} ms; plain "
        f"{plain_ms:.3f} ms; library (per-bucket matmul + topk) "
        f"{library_ms:.3f} ms; bound {max(t_ops, t_bytes):.4f} ms "
        f"({flops / 1e9:.2f} GFLOP -> {t_ops:.4f} ms, {nbytes / 1e9:.4f} GB"
        f" -> {t_bytes:.4f} ms)")
    # the same probe in float32 (compute_dtype=None): CUDA-core products
    qf = qs.contiguous()
    f32_args = (qf, layout.qidx, store.data_sorted, layout.blocks, k)
    f32_err = compare(probe_topk(*f32_args), probe_topk_plain(*f32_args), qf,
                      layout.qidx, store.data_sorted, layout, q.shape[0] * p)
    f32_ms = cuda_ms(lambda: probe_topk(*f32_args), 5)
    log(f"[timing] probe_topk float32 at probes={p}: {f32_ms:.4f} ms "
        f"(max |err| {f32_err:.3g}); its operations at the float32 CUDA-core"
        f" rate ({F32_PEAK / 1e12:.0f} TFLOP/s) take "
        f"{flops / F32_PEAK * 1e3:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                max_abs_err=max(err, f32_err))


def phase_stages(index, ds, dev, p=2, reps=5):
    """Where one search's time goes: each stage of LearnedIndex.search at
    `p` probes run on its own, synchronized, host clock; the median of
    `reps` runs. Then one search under torch.profiler: device time by
    kernel and the device's busy share of the wall time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tpulmi_torch.ops.distance import l2_normalize
    from tpulmi_torch.ops.probe_topk import (group_slots, merge_slots,
                                             probe_topk)
    from tpulmi_torch.search import route_probes

    store, k = index.built.store, 10
    model = index.built.classifier.model
    st = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        st.setdefault(name, []).append(time.perf_counter() - t)
        return out

    qn_np, qs_np = ds["queries_nav"], ds["queries_search"]
    with torch.no_grad():
        for _ in range(reps + 1):
            qn, qs = stage("h2d", lambda: (index._tensor(qn_np),
                                           index._tensor(qs_np)))
            probes = stage("route", lambda: route_probes(model(qn), p))
            q = stage("normalize", lambda: l2_normalize(qs).to(
                torch.bfloat16).contiguous())
            lay = stage("group_slots", lambda: group_slots(
                probes, store.offsets, store.counts))
            out = stage("probe_topk", lambda: probe_topk(
                q, lay.qidx, store.data_as(torch.bfloat16), lay.blocks, k))
            fd, fi = stage("merge", lambda: merge_slots(
                *out, lay, q.shape[0], p, k, store.ids_sorted))
            stage("finalize", lambda: index._finalize(fd, fi))
            stage("search", lambda: index.search(qn_np, qs_np, n_buckets=p,
                                                 k=k))
    med = {n: float(np.median(v[1:])) * 1e3 for n, v in st.items()}
    parts = sum(v for n, v in med.items() if n != "search")
    log(f"[stages] probes={p}, {N_QUERIES} queries, median of {reps} (ms): "
        + ", ".join(f"{n} {v:.3f}" for n, v in med.items())
        + f"; stages sum {parts:.3f}")

    index.search(qn_np, qs_np, n_buckets=p, k=k)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        index.search(qn_np, qs_np, n_buckets=p, k=k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only (kernels and copies): a host op's device time
    # is the sum of its own kernels', so counting both would count twice
    events = sorted((e for e in prof.key_averages()
                     if str(e.device_type).endswith("CUDA")
                     and not e.key.startswith("Activity Buffer")),
                    key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in events) / 1e3
    log(f"[profile] one search at probes={p}: wall {wall * 1e3:.3f} ms, "
        f"device busy {busy:.3f} ms ({busy / (wall * 1e3):.1%}); by device"
        f" time (ms, calls):")
    for e in events[:12]:
        if dev_us(e) > 0:
            log(f"[profile]   {dev_us(e) / 1e3:.4f} {e.count} "
                f"{e.key[:90]}")


def main(args) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[device] {name}; {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    phase_build()
    kernel_err = phase_kernels(dev)
    index, ds, launches = phase_main(dev)
    t = phase_timing(index, ds, dev, name)
    if "--profile" in args:
        phase_stages(index, ds, dev)

    kernel = {
        "name": "probe_topk", "route": "cuda",
        "source": "tpulmi_torch/csrc/probe_topk.cu",
        "replaces": "tpulmi/ops/pallas_topk.py:218",
        "launches": launches,
        "max_abs_err": max(kernel_err, t["max_abs_err"]),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
    }
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
