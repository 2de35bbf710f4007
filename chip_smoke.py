#!/usr/bin/env python3
"""Drive tpulmi_torch on one NVIDIA card and check it end to end.

    python3 chip_smoke.py [--profile | --kernels-only]

Phases, in order; any failure exits non-zero. ``--profile`` adds, after the
timing, one search's time by stage and by device kernel. ``--kernels-only``
stops after phase 2 (a short check of a changed kernel) and prints no
result line.

1. build   - compile every CUDA kernel library of tpulmi_torch/csrc with
             nvcc, all at once, and beside them the native host library
             (tpulmi_torch/csrc/layout.cpp) with g++;
2. kernels - each kernel against its plain PyTorch version on the card, on
             random bfloat16, float16 and float32 stores and on their int8
             and packed-int4 quantizations with float and int8 queries (the
             main path's shapes, narrow ones that are no multiple of a
             64-feature slice, and one too wide for the wgmma loop; skewed
             bucket sizes, buckets smaller than k, dumped slots), with the
             main loop that each case took (the main path's shape must take
             the wgmma loop, with bfloat16 and with int8 queries); equal
             rows inside a tile and across tile and work-item edges, which
             must come back lower row first, on a store whose last, ragged
             tile reaches past its end (int8 queries there also equal to
             the staged loop to the bit); then every further
             configuration of the kernel (the 128-row tile, the worklist's
             item and merge kernels, the item kernel on its persistent
             grid and on 7 CTAs, whose pieces must be its schedule's, the
             rerank pool, and their combinations) against its plain
             version and, to the bit, against the one-CTA-per-block
             kernel, on a store with one bucket of more than 20 times the
             mean, an empty probed bucket, dumped slots, a tight and an
             undersized worklist (two
             launches are held together to the bit under one main loop;
             under int8 queries every configuration, with and without the
             pool, equals the staged loop to the bit); the 128-row tile's
             launch in thread-block clusters (the rule's, and 2 and 4
             asked for) against its launch without one, to the bit, with
             and without the pool, and the tile walks its grouping saves;
3. main    - the main path at full size: LearnedIndex.build on a 300K x 768
             synthetic corpus with 122 buckets (and a sha256 of what it
             built, the same in every run), then LearnedIndex.search of
             10k queries at 1, 2, 3, 4 and 7 probes, recall@10 against an
             exact oracle, and the launch count of every kernel;
4. quantized - on that index, for an int8 and then a packed-int4 store:
             LearnedIndex.quantize with the host corpus attached, searches
             at 2 probes with float and int8 queries, with and without the
             exact host rerank (recall@10, time, the rerank's share, the
             launch count of each kernel variant), a probe sweep with the
             rerank, and one save / load round trip of the int4 index;
5. serving - LearnedIndex.search_stream over 8 batches of 10k host queries
             at 2 probes, depth 2: with the default config, with the
             worklist, with the 128-row tile, and on the int8 store with
             the host rerank, with the rerank pool, and with every option
             at once; every batch equal to LearnedIndex.search's result,
             recall@10, the launch count of every kernel (the 128-row
             tile's stream must launch it in clusters), the steady time
             per batch beside search's (`--profile`: the device's busy
             share of a stream);
6. hoststore - LearnedIndex.build_with_host_store on the main data: its
             pred, ids, offsets and counts equal to build's to the bit and
             its float32 rows within 1e-6, a bfloat16 host store's recall
             within 0.002 of build's; then 2M rows made by
             synthetic_dataset_big (3.1 GB of bfloat16 in a temporary
             cache): an int8 host-store build (native gather, overlapped
             upload) with its stage seconds and store bytes, the same
             layout down the source-sequential path from the memory map
             (the blocking upload timed), a search at 4 probes with the
             native rerank (recall@10 against a float32 oracle), and
             rerank_dot against the gather + bmm path on the same
             candidates; the library's build and call counters;
7. prune   - SearchConfig(backend="xla", prune_after=1) against the
             unpruned xla scan at 7 probes, to the bit, in float32 and
             bfloat16 on the main index after compute_bounds, on its int8
             store, and on an index of tight clusters (cluster_std 0.3),
             where rows must be skipped; rows scanned of nominal and ms
             of each; the scan's ids equal to the kernel's outside ties,
             and no kernel launched by it;
8. timing  - each kernel, its plain version and one library call for the
             same function, on the main path's inputs at 2 probes, beside
             the least time the card could take for that work and the
             rates it reached; K1, K2 and K3 also under the staged main
             loop, in turns, and the pool beside the list of k_out it
             replaces, in turns; the 128-row tile without a cluster and
             in clusters of 2 and 4, in turns, and the reads per bucket
             that each grouping gives; the merge kernel beside one stable
             sort of each slot's item lists; then the one-CTA-per-block
             kernel against the worklist and the 128-row tile (in
             clusters and without, in turns) on a skewed store.

The last lines are one JSON object with every kernel's numbers, the card's
name and power limit as nvidia-smi reports them, and
{"ok": true, "device": {...}}.
"""

import itertools
import json
import re
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
# int8 x int8: the integer sums are exact and the scaling is written without
# contraction on both sides, so kernel and plain version agree to rounding
INT8Q_TOL = 1e-5
KERNEL_SOURCES = {"probe_topk": "tpulmi_torch/csrc/probe_topk.cu",
                  "probe_topk_quant": "tpulmi_torch/csrc/probe_topk_quant.cu",
                  "probe_common": "tpulmi_torch/csrc/probe_common.cuh",
                  "probe_wgmma": "tpulmi_torch/csrc/probe_wgmma.cuh",
                  "merge_items": "tpulmi_torch/csrc/merge_items.cu"}
N_BATCHES, STREAM_DEPTH = 8, 2   # the serving phase's stream
BIG_N = 2_000_000   # rows of the host-store phase's realistic size

# Dense bf16 tensor-core rate and memory rate of each card (NVIDIA's data
# sheets); the first name fragment that matches the device name is used.
PEAKS = (("H100 PCIe", 756e12, 2.0e12), ("H100 NVL", 835e12, 3.9e12),
         ("H200", 989e12, 4.8e12), ("H100", 989e12, 3.35e12))
# float32 rate of the CUDA cores (no tensor cores) of an H100 SXM
F32_PEAK = 67e12
INT8_OVER_BF16 = 2.0   # dense int8 tensor-core rate over the bf16 rate


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
    import threading

    from tpulmi_torch.native import native_layout
    from tpulmi_torch.ops import _kernels

    t0 = time.perf_counter()
    # the host library (g++) builds beside the CUDA libraries (nvcc)
    host = threading.Thread(target=native_layout.available)
    host.start()
    paths = _kernels.build(_kernels.LIBRARIES)
    log(f"[build] {len(paths)} kernel libraries in "
        f"{time.perf_counter() - t0:.2f}s")
    host.join()
    if not native_layout.available():
        raise AssertionError("the native host library did not build")
    info = native_layout.build_info
    log(f"[build] native host library (tpulmi_torch/csrc/layout.cpp, g++ "
        f"{info.get('flags', '(already built)')}) in "
        f"{info.get('seconds', 0.0):.2f}s")
    for name, info in _kernels.build_info.items():
        # ptxas reports every instantiation: keep the most registers any of
        # them uses and the lines of those that spill
        lines = info["log"].splitlines()
        regs = [int(m) for line in lines
                for m in re.findall(r"Used (\d+) registers", line)]
        log(f"[build] {name}: {len(regs)} kernels, at most "
            f"{max(regs, default=0)} registers")
        fn = "?"
        for line in lines:
            props = re.search(r"Function properties for (\S+)", line)
            fn = props.group(1) if props else fn
            if re.search(r"[1-9]\d* bytes spill", line):
                log(f"[build] {name}: {fn}: {line.strip()}")
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


def compare(kern, plain, own_dist, layout, n_slots, tol=DIST_TOL):
    """Max |distance| error over live slots; raises on a disagreement.
    `own_dist(query index of each live row, ids clamped at 0)` recomputes
    the distance of every returned id from the inputs."""
    import torch

    (kd, ki), (pd, pi) = kern, plain
    live = layout.slot_of_row < n_slots
    kd, ki, pd, pi = kd[live], ki[live], pd[live], pi[live]
    err = float((kd - pd).abs().max()) if kd.numel() else 0.0
    if not err <= tol:
        raise AssertionError(f"kernel distances differ by {err}")
    if not torch.equal(ki < 0, pi < 0):
        raise AssertionError("kernel and plain disagree on empty places")
    if not bool((kd[ki < 0] == 10000.0).all()):
        raise AssertionError("an empty place does not hold the sentinel")
    # every id the kernel returns carries its own distance
    real = ki >= 0
    own = own_dist(layout.qidx[live].long(), torch.clamp(ki, min=0).long())
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
    apart = gap > tol
    if not bool((ki == pi)[apart].all()):
        bad = int((ki != pi)[apart].sum())
        raise AssertionError(f"{bad} kernel ids differ where distances "
                             f"are apart")
    return err


def own_full(q, data):
    """Distances of ids over a full-precision store, from the inputs."""
    import torch

    def own(qi, ids):
        return 1.0 - torch.einsum("rd,rkd->rk", q[qi].float(),
                                  data[ids].float())
    return own


def own_quant(q, codes, scales, bits, q_scales=None):
    """Distances of ids over a quantized store, from codes and scales; with
    `q_scales`, q holds int8 query codes."""
    import torch
    from tpulmi_torch.ops.quantize import unpack_int4

    levels = 7.0 if bits == 4 else 127.0

    def own(qi, ids):
        x = codes[ids]
        x = (unpack_int4(x) if bits == 4 else x).float()
        sims = torch.einsum("rd,rkd->rk", q[qi].float(), x) * (
            scales[ids] / levels)
        if q_scales is not None:
            sims = sims * (q_scales[qi] / 127.0)[:, None]
        return 1.0 - sims
    return own


def ran_loop(launch):
    """launch()'s result and the main loop that its one probe launch took
    ("wgmma" or "staged")."""
    from tpulmi_torch.ops.probe_topk import loop_launch_counts

    before = loop_launch_counts()
    out = launch()
    after = loop_launch_counts()
    (loop,) = [n for n in after if after[n] != before[n]]
    return out, loop


def phase_kernels(dev):
    """Each kernel against its plain version on the card. Returns the max
    |err| of each kernel variant."""
    import torch
    from tpulmi_torch.ops.probe_topk import (group_slots, probe_topk,
                                             probe_topk_int8q,
                                             probe_topk_int8q_plain,
                                             probe_topk_plain,
                                             probe_topk_quant,
                                             probe_topk_quant_plain)
    from tpulmi_torch.ops.quantize import (quantize_rows,
                                           quantize_rows_int4)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = torch.Generator().manual_seed(SEED)
    # skewed sizes totalling ~300K over 122 buckets, plus a bucket of 3
    # rows (< k) and an empty one
    sizes = (torch.rand(N_CAT, generator=rng) ** 3 * 9000).long() + 1
    sizes[5], sizes[9] = 3, 0
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    # (d, k, probes, queries, dtype, variants); variants: "full" the
    # full-precision kernel, "quant" int8 and int4 codes with queries of
    # dtype, "int8q" int8 queries on int8 and int4 codes. d = 96: half the
    # width is no multiple of a staged slice.
    cases = [(768, 10, 1, N_QUERIES, bf16, ("full", "quant", "int8q")),
             (768, 10, 2, N_QUERIES, bf16, ("full", "quant", "int8q")),
             (768, 10, 7, N_QUERIES, bf16, ("full",)),
             (768, 40, 7, 3000, bf16, ("quant", "int8q")),
             (128, 128, 2, 2000, bf16, ("full", "quant", "int8q")),
             (768, 128, 1, 1000, bf16, ("full", "quant", "int8q")),
             # 16 < k <= 32: the longer of the lists held in registers
             (256, 24, 2, 2000, bf16, ("full", "quant")),
             (128, 10, 7, 2000, bf16, ("full",)),
             (96, 40, 7, 2000, bf16, ("full", "quant", "int8q")),
             # d = 40: no multiple of a 64-feature slice; d = 1536: the
             # resident queries do not fit, so the staged loop serves it
             (40, 10, 2, 2000, bf16, ("full",)),
             (1536, 10, 2, 2000, bf16, ("full", "quant")),
             # compute_dtype=None (float32) and float16 searches
             (768, 10, 2, N_QUERIES, f32, ("full", "quant")),
             (128, 128, 2, 2000, f32, ("full",)),
             (96, 20, 2, 2000, f32, ("quant",)),
             (768, 10, 2, 2000, f16, ("full", "quant"))]
    errs = {}

    def note(name, err, d, k, p, nq, what, loop):
        errs[name] = max(errs.get(name, 0.0), err)
        log(f"[kernels] {name} {what} d={d} k={k} probes={p} queries={nq}: "
            f"{loop} loop, max |err| {err:.3g}")
        # the main path's shape must take the loop built for this card, for
        # 2-byte and int8 queries alike, and a width whose bfloat16 queries
        # cannot be resident the staged one (int8 queries, half as wide,
        # still fit there)
        want = {768: "wgmma",
                1536: None if "int8q" in name else "staged"}.get(d)
        if (k == 10 and "float32" not in what and want and loop != want):
            raise AssertionError(f"{name} {what} d={d} k={k} ran the {loop} "
                                 f"loop, not the {want} loop")

    for d, k, p, nq, dtype, variants in cases:
        data, offsets, counts = random_store(d, sizes.tolist(), dev, gen,
                                             dtype)
        qf = torch.randn((nq, d), generator=gen, device=dev)
        qf = qf / qf.norm(dim=1, keepdim=True)
        q = qf.to(dtype)
        probes = torch.argsort(torch.rand((nq, N_CAT), generator=gen,
                                          device=dev), dim=1)[:, :p]
        if p > 1:   # dump some later probes, as probe_mass does
            drop = torch.rand((nq, p), generator=gen, device=dev) < 0.2
            drop[:, 0] = False
            probes = torch.where(drop, N_CAT, probes)
        layout = group_slots(probes.int(), offsets, counts)
        if "full" in variants:
            args = (q, layout.qidx, data, layout.blocks, k)
            kern, loop = ran_loop(lambda: probe_topk(*args))
            torch.cuda.synchronize()
            err = compare(kern, probe_topk_plain(*args), own_full(q, data),
                          layout, nq * p)
            note("probe_topk", err, d, k, p, nq, str(dtype), loop)
        for bits in (8, 4):
            if not {"quant", "int8q"} & set(variants):
                break
            codes, scales = (quantize_rows_int4 if bits == 4
                             else quantize_rows)(data.float())
            if "quant" in variants:
                args = (q, layout.qidx, codes, scales, layout.blocks, k, bits)
                kern, loop = ran_loop(lambda: probe_topk_quant(*args))
                torch.cuda.synchronize()
                err = compare(kern, probe_topk_quant_plain(*args),
                              own_quant(q, codes, scales, bits), layout,
                              nq * p)
                note(f"probe_topk_quant_int{bits}", err, d, k, p, nq,
                     f"{dtype} queries", loop)
            if "int8q" in variants:
                qc, qs = quantize_rows(qf)
                args = (qc, qs, layout.qidx, codes, scales, layout.blocks, k,
                        bits)
                kern, loop = ran_loop(lambda: probe_topk_int8q(*args))
                torch.cuda.synchronize()
                err = compare(kern, probe_topk_int8q_plain(*args),
                              own_quant(qc, codes, scales, bits, qs), layout,
                              nq * p, tol=INT8Q_TOL)
                note(f"probe_topk_int8q_int{bits}", err, d, k, p, nq,
                     "int8 queries", loop)
    return phase_ties(dev, errs)


def phase_ties(dev, errs):
    """The tie rule and the store's edges. A store whose buckets hold pairs
    of equal rows, inside one tile (bucket rows 10/11, 40/41) and across
    the edges of 64- and 128-row tiles and of 128-row work items (63/64,
    127/128); the queries are noisy copies of those rows, so the pairs lead
    the lists. Equal rows give equal distances, and the lower store row
    must come first. The last bucket ends with the store, in a ragged tile
    (130 rows), so its last tile reaches past the store's end; another is
    shorter than a tile. Each kernel and configuration against its plain
    version (`compare`), then pair by pair."""
    import torch
    from tpulmi_torch.ops.probe_topk import group_slots, probe_cluster

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    counts = [300, 50, 129, 1000, 130]
    twins = (10, 40, 63, 127)         # bucket rows j, j + 1 are equal
    nq, p, k = 600, 2, 10
    for d, dtype, kinds in ((768, torch.bfloat16, ("full", "quant8", "quant4",
                                                   "int8q8", "int8q4")),
                            (96, torch.float16, ("full", "quant8", "quant4",
                                                 "int8q8", "int8q4")),
                            (1536, torch.bfloat16, ("full", "quant8",
                                                    "int8q8"))):
        offsets = [0]
        for c in counts:
            offsets.append(offsets[-1] + c)
        x = torch.randn((offsets[-1], d), generator=gen, device=dev)
        lo = [o + j for o, c in zip(offsets, counts) for j in twins
              if j + 1 < c]
        lo = torch.tensor(lo, device=dev)
        x[lo + 1] = x[lo]
        x = x / x.norm(dim=1, keepdim=True)
        data = x.to(dtype)
        # queries near the twins, each probing its twin's bucket first
        pick = lo[torch.randint(0, lo.numel(), (nq,), generator=gen,
                                device=dev)]
        qf = x[pick] + 0.05 * torch.randn((nq, d), generator=gen, device=dev)
        qf = qf / qf.norm(dim=1, keepdim=True)
        q = qf.to(dtype)
        off_t = torch.tensor(offsets, dtype=torch.int32, device=dev)
        cnt_t = torch.tensor(counts, dtype=torch.int32, device=dev)
        home = torch.searchsorted(off_t[1:].long().contiguous(), pick,
                                  right=True)
        probes = torch.stack([home, (home + 1) % len(counts)], 1).int()
        layout = group_slots(probes, off_t, cnt_t)
        live = layout.slot_of_row < nq * p
        hi_of = torch.full((offsets[-1] + 1,), -1, device=dev)
        hi_of[lo] = lo + 1
        for name, fn, plain, args, tail, own, tol, _ in store_kinds(
                q, qf, data, layout, kinds):
            n_pairs = 0
            for opts in ({}, dict(pair=True), dict(pair=True, cluster=1),
                         dict(pair=True, cluster=2),
                         dict(wl_pad=256, item_rows=128),
                         dict(wl_pad=256, item_rows=128, pair=True),
                         dict(wl_pad=256, item_rows=128, ctas=7),
                         dict(wl_pad=256, item_rows=128, pair=True, ctas=7)):
                if opts.get("cluster", 1) > 1 and probe_cluster(
                        1 if name.startswith("probe_topk_int8q")
                        else data.element_size(),
                        int(name[-1]) if name[-1] in "48" else 0, d, k,
                        False, 128) == 1:
                    continue     # this launch takes no cluster
                kern, loop = ran_loop(lambda: fn(*args, k, *tail, **opts))
                torch.cuda.synchronize()
                if opts.get("wl_pad", 0) and int(kern[2]) > opts["wl_pad"]:
                    raise AssertionError("the ties' worklist is too short")
                err = compare(kern[:2], plain(*args, k, *tail, **opts)[:2],
                              own, layout, nq * p, tol)
                if name.startswith("probe_topk_int8q") and loop == "wgmma":
                    # exact integer sums: the staged loop's result to the bit
                    staged = fn(*args, k, *tail, loop="staged",
                                **{n: v for n, v in opts.items()
                                   if n != "cluster"})
                    torch.cuda.synchronize()
                    if not (torch.equal(staged[0][live], kern[0][live]) and
                            torch.equal(staged[1][live], kern[1][live])):
                        raise AssertionError(f"{name} d={d} {opts}: the wgmma "
                                             f"loop differs from the staged")
                ids = kern[1][live].long()
                # wherever a twin's lower row stands before the last place,
                # its higher row follows at once; a higher row never stands
                # first or after another row
                follows = hi_of[torch.clamp(ids[:, :-1], min=0)]
                is_lo = (ids[:, :-1] >= 0) & (follows >= 0)
                if not bool((ids[:, 1:] == follows)[is_lo].all()):
                    raise AssertionError(f"{name} {opts}: an equal row of "
                                         f"higher index does not follow")
                is_hi = torch.isin(ids, lo + 1)
                ahead = torch.cat([torch.full_like(ids[:, :1], -1),
                                   ids[:, :-1]], 1)
                if not bool((ahead == ids - 1)[is_hi].all()):
                    raise AssertionError(f"{name} {opts}: an equal row of "
                                         f"higher index comes first")
                n_pairs = max(n_pairs, int(is_lo.sum()))
                errs[name] = max(errs.get(name, 0.0), err)
            if n_pairs < nq:
                raise AssertionError(f"{name}: only {n_pairs} pairs of equal "
                                     f"rows reached the lists")
            log(f"[kernels] {name} d={d} {dtype}: equal rows in a tile and "
                f"across tile and item edges, a ragged tile past the store's "
                f"end: {loop} loop, lower row first in {n_pairs} pairs (dense, "
                f"128-row tile, also in clusters of 2 where it takes one, "
                f"worklist, both; the worklist also on 7 CTAs); "
                f"max |err| "
                f"{errs[name]:.3g}")
    return errs


def compare_pool(kern, plain, parts, rescale, own_dist, layout, n_slots, k,
                 tol=DIST_TOL):
    """`compare` for results with a rerank pool (k_out > k columns). The
    first k columns as `compare` holds them against the plain version's.
    The extras against the definition applied to the kernel's own prefix:
    `parts` are the plain worklist's parts for the same inputs, whose keys
    are the plain per-class best rows; the k_out - k best of them that are
    not in the kernel's top-k must be the kernel's extras: distances
    within tol, empty places alike, ids alike where distances are apart
    but for a class whose two best rows lie within a rounding of each
    other (at least 99.9%). (The plain version's own extras may differ in
    a row where rank k and k + 1 lie within a rounding: another row in the
    prefix takes another class out of the pool.) Also: the whole row
    ascends, every id has its own distance, none comes twice. `rescale`
    applies the int8 queries' scales to lists of raw scores."""
    import torch
    from tpulmi_torch.ops.probe_topk import pool_extras, pool_pairs

    (kd, ki), (pd, pi) = kern, plain
    k_out = kd.shape[1]
    err = compare((kd[:, :k], ki[:, :k]), (pd[:, :k], pi[:, :k]), own_dist,
                  layout, n_slots, tol)
    want = pool_extras(kd[:, :k], ki[:, :k], *pool_pairs(parts.keys), k_out)
    if rescale is not None:
        want = rescale(want)
    live = layout.slot_of_row < n_slots
    moved = int(((kd - pd).abs()[live] > tol).any(1).sum())
    kd, ki = kd[live], ki[live]
    wd, wi = want[0][live][:, k:], want[1][live][:, k:]
    err = max(err, float((kd[:, k:] - wd).abs().max()) if kd.numel() else 0.0)
    if not err <= tol:
        raise AssertionError(f"pool distances differ by {err}")
    if not torch.equal(ki[:, k:] < 0, wi < 0):
        raise AssertionError("kernel and plain pools disagree on empty places")
    if not bool((kd[ki < 0] == 10000.0).all()):
        raise AssertionError("an empty pool place does not hold the sentinel")
    if not bool((kd[:, 1:] >= kd[:, :-1]).all()):
        raise AssertionError("a pooled row does not ascend")
    own = own_dist(layout.qidx[live].long(), torch.clamp(ki, min=0).long())
    if not bool(((own - kd).abs() <= DIST_TOL)[ki >= 0].all()):
        raise AssertionError("pool ids do not carry their distances")
    srt = torch.sort(ki, dim=1).values
    if bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()):
        raise AssertionError("a pooled row holds an id twice")
    gap = torch.full_like(wd, float("inf"))
    step = wd[:, 1:] - wd[:, :-1]
    gap[:, :-1] = torch.minimum(gap[:, :-1], step)
    gap[:, 1:] = torch.minimum(gap[:, 1:], step)
    apart = gap > tol
    apart[:, -1] = False
    if apart.any() and float((ki[:, k:] == wi)[apart].float().mean()) < 0.999:
        raise AssertionError("pool ids differ where distances are apart")
    if moved:
        log(f"[kernels]   ({moved} of {int(live.sum())} rows differ from the "
            f"plain version's own extras: ranks k and k+1 within a rounding)")
    return err


def store_kinds(q, qf, data, layout, kinds):
    """For each kind of store and query in `kinds`: (name of its kernel,
    wrapper, plain version, arguments before k, arguments after k, the
    distances of returned ids from the inputs, tolerance, what turns lists
    of the kernel's raw scores into distances, or None)."""
    import torch
    from tpulmi_torch.ops.probe_topk import (apply_query_scale, probe_topk,
                                             probe_topk_int8q,
                                             probe_topk_int8q_plain,
                                             probe_topk_plain,
                                             probe_topk_quant,
                                             probe_topk_quant_plain)
    from tpulmi_torch.ops.quantize import (quantize_rows,
                                           quantize_rows_int4)

    out = []
    for kind in kinds:
        if kind == "full":
            out.append(("probe_topk", probe_topk, probe_topk_plain,
                        (q, layout.qidx, data, layout.blocks), (),
                        own_full(q, data), DIST_TOL, None))
            continue
        bits = int(kind[-1])
        codes, scales = (quantize_rows_int4 if bits == 4
                         else quantize_rows)(data.float())
        tail = (layout.qidx, codes, scales, layout.blocks)
        if kind.startswith("int8q"):
            qc, qs = quantize_rows(qf)
            out.append((f"probe_topk_int8q_int{bits}", probe_topk_int8q,
                        probe_topk_int8q_plain, (qc, qs, *tail), (bits,),
                        own_quant(qc, codes, scales, bits, qs), INT8Q_TOL,
                        lambda out, qs=qs: apply_query_scale(
                            out, qs, layout.qidx)))
        else:
            out.append((f"probe_topk_quant_int{bits}", probe_topk_quant,
                        probe_topk_quant_plain, (q, *tail), (bits,),
                        own_quant(q, codes, scales, bits), DIST_TOL, None))
    return out


def worklist_total(layout, counts, span):
    """The closed form of the worklist's length: over probed buckets,
    ceil(slots / 64) * max(ceil(rows / span), 1)."""
    import torch
    from tpulmi_torch.ops.probe_topk import BLOCK_SLOTS

    slots = layout.slot_counts
    steps = torch.clamp(-(-counts.long() // span), min=1)
    return int((-(-slots // BLOCK_SLOTS) * steps * (slots > 0)).sum())


def phase_variants(dev, errs):
    """The further configurations of the probe kernel, each against its
    plain version and, to the bit, against the one-CTA-per-block kernel."""
    import torch
    from tpulmi_torch.ops.probe_topk import (CLUSTER_SIZES, cluster_reads,
                                             common_loop, group_slots,
                                             merge_items, merge_items_plain,
                                             probe_cluster, probe_loop,
                                             worklist_pieces)

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rng = torch.Generator().manual_seed(SEED + 1)
    sizes = (torch.rand(N_CAT, generator=rng) ** 3 * 9000).long() + 1
    sizes[5], sizes[9] = 3, 0
    sizes[0] = 25 * int(sizes.float().mean())      # one very long bucket
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    # (d, k, k_out, probes, queries, dtype, store kinds)
    cases = [(768, 10, 20, 2, N_QUERIES, bf16,
              ("full", "quant8", "quant4", "int8q8", "int8q4")),
             (128, 40, 128, 3, 2000, f32, ("full", "quant8")),
             # lists of 128, 128-row tile and pool: the most shared memory
             (128, 100, 128, 2, 1000, f16, ("full", "int8q4"))]

    def note(name, err, what):
        errs[name] = max(errs.get(name, 0.0), err)
        log(f"[kernels] {name} {what}: max |err| {err:.3g}")

    for d, k, k_out, p, nq, dtype, kinds in cases:
        data, offsets, counts = random_store(d, sizes.tolist(), dev, gen,
                                             dtype)
        qf = torch.randn((nq, d), generator=gen, device=dev)
        qf = qf / qf.norm(dim=1, keepdim=True)
        q = qf.to(dtype)
        probes = torch.argsort(torch.rand((nq, N_CAT), generator=gen,
                                          device=dev), dim=1)[:, :p]
        probes[:, 0] = torch.where(
            torch.rand(nq, generator=gen, device=dev) < 0.3, 0,
            probes[:, 0])                  # the long bucket is probed a lot
        probes[:50, 1] = 9                 # and the empty one by a few
        drop = torch.rand((nq, p), generator=gen, device=dev) < 0.2
        drop[:, 0] = False
        probes = torch.where(drop, N_CAT, probes)
        layout = group_slots(probes.int(), offsets, counts)
        live = layout.slot_of_row < nq * p
        mc = 1024

        def same(a, b, what):
            torch.cuda.synchronize()
            if not (torch.equal(a[0][live], b[0][live])
                    and torch.equal(a[1][live], b[1][live])):
                raise AssertionError(f"{what}: not equal to the bit")

        for name, fn, plain, args, tail, own, tol, rescale in store_kinds(
                q, qf, data, layout, kinds):
            what = f"{name} d={d} k={k} probes={p} queries={nq}"
            # Two launches are equal to the bit only when they take the same
            # main loop (the loops sum a product in different orders). The
            # rule may give a 128-row tile or a pool another loop than the
            # plain launch (their shared memory differs); each group below
            # is then held together under the staged loop, which takes
            # every launch, and the rule's own choice is held against the
            # plain version at the tolerance.
            qbytes = 1 if "int8q" in name else q.element_size()
            bits = int(name[-1]) if name[-1] in "48" else 0
            tiles = common_loop(qbytes, bits, d, [(k, False, 64),
                                                  (k, False, 128)])
            pools = common_loop(qbytes, bits, d, [
                (k, pl, nb) for pl in (False, True) for nb in (64, 128)])
            chosen = {(pl, nb): probe_loop(qbytes, bits, d, k, pl, nb)
                      for pl in (False, True) for nb in (64, 128)}
            log(f"[kernels] {what}: main loop of (pool, tile rows): "
                f"{chosen}; held together under: tiles "
                f"{tiles or 'the rule'}, pool {pools or 'the rule'}")
            dense = fn(*args, k, *tail, loop=tiles)
            # the 128-row tile
            pair = fn(*args, k, *tail, pair=True, loop=tiles)
            same(pair, dense, f"pair, {what}")
            note("probe_pair", compare(fn(*args, k, *tail, pair=True),
                                       plain(*args, k, *tail, pair=True),
                                       own, layout, nq * p, tol), what)
            # its launch in clusters (the rule's, and each size asked for)
            # against the launch without one, with and without the pool
            clustered = []
            for extra in ({}, dict(k_out=k_out)):
                rule = probe_cluster(qbytes, bits, d, k, bool(extra), 128)
                if rule == 1:
                    continue
                alone = fn(*args, k, *tail, pair=True, cluster=1, **extra)
                for c in (None,) + CLUSTER_SIZES[1:]:
                    opts = {} if c is None else dict(cluster=c)
                    got, loop = ran_loop(lambda: fn(*args, k, *tail,
                                                    pair=True, **opts,
                                                    **extra))
                    same(got, alone, f"cluster {c or rule} {extra}, {what}")
                clustered.append(f"{'pool' if extra else 'list'} "
                                 f"({loop} loop, the rule's {rule})")
            if clustered:
                reads = {c: cluster_reads(layout.blocks, c)
                         for c in CLUSTER_SIZES}
                log(f"[kernels] {what}: the 128-row tile in clusters of "
                    f"{', '.join(str(c) for c in CLUSTER_SIZES[1:])} equals "
                    f"its launch without one to the bit: "
                    f"{', '.join(clustered)}; tile walks over "
                    f"{reads[1]['buckets']} probed buckets "
                    + ", ".join(f"{r['groups']} at C={c}"
                                for c, r in reads.items()))
            # the worklist: item kernel, then merge kernel
            wants = {paired: worklist_total(layout, counts,
                                            mc * (2 if paired else 1))
                     for paired in (False, True)}
            for (paired, want), ctas in itertools.product(wants.items(),
                                                          (0, 7)):
                # the persistent grid of the wgmma loop: as many CTAs as
                # the card holds (0), or 7, each a range of many items
                opts = dict(item_rows=mc, pair=paired, loop=tiles, ctas=ctas)
                on = f"pair={paired}, ctas={ctas or 'the grid'}"
                parts = fn(*args, k, *tail, wl_pad=want + 1000, merge=False,
                           **opts)
                if int(parts.total) != want:
                    raise AssertionError(
                        f"worklist total {int(parts.total)} != {want}")
                if ctas and (tiles or probe_loop(qbytes, bits, d, k, False,
                                                 128 if paired else 64)
                             ) == "wgmma":
                    firsts = parts.block_items[:, 0].tolist()
                    span = mc * (2 if paired else 1)
                    starts = [firsts[b] + c0 for _, b, c0, _ in
                              worklist_pieces(parts.items, parts.total,
                                              layout.blocks, span,
                                              128 if paired else 64, ctas)]
                    if torch.nonzero(parts.written).flatten().tolist() \
                            != starts:
                        raise AssertionError(f"worklist ({on}) marks other "
                                             f"pieces than its schedule")
                merged = merge_items(layout.blocks, parts, k)
                same(merged, merge_items_plain(layout.blocks, parts, k),
                     f"merge kernel against its plain version ({on}), "
                     f"{what}")
                if not name.startswith("probe_topk_int8q"):
                    # (int8 queries: the parts hold raw scores, the scale
                    # comes after the merge; the whole calls below cover it)
                    same(merged, dense, f"worklist ({on}), {what}")
                tight = fn(*args, k, *tail, wl_pad=want, **opts)
                same(tight, dense, f"tight worklist ({on}), {what}")
                *_, total = fn(*args, k, *tail, wl_pad=want // 2, **opts)
                if int(total) != want or int(tight[2]) != want:
                    raise AssertionError("an undersized or tight worklist "
                                         "reports another total")
            opts = dict(item_rows=mc, pair=True, loop=tiles)
            wl_plain = plain(*args, k, *tail, wl_pad=want, **opts)
            if int(wl_plain[2]) != want:
                raise AssertionError("the plain worklist counts another total")
            note("probe_worklist", compare(
                fn(*args, k, *tail, wl_pad=want, item_rows=mc,
                   pair=True)[:2], wl_plain[:2], own, layout, nq * p, tol),
                 f"{what} items={want}")
            errs.setdefault("merge_items", 0.0)
            # the rerank pool, alone and with the other two
            pooled = fn(*args, k, *tail, k_out=k_out, loop=pools)
            same((pooled[0][:, :k], pooled[1][:, :k]),
                 fn(*args, k, *tail, loop=pools), f"pool prefix, {what}")
            note("probe_pool", compare_pool(
                fn(*args, k, *tail, k_out=k_out),
                plain(*args, k, *tail, k_out=k_out),
                plain(*args, k, *tail, k_out=k_out, merge=False,
                      wl_pad=wants[False], item_rows=mc), rescale, own,
                layout, nq * p, k, tol), f"{what} k_out={k_out}")
            for opts in (dict(pair=True), dict(wl_pad=wants[False] + 1000,
                                               item_rows=mc),
                         dict(wl_pad=wants[True], item_rows=mc, pair=True),
                         dict(wl_pad=wants[False], item_rows=mc, ctas=7)):
                same(fn(*args, k, *tail, k_out=k_out, loop=pools,
                        **opts)[:2], pooled, f"pool with {opts}, {what}")
            parts = fn(*args, k, *tail, k_out=k_out,
                       wl_pad=wants[False] + 1000, item_rows=mc, merge=False)
            same(merge_items(layout.blocks, parts, k, k_out),
                 merge_items_plain(layout.blocks, parts, k, k_out),
                 f"merge kernel with pool against its plain version, {what}")
            if name.startswith("probe_topk_int8q"):
                # K3 and K5 under int8 queries: the sums are exact integers,
                # so each configuration in the loop that the rule gives it
                # equals the staged loop (which keeps no gate) to the bit,
                # and the pool's also the one-CTA-per-block kernel's
                loops = []
                pooled_dense = fn(*args, k, *tail, k_out=k_out)
                for extra in ({}, dict(k_out=k_out)):
                    for opts in ({}, dict(pair=True),
                                 dict(wl_pad=wants[False] + 1000,
                                      item_rows=mc),
                                 dict(wl_pad=wants[True], item_rows=mc,
                                      pair=True),
                                 dict(wl_pad=wants[True], item_rows=mc,
                                      pair=True, ctas=7)):
                        got, loop = ran_loop(
                            lambda: fn(*args, k, *tail, **extra, **opts))
                        loops.append(loop)
                        same(got[:2], fn(*args, k, *tail, loop="staged",
                                         **extra, **opts)[:2],
                             f"{extra} {opts} in the {loop} loop against "
                             f"the staged loop, {what}")
                        if extra:
                            same(got[:2], pooled_dense, f"pool with {opts} "
                                 f"against one CTA per block, {what}")
                log(f"[kernels] {what} k_out={k_out}: dense, 128-row tile, "
                    f"worklist and both, without and with the pool, in the "
                    f"loops {loops}: each equal to the staged loop to the "
                    f"bit, and with the pool to the one-CTA-per-block "
                    f"kernel (its extras against the definition: "
                    f"probe_pool above)")
    log("[kernels] the 128-row tile, the worklist (also tight, with the "
        "128-row tile, on the persistent grid and on 7 CTAs, whose pieces "
        "are its schedule's) and the pool's combinations equal the "
        "one-CTA-per-block kernel to the bit; the merge kernel equals its "
        "plain version to the bit")
    return errs


def phase_main(dev):
    """Build and search at full size through the user's entry points."""
    import numpy as np
    import torch
    from tpulmi_torch import IndexConfig, LearnedIndex, SearchConfig
    from tpulmi_torch.build import build_digest
    from tpulmi_torch.data import synthetic_dataset
    from tpulmi_torch.evaluate import recall_at_k
    from tpulmi_torch.ops.probe_topk import (launch_counts,
                                             loop_launch_counts, probe_topk,
                                             reset_launch_counts)

    t0 = time.perf_counter()
    ds = synthetic_dataset(n=N, n_queries=N_QUERIES, d_nav=D_NAV,
                           d_search=D_SEARCH, n_clusters=N_CAT, seed=SEED)
    log(f"[main] data {N} x {D_SEARCH} made in "
        f"{time.perf_counter() - t0:.1f}s")
    cfg = IndexConfig(n_categories=N_CAT, epochs=12, lr=0.003,
                      model_type="MLP-5", batch_size=1024, seed=SEED)

    reset_launch_counts()
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
    loops = loop_launch_counts()
    if loops["staged"] or not loops["wgmma"]:
        raise AssertionError(f"the main path's searches did not all take "
                             f"the wgmma loop: {loops}")
    # a float32 search (compute_dtype=None) goes through the kernel too
    before = probe_topk.launches
    torch.cuda.synchronize()
    t = time.perf_counter()
    f32_ids = index.search(*host, n_buckets=2, k=10,
                           search_config=SearchConfig(compute_dtype=None))[1]
    f32_s = time.perf_counter() - t
    if probe_topk.launches <= before:
        raise AssertionError("float32 search launched no probe kernel")
    launches = launch_counts()["probe_topk"]

    store = index.built.store
    log(f"[main] build {build_s:.3f}s; store {tuple(store.data_sorted.shape)}"
        f" f32 ({store.data_sorted.numel() * 4 / 1e9:.3f} GB) + bf16 copy "
        f"({store.data_sorted.numel() * 2 / 1e9:.3f} GB)")
    # equal digests: the same build to the bit, in any two runs
    log(f"[main] build digest (sha256 of centroids, router parameters, "
        f"store rows, ids and offsets): " + build_digest(
            index.built.centroids, index.built.classifier.model,
            store.data_sorted, store.ids_sorted, store.offsets))
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
    log(f"[main] probe_topk launches over build + searches: {launches}; by "
        f"main loop (the float32 search takes the staged one): "
        f"{loop_launch_counts()}")
    return index, ds, launches, gt, recall_at_k(f32_ids - 1, gt, 10)


def phase_quantized(index, ds, dev, gt, f32_recall):
    """The quantized path on the index phase_main built: quantize to int8,
    then (from the same full-precision store) to packed int4; search 10k
    queries at 2 probes with float and int8 queries, with and without the
    exact host rerank. Returns the launch counts of the phase and the two
    quantized stores."""
    import tempfile

    import numpy as np
    import torch
    from tpulmi_torch import LearnedIndex, SearchConfig
    from tpulmi_torch.evaluate import recall_at_k
    from tpulmi_torch.ops.probe_topk import (launch_counts,
                                             reset_launch_counts)

    full = index.built.store
    host = (ds["queries_nav"], ds["queries_search"])
    rerank_s = [0.0]
    plain_rerank = index._rerank_host

    def timed_rerank(*a, **kw):
        t = time.perf_counter()
        out = plain_rerank(*a, **kw)
        rerank_s[0] += time.perf_counter() - t
        return out

    index._rerank_host = timed_rerank

    def search(p, runs=2, **opts):
        """(recall@10, seconds of the last run, of which in the host
        rerank, ids); two runs: the first call of a shape, then steady
        state."""
        scfg = SearchConfig(k=10, n_buckets=p, **opts)
        for _ in range(runs):
            rerank_s[0] = 0.0
            torch.cuda.synchronize()
            t = time.perf_counter()
            dists, ids = index.search(*host, n_buckets=p, k=10,
                                      search_config=scfg)
            secs = time.perf_counter() - t
        if dists.shape != (N_QUERIES, 10) or not np.isfinite(dists).all():
            raise AssertionError(f"bad quantized result: {dists.shape}")
        return recall_at_k(ids - 1, gt, 10), secs, rerank_s[0], ids

    reset_launch_counts()
    stores = {}
    for bits in (8, 4):
        # int4 codes are made from the full-precision store, not from the
        # int8 codes: re-quantizing is refused
        index.built.store = full
        torch.cuda.synchronize()
        t = time.perf_counter()
        index.quantize(host_corpus=ds["data_search"], normalized=True,
                       bits=bits)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t
        store = stores[bits] = index.built.store
        nbytes = (store.data_sorted.numel() * store.data_sorted.element_size()
                  + store.scales.numel() * 4)
        log(f"[quantized] int{bits}: quantize {quant_s:.3f}s; store "
            f"{tuple(store.data_sorted.shape)} {store.data_sorted.dtype} + "
            f"scales = {nbytes / 1e9:.4f} GB (bf16 copy of the "
            f"full-precision store: {full.data_sorted.numel() * 2 / 1e9:.4f}"
            f" GB)")
        for int8q in (False, True):
            variant = (f"probe_topk_int8q_int{bits}" if int8q
                       else f"probe_topk_quant_int{bits}")
            before = launch_counts()
            for rerank in (True, False):
                rec, secs, rr, _ = search(2, int8_queries=int8q,
                                          rerank=rerank)
                log(f"[quantized] int{bits} store, "
                    f"{'int8' if int8q else 'bf16'} queries, "
                    f"{'host rerank' if rerank else 'no rerank'}, probes=2: "
                    f"recall@10 {rec:.4f} (float32 search {f32_recall:.4f}, "
                    f"gap {rec - f32_recall:+.4f}); search {secs:.4f}s = "
                    f"{N_QUERIES / secs:.0f} QPS, host rerank {rr:.4f}s "
                    f"({rr / secs:.1%})")
                if rerank and not rec >= RECALL_GATE:
                    raise AssertionError(
                        f"int{bits} reranked recall@10 {rec} at 2 probes is "
                        f"under the {RECALL_GATE} gate")
            after = launch_counts()
            if not after[variant] > before[variant]:
                raise AssertionError(f"{variant} was launched by no search")
            others = [n for n in after if n != variant
                      and after[n] != before[n]]
            if others:
                raise AssertionError(f"searches of {variant} launched "
                                     f"{others}")
        for p in PROBES:
            if p == 2:
                continue
            rec, secs, rr, _ = search(p, runs=1)
            log(f"[quantized] int{bits} store, bf16 queries, host rerank, "
                f"probes={p}: recall@10 {rec:.4f}; search (first call) "
                f"{secs:.4f}s, host rerank {rr:.4f}s ({rr / secs:.1%})")
    launches = launch_counts()

    # one save / load round trip of the int4 index; the corpus is not in
    # the checkpoint and is attached again (its fingerprint is checked)
    want = search(2)[3]
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        index.save(tmp)
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        restored = LearnedIndex.load(tmp, device=dev)
        load_s = time.perf_counter() - t
    if restored._host_corpus is not None:
        raise AssertionError("a corpus was attached from nowhere")
    restored.attach_host_corpus(ds["data_search"])
    got = restored.search(*host, n_buckets=2, k=10)[1]
    if not np.array_equal(got, want):
        raise AssertionError("the restored int4 index searches differently")
    log(f"[quantized] int4 index saved in {save_s:.3f}s, loaded in "
        f"{load_s:.3f}s, corpus attached again: ids equal")
    del restored

    # leave the index as phase_main built it
    index.built.store = full
    index._search_programs = {}
    index._host_corpus = None
    del index._rerank_host
    log(f"[quantized] launches over the phase: {launches}")
    return launches, stores


def device_busy_ms(fn):
    """(wall ms, device-busy ms, device events by time) of fn() under
    torch.profiler; fn ends synchronized."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        wall = time.perf_counter() - t

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only (kernels and copies): a host op's device time
    # is the sum of its own kernels', so counting both would count twice
    events = sorted(((dev_us(e), e.count, e.key)
                     for e in prof.key_averages()
                     if str(e.device_type).endswith("CUDA")
                     and not e.key.startswith("Activity Buffer")),
                    reverse=True)
    return wall * 1e3, sum(e[0] for e in events) / 1e3, events


def phase_serving(index, stores, ds, dev, gt, profile):
    """The serving path at full width: search_stream over N_BATCHES batches
    of 10k host queries at 2 probes, for each kernel configuration; every
    batch must equal `search`'s result. Returns the launch counts of the
    streams (the reference searches are not counted)."""
    import numpy as np
    import torch
    from tpulmi_torch import SearchConfig
    from tpulmi_torch.evaluate import recall_at_k
    from tpulmi_torch.ops.probe_topk import (launch_counts,
                                             reset_launch_counts)

    shifts = [997 * i for i in range(N_BATCHES)]
    batches = [(np.roll(ds["queries_nav"], -s, axis=0),
                np.roll(ds["queries_search"], -s, axis=0)) for s in shifts]
    full, int8 = index.built.store, stores[8]
    every = dict(pallas_pool=True, pallas_worklist=True, pallas_pair=True,
                 int8_queries=True)
    # (label, store, options, kernels that the stream must launch)
    configs = [
        ("default", full, {}, ("probe_topk",)),
        ("worklist", full, dict(pallas_worklist=True),
         ("probe_topk", "probe_worklist", "merge_items")),
        ("pair", full, dict(pallas_pair=True),
         ("probe_topk", "probe_pair", "probe_cluster")),
        ("int8 store, host rerank", int8, {}, ("probe_topk_quant_int8",)),
        ("int8 store, host rerank, pool", int8, dict(pallas_pool=True),
         ("probe_topk_quant_int8", "probe_pool")),
        ("int8 store, host rerank, pool + worklist + pair, int8 queries",
         int8, every, ("probe_topk_int8q_int8", "probe_pool",
                       "probe_worklist", "merge_items", "probe_pair"))]
    totals = {}
    for label, store, opts, must in configs:
        index.built.store = store
        index._search_programs = {}
        index._host_corpus = ((ds["data_search"], True)
                              if store.is_quantized else None)
        scfg = SearchConfig(k=10, n_buckets=2, **opts)
        kw = dict(n_buckets=2, k=10, search_config=scfg)
        want, search_s = [], []
        for qn, qs in batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            want.append(index.search(qn, qs, **kw))
            search_s.append(time.perf_counter() - t)
        reset_launch_counts()
        got, stamps = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for out in index.search_stream(batches, depth=STREAM_DEPTH, **kw):
            stamps.append(time.perf_counter())
            got.append(out)
        counts = launch_counts()
        if len(got) != N_BATCHES:
            raise AssertionError(f"{label}: {len(got)} results")
        recalls = []
        for i, ((gd, gi), (wd, wi)) in enumerate(zip(got, want)):
            if gd.shape != (N_QUERIES, 10) or not np.isfinite(gd).all():
                raise AssertionError(f"{label}: bad result {gd.shape}")
            if not (np.array_equal(gi, wi) and np.array_equal(gd, wd)):
                raise AssertionError(
                    f"{label}: batch {i} of the stream differs from search "
                    f"({int((gi != wi).sum())} ids, max |d| "
                    f"{float(np.abs(gd - wd).max())})")
            recalls.append(recall_at_k(
                gi - 1, np.roll(gt, -shifts[i], axis=0), 10))
        for name in must:
            if not counts[name] > 0:
                raise AssertionError(f"{label}: the stream launched no "
                                     f"{name}")
        for name, n in counts.items():
            totals[name] = totals.get(name, 0) + n
        if not min(recalls) >= RECALL_GATE:
            raise AssertionError(f"{label}: recall@10 {min(recalls)}")
        # steady: after the stream's first batches, which also allocate
        # its pinned buffers
        first = STREAM_DEPTH + 1
        steady = (stamps[-1] - stamps[first]) / (N_BATCHES - 1 - first)
        search_steady = float(np.median(search_s[1:]))
        log(f"[serving] {label}: {N_BATCHES} batches of {N_QUERIES} equal "
            f"to search; recall@10 {np.mean(recalls):.4f}; search "
            f"{search_steady * 1e3:.3f} ms/batch = "
            f"{N_QUERIES / search_steady:.0f} QPS; stream steady "
            f"{steady * 1e3:.3f} ms/batch = {N_QUERIES / steady:.0f} QPS "
            f"(whole stream {(stamps[-1] - t0) * 1e3:.1f} ms, first result "
            f"after {(stamps[0] - t0) * 1e3:.1f} ms); launches "
            f"{ {n: c for n, c in counts.items() if c} }")
        if profile and label in ("default", "int8 store, host rerank"):
            def run():
                list(index.search_stream(batches, depth=STREAM_DEPTH, **kw))
                torch.cuda.synchronize()
            run()
            wall, busy, events = device_busy_ms(run)
            log(f"[profile] stream, {label}: wall {wall:.1f} ms, device busy "
                f"{busy:.1f} ms ({busy / wall:.1%}); by device time (ms, "
                f"calls):")
            for us, count, key in events[:8]:
                if us > 0:
                    log(f"[profile]   {us / 1e3:.4f} {count} {key[:90]}")
    # leave the index as phase_main built it
    index.built.store = full
    index._search_programs = {}
    index._host_corpus = None
    log(f"[serving] launches over the streams: {totals}")
    return totals


def host_cpu_line() -> str:
    """The host's CPU model, architecture and thread count, for host
    times."""
    import os
    import platform

    model = "model not reported"
    try:
        for line in open("/proc/cpuinfo"):
            if line.startswith("model name"):
                model = line.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    return (f"CPU '{model}' ({platform.machine()}), {os.cpu_count()} "
            f"threads")


def exact_ids(queries, corpus, dev, k=10, bf16_inputs=False, chunk=65536):
    """Exact top-k ids (0-based) of `queries` over a host corpus (float32
    rows, or bfloat16 bit patterns as uint16), off the main path: float32
    products and topk on the card, streamed in chunks. `bf16_inputs`
    rounds both operands to bfloat16 first (products summed in float32),
    which is what the JAX package's oracle computes on a TPU at JAX's
    default matmul precision."""
    import numpy as np
    import torch

    qs = torch.as_tensor(queries, device=dev)
    if bf16_inputs:
        qs = qs.to(torch.bfloat16).float()
    best_s = torch.full((qs.shape[0], k), -2.0, device=dev)
    best_i = torch.zeros((qs.shape[0], k), dtype=torch.int64, device=dev)
    for s in range(0, corpus.shape[0], chunk):
        part = np.ascontiguousarray(corpus[s:s + chunk])
        if part.dtype == np.uint16:
            xs = torch.from_numpy(part.view(np.int16)).to(dev).view(
                torch.bfloat16).float()
        else:
            xs = torch.from_numpy(part).to(dev)
        if bf16_inputs:
            xs = xs.to(torch.bfloat16).float()
        sims = qs @ xs.T
        cat_s = torch.cat([best_s, sims], 1)
        cat_i = torch.cat([best_i, torch.arange(
            s, s + sims.shape[1], device=dev).expand(qs.shape[0], -1)], 1)
        best_s, top = torch.topk(cat_s, k, dim=1)
        best_i = torch.gather(cat_i, 1, top)
    return best_i.cpu().numpy()


def equal_but_ties(ids_a, d_a, ids_b, d_b, queries, corpus, tol,
                   bf16=False):
    """Raise unless two (Q, k) results agree but for ties: distances within
    `tol` place by place, and every id that only one list holds lies, by
    its distance recomputed on the host (float32 sums; of bfloat16-rounded
    inputs with `bf16`), within `tol` of the row's kth distance (a tie
    across the cut). Returns the number of rows whose ids differ."""
    import numpy as np
    import torch

    def rounded(x):
        x = np.asarray(x, np.float32)
        return (torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                if bf16 else x)

    gap = float(np.abs(d_a - d_b).max())
    if not gap <= tol:
        raise AssertionError(f"distances differ by {gap}")
    rows = np.where((ids_a != ids_b).any(axis=1))[0]
    for r in rows:
        only = np.setxor1d(ids_a[r], ids_b[r]) - 1     # 1-based ids
        if only.size:
            q = rounded(queries[r] / np.linalg.norm(queries[r]))
            exact = 1.0 - rounded(corpus[only]) @ q
            if not np.all(np.abs(exact - d_a[r, -1]) <= tol):
                raise AssertionError(
                    f"row {r}: ids {only} at {exact}, kth {d_a[r, -1]}")
    return len(rows)


def phase_hoststore(index, ds, dev, gt):
    """Host-store builds (the JAX package's large-scale build): the native
    host library; build_with_host_store on the main data against build
    (pred, layout, store rows) and in bfloat16 (recall); then a realistic
    size, BIG_N rows made by synthetic_dataset_big into a temporary cache:
    an int8 host-store build (native gather, overlapped upload), the same
    layout again down the source-sequential path, a search at 4 probes
    with the native rerank against a float32 oracle, and the rerank's two
    paths on the same candidates. Returns the launch counts of the phase's
    searches."""
    import gc
    import os
    import tempfile

    import numpy as np
    import torch
    from tpulmi_torch import LearnedIndex
    from tpulmi_torch.data import synthetic_dataset_big
    from tpulmi_torch.evaluate import recall_at_k
    from tpulmi_torch.hoststore import _slab_upload_serial, layout_host_store
    from tpulmi_torch.native import native_layout
    from tpulmi_torch.ops.probe_topk import (launch_counts,
                                             reset_launch_counts)

    if not native_layout.available():
        raise AssertionError("the native host library is not available")
    info = native_layout.build_info
    log(f"[hoststore] native library: built in "
        f"{info.get('seconds', 0.0):.2f}s ({info.get('flags', '?')}); host "
        f"{host_cpu_line()}")
    cfg = index.config
    host = (ds["queries_nav"], ds["queries_search"])
    main_ids = index.search(*host, n_buckets=2, k=10)[1]
    main_recall = recall_at_k(main_ids - 1, gt, 10)
    reset_launch_counts()
    native_layout.reset_calls()

    # ---- the main data: equal to build ----
    ref = index.built
    li = LearnedIndex(cfg, device=dev)
    torch.cuda.synchronize()
    pred, secs = li.build_with_host_store(ds["data_nav"], ds["data_search"],
                                          store_dtype="float32")
    st = li.built.store
    if not np.array_equal(pred, ref.pred_categories.cpu().numpy()):
        raise AssertionError("build_with_host_store's pred differs from "
                             "build's")
    for name in ("ids_sorted", "offsets", "counts"):
        if not torch.equal(getattr(st, name), getattr(ref.store, name)):
            raise AssertionError(f"host store {name} differs from build's")
    row_err = float((st.data_sorted - ref.store.data_sorted).abs().max())
    if not row_err <= 1e-6:
        raise AssertionError(f"host store rows differ by {row_err}")
    stages = li.last_build_stages
    log(f"[hoststore] main data, float32 store: build_with_host_store "
        f"{secs:.3f}s (nav {stages['nav']:.3f}s, layout + upload "
        f"{stages['layout_upload']:.3f}s) against build; pred, ids, offsets"
        f" and counts equal to the bit, rows within {row_err:.2e}")
    li = LearnedIndex(cfg, device=dev)
    li.build_with_host_store(ds["data_nav"], ds["data_search"],
                             store_dtype="bfloat16")
    if li.built.store.data_sorted.dtype != torch.bfloat16:
        raise AssertionError("the bfloat16 host store is not bfloat16")
    ids = li.search(*host, n_buckets=2, k=10)[1]
    rec = recall_at_k(ids - 1, gt, 10)
    log(f"[hoststore] main data, bfloat16 store: recall@10 {rec:.4f} at 2 "
        f"probes (build's float32 store: {main_recall:.4f})")
    if not abs(rec - main_recall) <= 0.002:
        raise AssertionError(f"bfloat16 host store recall {rec} is more "
                             f"than 0.002 from {main_recall}")
    del li, st
    gc.collect()
    torch.cuda.empty_cache()

    # ---- a realistic size ----
    with tempfile.TemporaryDirectory() as cache:
        t = time.perf_counter()
        big = synthetic_dataset_big(n=BIG_N, n_queries=N_QUERIES,
                                    d_nav=D_NAV, d_search=D_SEARCH,
                                    n_clusters=N_CAT, seed=SEED,
                                    cache_dir=cache)
        gen_s = time.perf_counter() - t
        corpus = big["data_search"]
        log(f"[hoststore] synthetic_dataset_big: {BIG_N} x {D_SEARCH} "
            f"bfloat16 ({corpus.nbytes / 1e9:.2f} GB on disk) + nav "
            f"{big['data_nav'].nbytes / 1e9:.2f} GB made in {gen_s:.1f}s")
        li = LearnedIndex(cfg, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        pred, secs = li.build_with_host_store(
            big["data_nav"], corpus, normalized=True, store_dtype="int8",
            overlap_upload=True)
        stages = li.last_build_stages
        st = li.built.store
        store_bytes = (st.data_sorted.numel() * st.data_sorted.element_size()
                       + st.scales.numel() * 4 + st.ids_sorted.numel() * 4)
        scatter_calls = native_layout.calls["scatter_rows"]
        if not scatter_calls > 0:
            raise AssertionError("the int8 host store did not take the "
                                 "native gather")
        log(f"[hoststore] {BIG_N} rows, int8 store, native gather, "
            f"overlapped upload: build {secs:.2f}s = nav stages "
            f"{stages['nav']:.2f}s + waiting for the corpus copy "
            f"{stages['materialize_wait']:.2f}s + layout and upload "
            f"{stages['layout_upload']:.2f}s; store on the card "
            f"{tuple(st.data_sorted.shape)} int8 + scales + ids = "
            f"{store_bytes / 1e9:.3f} GB")

        # the same layout down the source-sequential path, from the map
        os.environ["TPULMI_MATERIALIZE_MAX_FRAC"] = "0"
        try:
            t = time.perf_counter()
            seq = layout_host_store(pred, corpus, int(st.n_categories),
                                    row_align=cfg.row_align,
                                    store_dtype="int8", normalized=True)
            seq_s = time.perf_counter() - t
        finally:
            del os.environ["TPULMI_MATERIALIZE_MAX_FRAC"]
        for name in ("ids_sorted", "offsets", "counts"):
            if not np.array_equal(getattr(seq, name),
                                  getattr(st, name).cpu().numpy()):
                raise AssertionError(f"the source-sequential layout's "
                                     f"{name} differ from the gather's")
        t = time.perf_counter()
        seq_dev = _slab_upload_serial(seq.data_sorted, 262_144, dev)
        torch.cuda.synchronize()
        up_s = time.perf_counter() - t
        codes = st.data_sorted.to(torch.int16) - seq_dev.to(torch.int16)
        off = int((codes != 0).sum())
        if int(codes.abs().max()) > 1:
            raise AssertionError("the two layouts' int8 codes differ by "
                                 "more than the rounding")
        log(f"[hoststore] source-sequential layout of the memory map: "
            f"{seq_s:.2f}s; blocking slab upload of its "
            f"{seq.data_sorted.nbytes / 1e9:.3f} GB: {up_s:.3f}s; ids, "
            f"offsets, counts equal to the gather's, {off} of "
            f"{codes.numel()} codes one apart (nearbyintf(x * 127 / amax) "
            f"against rint(x / amax * 127))")
        del seq, seq_dev, codes
        gc.collect()

        # search at 4 probes with the native rerank
        big_host = (big["queries_nav"], big["queries_search"])
        seen = {}
        plain_rerank = li._rerank_host

        def keep_candidates(dists, ids, *a, **kw):
            seen["ids"] = ids.copy()
            t = time.perf_counter()
            out = plain_rerank(dists, ids, *a, **kw)
            seen["s"] = time.perf_counter() - t
            return out

        li._rerank_host = keep_candidates
        before = native_layout.calls["rerank_dot"]
        li.search(*big_host, n_buckets=4, k=10)      # first call of a shape
        torch.cuda.synchronize()
        t = time.perf_counter()
        dists, ids = li.search(*big_host, n_buckets=4, k=10)
        search_s = time.perf_counter() - t
        del li._rerank_host
        if not native_layout.calls["rerank_dot"] > before:
            raise AssertionError("the rerank did not take rerank_dot")
        if dists.shape != (N_QUERIES, 10) or not np.isfinite(dists).all():
            raise AssertionError(f"bad big result {dists.shape}")
        t = time.perf_counter()
        gt_big = exact_ids(big["queries_search"], corpus.bits, dev)
        oracle_s = time.perf_counter() - t
        rec = recall_at_k(ids - 1, gt_big, 10)
        log(f"[hoststore] {BIG_N} rows, int8 + native rerank, 4 probes: "
            f"recall@10 {rec:.4f} against a float32 oracle on the card "
            f"({oracle_s:.2f}s); search {search_s:.4f}s, of which rerank "
            f"{seen['s']:.4f}s")
        if not rec >= RECALL_GATE:
            raise AssertionError(f"big recall@10 {rec} under the gate")

        # the rerank's two paths on the same candidates, every candidate
        # kept so that a tie across the kth place shows
        cand = seen["ids"]
        qs = big["queries_search"]
        k_all = cand.shape[1]
        t = time.perf_counter()
        nd, ni = li._rerank_host(None, cand, None, k_all, host_queries=qs)
        native_s = time.perf_counter() - t
        native_layout.available = lambda: False
        try:
            t = time.perf_counter()
            bd, bi = li._rerank_host(None, cand, None, k_all,
                                     host_queries=qs)
            bmm_s = time.perf_counter() - t
        finally:
            del native_layout.available
        n_rows = equal_but_ties(ni[:, :10] + 1, nd[:, :10], bi[:, :10] + 1,
                                bd[:, :10], qs, li._host_corpus[0], 1e-6)
        log(f"[hoststore] rerank of {cand.shape[0]} x {cand.shape[1]} "
            f"candidates (bfloat16 corpus): rerank_dot {native_s:.4f}s, "
            f"gather + bmm {bmm_s:.4f}s ({bmm_s / native_s:.1f}x); ids equal"
            f" but for ties within 1e-6 ({n_rows} rows differ; max |d| "
            f"{float(np.abs(nd - bd).max()):.2e}); host {host_cpu_line()}")
        del li, big, corpus
        gc.collect()
        torch.cuda.empty_cache()
    launches = launch_counts()
    for name in ("probe_topk", "probe_topk_quant_int8"):
        if not launches[name] > 0:
            raise AssertionError(f"the phase's searches launched no {name}")
    log(f"[hoststore] native calls {native_layout.calls}; launches "
        f"{ {n: c for n, c in launches.items() if c} }")
    return launches


def phase_prune(index, stores, ds, dev):
    """The xla backend's bucket scan and its threshold prune
    (SearchConfig(backend="xla", prune_after=1)) at 7 probes: on the main
    index after compute_bounds, in float32 and bfloat16, and on its int8
    store with bounds computed on the codes; then on an index of tight
    clusters (cluster_std 0.3) at the main size, where the bound can bite.
    Pruned results must equal the unpruned scan to the bit; the xla scan's
    ids must equal K1's except at ties. The scan launches no kernel."""
    import gc

    import numpy as np
    import torch
    from tpulmi_torch import LearnedIndex, SearchConfig
    from tpulmi_torch.data import synthetic_dataset
    from tpulmi_torch.ops.probe_topk import launch_counts

    p = 7

    def timed(li, host, scfg):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = li.search(*host, n_buckets=p, k=10, search_config=scfg)
        return out, (time.perf_counter() - t) * 1e3

    def compare(li, host, corpus, label, dtypes, must_prune):
        t = time.perf_counter()
        li.compute_bounds()
        torch.cuda.synchronize()
        bounds_s = time.perf_counter() - t
        ratios = []
        for cd in dtypes:
            base = SearchConfig(k=10, n_buckets=p, backend="xla",
                                compute_dtype=cd)
            before = sum(launch_counts().values())
            timed(li, host, base)                   # first call of a shape
            (d0, i0), ms0 = timed(li, host, base)
            (d1, i1), ms1 = timed(li, host, SearchConfig(
                k=10, n_buckets=p, backend="xla", compute_dtype=cd,
                prune_after=1))
            scan, nominal = li.last_scan_rows, li.last_nominal_rows
            if sum(launch_counts().values()) != before:
                raise AssertionError(f"{label}, {cd}: the xla scan "
                                     f"launched a probe kernel")
            if not (np.array_equal(i1, i0) and np.array_equal(d1, d0)):
                raise AssertionError(f"{label}, {cd}: pruned differs from "
                                     f"the unpruned scan")
            if must_prune and not scan < nominal:
                raise AssertionError(f"{label}, {cd}: nothing was pruned")
            ratios.append(scan / nominal)
            msg = ""
            if not li.built.store.is_quantized:
                # the kernel's search (K1 for bf16) against the xla scan
                dk, ik = li.search(*host, n_buckets=p, k=10,
                                   search_config=SearchConfig(
                                       k=10, n_buckets=p, compute_dtype=cd))
                n_rows = equal_but_ties(ik, dk, i0, d0, host[1], corpus,
                                        DIST_TOL, bf16=cd == "bfloat16")
                msg = (f"; ids equal to the kernel's but for ties ({n_rows}"
                       f" rows differ; max |d| "
                       f"{float(np.abs(dk - d0).max()):.2e})")
            log(f"[prune] {label}, {cd or 'float32'}, {p} probes: pruned "
                f"equal to the unpruned scan to the bit; rows scanned "
                f"{scan} of {nominal} ({scan / nominal:.4f}); unpruned "
                f"{ms0:.1f} ms, pruned {ms1:.1f} ms{msg}")
        log(f"[prune] {label}: compute_bounds {bounds_s:.3f}s")
        return ratios

    host = (ds["queries_nav"], ds["queries_search"])
    full = index.built.store
    compare(index, host, ds["data_search"], "main index", (None, "bfloat16"),
            False)
    index.built.store = stores[8]
    index._search_programs = {}
    compare(index, host, ds["data_search"],
            "main index, int8 store (bounds of the codes)", (None,), False)
    index.built.store = full
    index._search_programs = {}

    tight = synthetic_dataset(n=N, n_queries=N_QUERIES, d_nav=D_NAV,
                              d_search=D_SEARCH, n_clusters=N_CAT, seed=SEED,
                              cluster_std=0.3)
    li = LearnedIndex(index.config, device=dev)
    li.build(tight["data_nav"], tight["data_search"])
    compare(li, (tight["queries_nav"], tight["queries_search"]),
            tight["data_search"], "tight clusters (cluster_std 0.3)",
            (None, "bfloat16"), True)
    del li, tight
    gc.collect()
    torch.cuda.empty_cache()
    log("[prune] the xla scans launched no probe kernel")


def oracle(ds, dev, k=10, bf16_inputs=False):
    """Exact top-k ids (0-based) of the main data (`exact_ids`)."""
    return exact_ids(ds["queries_search"], ds["data_search"], dev, k,
                     bf16_inputs=bf16_inputs)


def phase_timing(index, stores, ds, dev, name):
    """Every kernel variant, its plain version and a library yardstick on
    the main path's probe inputs at 2 probes, beside its bound. `stores`:
    the int8 and int4 quantizations of the index's store, by code width.
    Returns the numbers of each variant by name."""
    import torch
    from tpulmi_torch.ops.distance import l2_normalize
    from tpulmi_torch.ops.probe_topk import (BLOCK_SLOTS, CLUSTER_SIZES,
                                             bucket_runs, build_worklist,
                                             cluster_reads, group_slots,
                                             merge_items, merge_items_plain,
                                             probe_topk, probe_topk_int8q,
                                             probe_topk_int8q_plain,
                                             probe_cluster,
                                             probe_topk_plain,
                                             probe_topk_quant,
                                             probe_topk_quant_plain)
    from tpulmi_torch.ops.quantize import quantize_rows, unpack_int4
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
    q_codes, q_scales = quantize_rows(qs)
    data = store.data_as(torch.bfloat16)
    runs = bucket_runs(layout.blocks)
    qrows = [layout.qidx[rows].long() for _, _, rows in runs]
    n_q, d = q.shape

    # The least time. Bytes: each probed bucket's rows (and scales) and the
    # queries read once, the slot layout read once, the per-slot results
    # written once. Operations: 2 d slots rows per bucket, at the tensor
    # cores' rate for the type that is multiplied.
    slots = layout.slot_counts.double()
    rows = store.counts.double()
    flops = float(2 * d * (slots * rows).sum())
    probed_rows = float(rows[slots > 0].sum())
    around = (layout.qidx.numel() * 4 + layout.blocks.numel() * 4
              + n_q * p * k * 8)
    peak_flops, peak_bw = peaks(name)

    def bound(row_bytes, query_bytes, rate, more_bytes=0):
        return bound_of(probed_rows * row_bytes + query_bytes + around
                        + more_bytes, flops, rate)

    def bound_of(nbytes, ops, rate):
        t_ops, t_bytes = ops / rate * 1e3, nbytes / peak_bw * 1e3
        return dict(bound_ms=max(t_ops, t_bytes), ops=ops, nbytes=nbytes,
                    bound_by="operations" if t_ops >= t_bytes else "bytes",
                    note=f"{ops / 1e9:.2f} GOP -> {t_ops:.4f} ms, "
                         f"{nbytes / 1e9:.4f} GB -> {t_bytes:.4f} ms")

    def measure(label, kernel, plain, library, own, tol, bnd, check=None,
                staged=None):
        """`check`, when given, holds kernel against plain instead of
        `compare`; `library` None: no one call computes the function;
        `staged`: the same launch under the staged main loop, timed beside
        the kernel (staged, kernel, kernel, staged)."""
        err = (check() if check else
               compare(kernel()[:2], plain()[:2], own, layout, n_q * p,
                       tol=tol))
        turns = [cuda_ms(fn, 20) for fn in
                 ((staged, kernel, kernel, staged) if staged else (kernel,))]
        ms = sum(turns[1:3]) / 2 if staged else turns[0]
        out = dict(ms=ms, plain_ms=cuda_ms(plain, 3),
                   library_ms=cuda_ms(library, 3) if library else None,
                   max_abs_err=err, **bnd)
        lib = (f"{out['library_ms']:.3f} ms" if library else "none")
        ops, nbytes = out.pop("ops"), out.pop("nbytes")
        log(f"[timing] {label} at probes={p}: {ms:.4f} ms = "
            f"{ops / ms / 1e9:.1f} TFLOP/s and {nbytes / ms / 1e6:.1f} GB/s "
            f"of the bytes that must move; plain "
            f"{out['plain_ms']:.3f} ms; library {lib}; "
            f"bound {out['bound_ms']:.4f} ms by {out['bound_by']} "
            f"({out.pop('note')}); max |err| {err:.3g}"
            + (f"; the staged loop {(turns[0] + turns[3]) / 2:.4f} ms, "
               f"{(turns[0] + turns[3]) / (turns[1] + turns[2]):.2f}x "
               f"(turns {', '.join(f'{t:.4f}' for t in turns)})"
               if staged else ""))
        return out

    results = {}
    args = (q, layout.qidx, data, layout.blocks, k)

    def library():      # per-bucket matmul + topk
        for (start, cnt, _), qr in zip(runs, qrows):
            sims = q[qr] @ data[start:start + cnt].T
            torch.topk(sims.float(), min(k, cnt), dim=1)

    results["probe_topk"] = measure(
        "probe_topk (bf16)", lambda: probe_topk(*args),
        lambda: probe_topk_plain(*args), library, own_full(q, data),
        DIST_TOL, bound(d * 2, n_q * d * 2, peak_flops),
        staged=lambda: probe_topk(*args, loop="staged"))

    # the same probe in float32 (compute_dtype=None): CUDA-core products
    qf = qs.contiguous()
    f32_args = (qf, layout.qidx, store.data_sorted, layout.blocks, k)
    f32_err = compare(probe_topk(*f32_args), probe_topk_plain(*f32_args),
                      own_full(qf, store.data_sorted), layout, n_q * p)
    f32_ms = cuda_ms(lambda: probe_topk(*f32_args), 5)
    log(f"[timing] probe_topk float32 at probes={p}: {f32_ms:.4f} ms "
        f"(max |err| {f32_err:.3g}); its operations at the float32 CUDA-core"
        f" rate ({F32_PEAK / 1e12:.0f} TFLOP/s) take "
        f"{flops / F32_PEAK * 1e3:.4f} ms")
    results["probe_topk"]["max_abs_err"] = max(
        results["probe_topk"]["max_abs_err"], f32_err)

    # the 128-row tile: K1's function, K1's bound; its launch in clusters
    # (the rule's), then in turns without one and in clusters of 2 and 4
    rule = probe_cluster(2, 0, d, k, False, 128)
    results["probe_pair"] = measure(
        f"probe_topk with the 128-row tile (bf16, clusters of {rule})",
        lambda: probe_topk(*args, pair=True),
        lambda: probe_topk_plain(*args, pair=True), library,
        own_full(q, data), DIST_TOL, bound(d * 2, n_q * d * 2, peak_flops))
    order = CLUSTER_SIZES + CLUSTER_SIZES[::-1]
    turns = [cuda_ms(lambda c=c: probe_topk(*args, pair=True, cluster=c), 20)
             for c in order]
    by_c = {c: (turns[i] + turns[-1 - i]) / 2
            for i, c in enumerate(CLUSTER_SIZES)}
    reads = {c: cluster_reads(layout.blocks, c) for c in CLUSTER_SIZES}
    results["probe_pair"]["cluster_ms"] = by_c
    log(f"[timing] the 128-row tile by CTAs a cluster at probes={p} (ms): "
        + ", ".join(f"C={c} {t:.4f}" for c, t in by_c.items())
        + f" (turns {', '.join(f'{t:.4f}' for t in turns)}); the rule's "
        f"C={rule}")
    log(f"[timing] reads per bucket at probes={p} ({reads[1]['buckets']} "
        f"probed buckets, {reads[1]['bucket_rows']} rows): "
        + ", ".join(f"C={c} {r['groups'] / r['buckets']:.3f} "
                    f"({r['rows_read'] / r['bucket_rows']:.3f} by rows)"
                    for c, r in reads.items()))

    # the worklist at pallas_mc = 1024 rows an item: the item kernel, the
    # merge kernel, and the whole call beside K1
    n_items = worklist_total(layout, store.counts, 1024)
    wl = dict(wl_pad=max(-(-int(n_items * 1.15) // 1024) * 1024, 1024),
              item_rows=1024)
    n_blocks = int(layout.blocks.shape[0])
    parts = probe_topk(*args, merge=False, **wl)
    # the persistent grid writes one set of partial lists a piece, and marks
    # it: what this run's items need written and read again
    n_pieces = int(parts.written.sum())
    part_bytes = n_pieces * BLOCK_SLOTS * k * 8
    lists = build_worklist(layout.blocks, wl["wl_pad"], 1024)
    list_bytes = sum(t.numel() * 4 for t in lists[:2]) + wl["wl_pad"]
    build_ms = cuda_ms(lambda: build_worklist(layout.blocks, wl["wl_pad"],
                                              1024), 20)
    results["probe_worklist"] = measure(
        f"worklist item kernel (bf16, {n_items} items in a list of "
        f"{wl['wl_pad']}, written as {n_pieces} pieces; {build_ms:.4f} ms "
        f"of it builds the list)",
        lambda: probe_topk(*args, merge=False, **wl),
        lambda: probe_topk_plain(*args, merge=False, **wl), library,
        own_full(q, data), DIST_TOL,
        bound(d * 2, n_q * d * 2, peak_flops, part_bytes + list_bytes),
        check=lambda: compare(probe_topk(*args, **wl)[:2],
                              probe_topk_plain(*args, **wl)[:2],
                              own_full(q, data), layout, n_q * p))

    def merge_equal():
        a = merge_items(layout.blocks, parts, k)
        b = merge_items_plain(layout.blocks, parts, k)
        torch.cuda.synchronize()
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError("merge kernel and plain version differ")
        return 0.0

    # one library call for the merge: a stable sort of each slot row's item
    # lists laid end to end in chunk order (padded to the block with the
    # most items; the items that start no piece hold no list and count as
    # empty), then its first k; the layout is made before the timing
    first, n_of = parts.block_items[:, 0].long(), parts.block_items[:, 1].long()
    width = int(n_of.max()) * k
    slot = torch.arange(n_blocks * BLOCK_SLOTS, device=dev)
    place = torch.arange(width, device=dev)
    item = first.repeat_interleave(BLOCK_SLOTS)[:, None] + place // k
    src = (item * BLOCK_SLOTS + (slot % BLOCK_SLOTS)[:, None]) * k + place % k
    inside = (place // k)[None, :] < n_of.repeat_interleave(BLOCK_SLOTS)[:, None]
    src = torch.where(inside, src, torch.zeros_like(src))
    inside &= parts.written.bool()[src // (BLOCK_SLOTS * k)]
    cat_d = torch.where(inside, parts.part_d.reshape(-1)[src],
                        torch.full_like(src, 10000, dtype=torch.float32))
    cat_i = torch.where(inside, parts.part_i.reshape(-1)[src],
                        torch.full_like(src, -1, dtype=torch.int32))

    def library_merge():
        order = torch.sort(cat_d, dim=1, stable=True).indices[:, :k]
        return torch.gather(cat_d, 1, order), torch.gather(cat_i, 1, order)

    live_rows = slot < 0   # the rows of live slots of blocks with items
    live_rows |= (n_of.repeat_interleave(BLOCK_SLOTS) > 0) & (
        slot % BLOCK_SLOTS < layout.blocks[:, 2].long().clamp(0, BLOCK_SLOTS)
        .repeat_interleave(BLOCK_SLOTS))
    lib_d, lib_i = library_merge()
    ker_d, ker_i = merge_items(layout.blocks, parts, k)
    if not (torch.equal(lib_d[live_rows], ker_d[live_rows])
            and torch.equal(lib_i[live_rows], ker_i[live_rows])):
        raise AssertionError("the merge's library call differs from it")
    results["merge_items"] = measure(
        "merge kernel of the worklist",
        lambda: merge_items(layout.blocks, parts, k),
        lambda: merge_items_plain(layout.blocks, parts, k), library_merge,
        None, 0.0,
        # the partial lists read, the blocks' lists written, 20 bytes of
        # block and item arrays a block; no arithmetic
        bound_of(part_bytes + n_blocks * (BLOCK_SLOTS * k * 8 + 20), 0.0,
                 peak_flops), check=merge_equal)
    # in turns: one CTA per block, worklist, worklist, one CTA per block
    whole = [[cuda_ms(lambda: probe_topk(*args, pair=pair, **opts), 20)
              for opts in ({}, wl, wl, {})] for pair in (False, True)]
    results["probe_worklist"]["whole_ms"] = (whole[0][1] + whole[0][2]) / 2
    log(f"[timing] whole probe call at probes={p} (ms): worklist "
        f"{(whole[0][1] + whole[0][2]) / 2:.4f}, one CTA per block "
        f"{(whole[0][0] + whole[0][3]) / 2:.4f}; with the 128-row tile: "
        f"worklist {(whole[1][1] + whole[1][2]) / 2:.4f}, one CTA per block "
        f"{(whole[1][0] + whole[1][3]) / 2:.4f} (turns "
        + "; ".join(", ".join(f"{t:.4f}" for t in w) for w in whole) + ")")

    for bits, qstore in stores.items():
        codes, scales = qstore.data_sorted, qstore.scales
        sc = scales / qstore.q_levels
        row_bytes = d * bits / 8 + 4          # codes and the row's scale
        qargs = (q, layout.qidx, codes, scales, layout.blocks, k, bits)

        def bucket_codes(start, cnt):
            x = codes[start:start + cnt]
            return unpack_int4(x) if bits == 4 else x

        def library_quant():    # per bucket: cast, matmul, scale, topk
            for (start, cnt, _), qr in zip(runs, qrows):
                x = bucket_codes(start, cnt).to(torch.bfloat16)
                sims = (q[qr] @ x.T).float() * sc[start:start + cnt]
                torch.topk(sims, min(k, cnt), dim=1)

        results[f"probe_topk_quant_int{bits}"] = measure(
            f"probe_topk_quant int{bits} store, bf16 queries",
            lambda: probe_topk_quant(*qargs),
            lambda: probe_topk_quant_plain(*qargs), library_quant,
            own_quant(q, codes, scales, bits), DIST_TOL,
            bound(row_bytes, n_q * d * 2, peak_flops),
            staged=lambda: probe_topk_quant(*qargs, loop="staged"))

        if bits == 8:
            # the rerank pool: an exact list of k and k_out - k extras,
            # beside what it replaces, a list of k_out
            k_out = 2 * k

            def library_wide():
                for (start, cnt, _), qr in zip(runs, qrows):
                    x = bucket_codes(start, cnt).to(torch.bfloat16)
                    sims = (q[qr] @ x.T).float() * sc[start:start + cnt]
                    torch.topk(sims, min(k_out, cnt), dim=1)

            results["probe_pool"] = measure(
                f"probe_topk_quant with the pool (int8 store, k={k}, "
                f"k_out={k_out})",
                lambda: probe_topk_quant(*qargs, k_out=k_out),
                lambda: probe_topk_quant_plain(*qargs, k_out=k_out),
                library_wide, None, DIST_TOL,
                bound(row_bytes, n_q * d * 2, peak_flops,
                      n_q * p * (k_out - k) * 8),
                check=lambda: compare_pool(
                    probe_topk_quant(*qargs, k_out=k_out),
                    probe_topk_quant_plain(*qargs, k_out=k_out),
                    probe_topk_quant_plain(*qargs, k_out=k_out, merge=False,
                                           **wl), None,
                    own_quant(q, codes, scales, bits), layout, n_q * p, k))
            wide = (q, layout.qidx, codes, scales, layout.blocks, k_out, bits)
            # in turns with the pool, in this process
            turns = [cuda_ms(fn, 20) for fn in (
                lambda: probe_topk_quant(*wide),
                lambda: probe_topk_quant(*qargs, k_out=k_out),
                lambda: probe_topk_quant(*qargs, k_out=k_out),
                lambda: probe_topk_quant(*wide))]
            results["probe_pool"]["list_ms"] = (turns[0] + turns[3]) / 2
            log(f"[timing] the list of k_out={k_out} that the pool replaces: "
                f"{(turns[0] + turns[3]) / 2:.4f} ms, the pool "
                f"{(turns[1] + turns[2]) / 2:.4f} ms (turns "
                f"{', '.join(f'{t:.4f}' for t in turns)}; main loop of the "
                f"pool: {ran_loop(lambda: probe_topk_quant(*qargs, k_out=k_out))[1]})")

        iargs = (q_codes, q_scales, layout.qidx, codes, scales, layout.blocks,
                 k, bits)

        def library_int8q():    # per bucket: torch._int_mm, scale, topk
            for (start, cnt, _), qr in zip(runs, qrows):
                # _int_mm wants more than 16 rows and a width in eights
                if qr.numel() <= 16:
                    qr = qr.repeat(-(-17 // qr.numel()))
                wide = min(-(-cnt // 8) * 8, codes.shape[0] - start)
                dots = torch._int_mm(q_codes[qr],
                                     bucket_codes(start, wide).T)[:, :cnt]
                sims = dots.float() * sc[start:start + cnt]
                torch.topk(sims, min(k, cnt), dim=1)

        results[f"probe_topk_int8q_int{bits}"] = measure(
            f"probe_topk_int8q int{bits} store, int8 queries",
            lambda: probe_topk_int8q(*iargs),
            lambda: probe_topk_int8q_plain(*iargs), library_int8q,
            own_quant(q_codes, codes, scales, bits, q_scales), INT8Q_TOL,
            bound(row_bytes, n_q * (d + 4), peak_flops * INT8_OVER_BF16),
            staged=lambda: probe_topk_int8q(*iargs, loop="staged"))
    return results


def phase_timing_skewed(dev):
    """One CTA per block against the worklist and the 128-row tile where
    the worklist should matter: a bf16 store of the main path's width with
    one bucket of 25 times the mean, probed in proportion to bucket size."""
    import torch
    from tpulmi_torch.ops.probe_topk import (cluster_reads, group_slots,
                                             probe_cluster, probe_topk)

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rng = torch.Generator().manual_seed(SEED + 2)
    sizes = (torch.rand(N_CAT, generator=rng) * 4000).long() + 400
    mean = float(sizes.float().mean())
    sizes[0] = int(25 * mean)
    data, offsets, counts = random_store(D_SEARCH, sizes.tolist(), dev, gen,
                                         torch.bfloat16)
    q = torch.randn((N_QUERIES, D_SEARCH), generator=gen, device=dev)
    q = (q / q.norm(dim=1, keepdim=True)).bfloat16()
    probes = torch.multinomial(sizes.float().expand(N_QUERIES, -1), 2,
                               generator=rng).int().to(dev)
    layout = group_slots(probes, offsets, counts)
    args = (q, layout.qidx, data, layout.blocks, 10)
    n_items = worklist_total(layout, counts, 1024)
    wl = dict(wl_pad=-(-int(n_items * 1.15) // 1024) * 1024, item_rows=1024)
    dense = probe_topk(*args)
    alone = dict(pair=True, cluster=1)
    for opts in (wl, dict(pair=True), alone, dict(pair=True, **wl)):
        out = probe_topk(*args, **opts)
        torch.cuda.synchronize()
        if not (torch.equal(out[0], dense[0]) and torch.equal(out[1],
                                                              dense[1])):
            raise AssertionError(f"skewed store: {opts} differs from the "
                                 f"one-CTA-per-block kernel")
    ms = [cuda_ms(lambda o=o: probe_topk(*args, **o), 10)
          for o in ({}, wl, dict(pair=True), alone, alone, dict(pair=True),
                    dict(pair=True, **wl))]
    rule = probe_cluster(2, 0, D_SEARCH, 10, False, 128)
    reads = {c: cluster_reads(layout.blocks, c) for c in (1, rule)}
    log(f"[timing] skewed store (bucket 0: {int(sizes[0])} rows, the others' "
        f"mean {mean:.0f}; "
        f"{int(layout.slot_counts[0])} of {2 * N_QUERIES} slots probe it; "
        f"{n_items} items), bf16, whole probe call (ms): one CTA per block "
        f"{ms[0]:.4f}, worklist {ms[1]:.4f}, 128-row tile "
        f"{(ms[2] + ms[5]) / 2:.4f} in clusters of the rule's, "
        f"{(ms[3] + ms[4]) / 2:.4f} without (turns "
        f"{', '.join(f'{t:.4f}' for t in ms[2:6])}), worklist with the "
        f"128-row tile {ms[6]:.4f}; tile walks "
        f"{reads[1]['groups']} without clusters, {reads[rule]['groups']} in "
        f"clusters of {rule}")


def phase_stages(index, ds, dev, p=2, reps=5):
    """Where one search's time goes: each stage of LearnedIndex.search at
    `p` probes run on its own, synchronized, host clock; the median of
    `reps` runs. Then one search under torch.profiler: device time by
    kernel and the device's busy share of the wall time."""
    import numpy as np
    import torch
    from tpulmi_torch.ops.distance import l2_normalize
    from tpulmi_torch.ops.probe_topk import (group_slots, merge_slots,
                                             probe_topk)
    from tpulmi_torch.search import route_probes

    from tpulmi_torch import SearchConfig

    store, k = index.built.store, 10
    model = index.built.classifier.model
    scfg = SearchConfig(k=k, n_buckets=p)
    plan = index._plan_search(torch.zeros((1, D_NAV)), p, k, scfg)
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
            stage("finalize", lambda: index._finalize(
                *index._fetch_result((fd, fi, lay.slot_counts.max()),
                                     plan)[:2], plan, k, scfg, qs, qs_np))
            stage("search", lambda: index.search(qn_np, qs_np, n_buckets=p,
                                                 k=k))
    med = {n: float(np.median(v[1:])) * 1e3 for n, v in st.items()}
    parts = sum(v for n, v in med.items() if n != "search")
    log(f"[stages] probes={p}, {N_QUERIES} queries, median of {reps} (ms): "
        + ", ".join(f"{n} {v:.3f}" for n, v in med.items())
        + f"; stages sum {parts:.3f}")

    def one_search():
        index.search(qn_np, qs_np, n_buckets=p, k=k)
        torch.cuda.synchronize()

    one_search()
    wall, busy, events = device_busy_ms(one_search)
    log(f"[profile] one search at probes={p}: wall {wall:.3f} ms, "
        f"device busy {busy:.3f} ms ({busy / wall:.1%}); by device"
        f" time (ms, calls):")
    for us, count, key in events[:12]:
        if us > 0:
            log(f"[profile]   {us / 1e3:.4f} {count} {key[:90]}")


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
    kernel_errs = phase_variants(dev, phase_kernels(dev))
    if "--kernels-only" in args:
        log("[kernels] --kernels-only: stopping after the kernel checks")
        return 0
    index, ds, main_launches, gt, f32_recall = phase_main(dev)
    quant_launches, stores = phase_quantized(index, ds, dev, gt, f32_recall)
    serving_launches = phase_serving(index, stores, ds, dev, gt,
                                     "--profile" in args)
    phase_hoststore(index, ds, dev, gt)
    phase_prune(index, stores, ds, dev)
    timing = phase_timing(index, stores, ds, dev, name)
    phase_timing_skewed(dev)
    if "--profile" in args:
        phase_stages(index, ds, dev)

    # name -> (source, the TPU kernel it replaces); launches are those of
    # the path that each kernel serves: main, quantized or serving
    launches = {**quant_launches, "probe_topk": main_launches,
                **{n: serving_launches[n] for n in (
                    "probe_worklist", "merge_items", "probe_pool",
                    "probe_pair")}}
    replaces = {"probe_topk": ("probe_topk", 218),
                "probe_topk_quant_int8": ("probe_topk_quant", 268),
                "probe_topk_quant_int4": ("probe_topk_quant", 268),
                "probe_topk_int8q_int8": ("probe_topk_quant", 288),
                "probe_topk_int8q_int4": ("probe_topk_quant", 288),
                "probe_worklist": ("probe_wgmma", 184),
                "merge_items": ("merge_items", 184),
                "probe_pool": ("probe_common", 222),
                "probe_pair": ("probe_common", 231)}
    kernels = []
    for kname, (source, line) in replaces.items():
        t = timing[kname]
        if not launches[kname] > 0:
            raise AssertionError(f"{kname} was launched by no path")
        kernels.append({
            "name": kname, "route": "cuda", "source": KERNEL_SOURCES[source],
            "replaces": f"tpulmi/ops/pallas_topk.py:{line}",
            "launches": launches[kname],
            "max_abs_err": max(kernel_errs[kname], t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
