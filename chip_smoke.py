#!/usr/bin/env python3
"""Drive tpulmi_torch on one NVIDIA card and check it end to end.

    python3 chip_smoke.py [--profile | --kernels-only]

Phases, in order; any failure exits non-zero. ``--profile`` adds, in the
serving phase, the device's busy share and time by kernel of two streams
(a search's own spans: run it under `tpulmi_torch.utils.profiling.trace`
and read `profiling.records()`). ``--kernels-only`` stops after phase 2 (a
short check of a changed kernel) and prints no result line.

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
             last, K1 (bfloat16), K2, K3, the 128-row tile, the worklist
             with its merge kernel and the pool on a store of 2.9M x 768
             rows whose probed buckets all lie past element 2**31, each
             against its plain version;
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
             synthetic_dataset_big(backend="device") (3.1 GB of bfloat16
             in a temporary
             cache): an int8 host-store build (native gather, overlapped
             upload) with its stage seconds and store bytes, the same
             layout down the source-sequential path from the memory map
             (the blocking upload timed), a search at 4 probes with the
             native rerank (recall@10 against a float32 oracle), and
             rerank_dot against the gather + bmm path on the same
             candidates; the library's build and call counters;
7. hier    - HierarchicalIndex at the JAX package's 20M configuration
             (bench_20m.py:188-206: 8 groups x 61 = 488 buckets, int8
             store, int8 queries, rerank depth 10) on the hoststore phase's
             2M corpus (cut from 20M rows and 244 data clusters: ~4.1k
             rows a bucket, not ~41k; phase 11 runs 244 clusters):
             build_with_host_store with a sha256
             of what it built, calibrate_outer_weight at 24 probes, a probe
             sweep from 6 to 48 until recall@10 against the float32 oracle
             reaches 0.90 (failing if it never does), at that budget the
             worklist and the 128-row tile equal to the dense search but
             for ties, the pool and float queries within 0.01 of its
             recall, probe_mass 0.95 and 0.9;
             search_stream over 4 batches equal to search; a save / load
             round trip; a device-store build of the main data (2 x 61
             buckets) searched in bfloat16 beside the flat index; K1-K6
             and the merge each launched; then each of them against its
             plain version on the inputs the path gave it (probes,
             queries, stores); K3's time at 488 buckets;
8. shard   - tpulmi_torch.parallel with S shards on one card (a mesh that
             lists cuda:0 S times): the main index in 4 shards searched
             through K1, K2, K3 and K6, each equal to the unsharded search
             but for ties (host times of both, bytes), each shard's launch
             against its plain version on its own probes and store;
             build_distributed of the main data over 4 "data" entries
             (seconds, loss, recall@10 at 1, 2, 4 probes, digest, sharded
             search equal to the one after unshard, each shard's launch
             against its plain version); the hier phase's configuration
             through build_with_host_store(mesh=8 x cuda:0), one group a
             shard: pred equal to the hier phase's, the shards holding
             exactly its flat store's rows, the search equal to its
             unsharded search but for ties, each shard's launch against
             its plain version, recall, rerank share, bytes, a save /
             load to one flat store; then one NCCL
             rank and two gloo ranks sharing the card, in child
             processes (`--child`): data-parallel steps in lockstep and
             the sharded search equal to the host's exact answer;
9. baseline - the exact oracle streamed from host memory over phase
             hoststore's 2M x 768 bfloat16 corpus (exact_knn_streamed,
             blocks of 262144 rows, 10k queries): in bfloat16 and in
             float32, each equal to an oracle on the card but for ties,
             seconds and host-to-card GB/s; a resumable pass interrupted
             after its 5th block, resumed at row 4 x 262144 and equal to
             the uninterrupted pass to the bit; Baseline on the main data;
             one block's product (also under TF32), top-k and merge timed;
10. flat10m - bench_10m.py's flat configuration, uncut (FLAT10M_N =
             10M x 768 rows, 96 navigation features, 122 data clusters,
             seed 2023, 10k queries; its IndexConfig and 122 buckets), in
             a temporary directory of its own: the corpus made on the card
             (the free disk checked first), the streamed float32 oracle,
             the navigation rows rounded to bfloat16 and passed as a
             HostBF16 (they stay bfloat16 on the card), the int8
             host-store build (stages, store bytes, bucket sizes, digest,
             peak host memory), the search at 4 probes with int8 queries
             and the native rerank (recall@10 must reach 0.90), then
             bench_10m.py's variants, each best of 3: the worklist (equal
             to the dense search but for ties, or declined with its
             scratch), probe_mass 0.95 / 0.98, the float16 rerank copy,
             then the rerank kernel on the card (rerank_card_on_path) at
             the 10M cell's depth: its launches and counter over those
             searches, held against its plain version on their own
             candidates and timed; rerank_extra 6 / 4, rerank off; 4
             stream batches with the host mirror equal to search; the
             kernels of the path launched, then each against its plain
             version on the path's first 1000 queries; K3's time, bound and library time; the
             probe's work model against the card's peaks;
11. hier20m - the hier phase's configuration with bench_20m.py's own
             data clusters: HIER20M_N x 768 rows (96 navigation features;
             cut from 20M, see HIER40M_N) in 244 data clusters and 10k
             queries, made on the card by
             synthetic_dataset_big(backend="device") into a temporary
             directory of its own (the host's RAM, disk and cores logged
             first; seconds by stage and GB/s written); the streamed exact
             oracle in float32 and in bfloat16 (seconds, GB/s); the int8
             host-store build (stages, store shape and bytes, bucket
             sizes, digest, whether the corpus was copied into RAM);
             calibrate_outer_weight at 24 probes; the probe sweep against
             both oracles until the float32 one's recall@10 reaches 0.90
             (failing if none does); at that budget the worklist and the
             128-row tile equal to the dense search but for ties, the pool
             and float queries (K2) within 0.01 of its recall; every
             kernel of the path launched, then each against its plain
             version on the path's probes, store and first 1000 queries;
             K3's time, bound and library time; the rerank kernel on the
             card (rerank_card_on_path) over a float16 search at that
             budget; the peak card memory; the directory removed;
12. hier40m - bench_40m.py's configuration (16 x 61 = 976 buckets, 488
             data clusters, a packed int4 host store, int8 queries) at
             HIER40M_N rows (cut from 40M to what a run may write to the
             disk; the RAM rules scaled alike), in a temporary directory
             of its own: the corpus made on the
             card and flushed out of the page cache as it is written
             (the free disk checked first); the streamed float32 oracle;
             the int4 host-store build, the corpus left memory-mapped
             through the layout and its codes made on the card (rows a
             second, peak host memory); calibrate_outer_weight at 24
             probes; the sweep at 16 / 20 / 24 probes at rerank depth 30,
             then depth 60 and 100 until recall@10 reaches 0.90 (failing
             if it never does), beside the JAX package's round 4; at that
             (budget, depth) the worklist and the 128-row tile equal to
             the dense search but for ties, float queries (K2) within
             0.01, the pool's recall, the float16 rerank copy (refused
             where the host cannot hold it, else within 0.01), 4 stream
             batches equal to search; every kernel of the path
             launched, then each against its plain version on int4 codes;
             K3's time, bound and library time; the directory removed;
13. prune  - SearchConfig(backend="xla", prune_after=1) against the
             unpruned xla scan at 7 probes, to the bit, in float32 and
             bfloat16 on the main index after compute_bounds, on its int8
             store, and on an index of tight clusters (cluster_std 0.3),
             where rows must be skipped; rows scanned of nominal and ms
             of each; the scan's ids equal to the kernel's outside ties,
             and no kernel launched by it;
14. cli    - the experiment CLI (tpulmi_torch.cli) with phase main's
             configuration at 1, 2 and 3 probes, equal to the main index's
             searches and recalls (cli.main in this process, the result
             writer replaced so that no h5py is needed); cli.run with an int8
             store, the worklist and the 128-row tile (K2, K4, K6
             launched), equal to the main index quantized the same way,
             and its baseline index type; run_sweep crashed after one
             learning rate and resumed (one new row); train_lr_sweep over
             four learning rates beside one single-lr run, its first 20
             steps equal to BucketClassifier's; one search inside trace;
15. timing - each kernel, its plain version and one library call for the
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

The last lines are one JSON object with every kernel's numbers (the rerank
kernel's from the flat10m and hier20m phases), the card's
name and power limit as nvidia-smi reports them, and
{"ok": true, "device": {...}}.
"""

import contextlib
import itertools
import json
import re
import subprocess
import sys
import tempfile
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
# the rerank kernel against its plain version: float32 dots of the same
# float16 rows summed in another order
RERANK_TOL = 1e-5
KERNEL_SOURCES = {"probe_topk": "tpulmi_torch/csrc/probe_topk.cu",
                  "probe_topk_quant": "tpulmi_torch/csrc/probe_topk_quant.cu",
                  "probe_common": "tpulmi_torch/csrc/probe_common.cuh",
                  "probe_wgmma": "tpulmi_torch/csrc/probe_wgmma.cuh",
                  "merge_items": "tpulmi_torch/csrc/merge_items.cu",
                  "rerank_card": "tpulmi_torch/csrc/rerank_card.cu"}
N_BATCHES, STREAM_DEPTH = 8, 2   # the serving phase's stream
BIG_N = 2_000_000   # rows of the host-store phase's realistic size
SHARDS = 4          # shards of the 300K index in phase shard, on one card
OWN_ROWS = 16_384   # slots whose distances are recomputed at once
STREAM_CHUNK = 262_144   # rows of a block of the streamed ground truth
# the first row whose first element lies past 2**31 in a 768-wide store
FAR_ROWS = 2 ** 31 // D_SEARCH + 1
# bench_10m.py's configuration (:37-52, 78-100): 10M rows of 768 and 96
# features in 122 data clusters, 122 buckets, bench_10m's IndexConfig, the
# navigation rows passed as bfloat16, an int8 host store, int8 queries and
# the host rerank at 4 probes, uncut (19.2 GB on disk).
# bench_40m.py's configuration (:20-42): 16 x 61 buckets, 488 data clusters,
# packed int4, the sweep at 16 / 20 / 24 probes and the rerank-depth ladder
# of bench_20m.py (:146-151, :346-400). A run on the card's machine may
# write 45 GiB to its disk, deleted files included, and a corpus takes
# 1920 bytes a row: 40M rows alone are 76.8 GB. So phase hier20m's 20M rows
# are cut to 3M (5.8 GB) and the 40M rows to 6M (11.5 GB), which leaves
# room for the flat 10M uncut: 3.8 (hoststore) + 19.2 + 5.8 + 11.5 = 40.3
# GB. The RAM rules that choose the layout's path and the rerank's copy
# are scaled by the same 0.15 (HIER40M_FRACS), so that the 6M corpus stays
# memory-mapped through the layout and is copied into RAM for the rerank,
# as the 40M corpus is on a host of the same RAM.
FLAT10M_N, FLAT10M_PROBES = 10_000_000, 4
DISK_SPARE = 3e9   # free disk a big phase asks beyond its corpus
# the JAX package's recall@10 at 10M with the float32 and the float16
# rerank (BENCH_10M.md:12-24), printed as quality targets only
JAX10M_RECALL = {"float32": 0.9795, "float16": 0.9611}
HIER20M_N = 3_000_000
HIER20M_HOLD = 1000      # queries of phase hier20m's kernels-vs-plain checks
HIER40M_N, HIER40M_FULL_N = 6_000_000, 40_000_000
HIER40M_FRACS = {"TPULMI_MATERIALIZE_MAX_FRAC": 0.45,
                 "TPULMI_RERANK_MATERIALIZE_MAX_FRAC": 0.6}
HIER40M_GROUPS, HIER40M_CLUSTERS = 16, 488
HIER40M_BUDGETS = (16, 20, 24)
HIER40M_DEPTHS = (30, 60, 100)
# the JAX package's round-4 recall@10 at 40M by rerank depth and budget
# (BENCH_40M.md:67-76), printed beside the port's as a quality target only
JAX40M_RECALL = {30: {16: 0.8673, 20: 0.8817, 24: 0.8916},
                 60: {16: 0.9040, 20: 0.9201, 24: 0.9310}}

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


def in_row_chunks(part):
    """`part(query index of each row, ids)` applied to OWN_ROWS rows at a
    time: the gathered (rows, k, d) float32 operands of a whole search
    (120k slots x 20 x 768 at the hier phase's budget) would take 7 GB."""
    import torch

    def own(qi, ids):
        return torch.cat([part(qi[s:s + OWN_ROWS], ids[s:s + OWN_ROWS])
                          for s in range(0, max(qi.shape[0], 1), OWN_ROWS)])
    return own


def own_full(q, data):
    """Distances of ids over a full-precision store, from the inputs."""
    import torch

    def own(qi, ids):
        return 1.0 - torch.einsum("rd,rkd->rk", q[qi].float(),
                                  data[ids].float())
    return in_row_chunks(own)


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
    return in_row_chunks(own)


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


def phase_far(dev, errs):
    """K1 (bfloat16), K2, K3, the worklist with its merge kernel, the pool
    and the 128-row tile on a store whose probed rows all lie past element
    2**31 (FAR_ROWS x 768 rows before them, 2.2 GB of int8, 4.5 GB of
    bfloat16): each against its plain version, the merge kernel to the
    bit, every returned id a row of the probed buckets. An offset formed
    in 32 bits shows here."""
    import torch
    from tpulmi_torch.ops.probe_topk import (group_slots, merge_items,
                                             merge_items_plain)

    t = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rng = torch.Generator().manual_seed(SEED + 2)
    n_cat = 24
    sizes = (torch.rand(n_cat, generator=rng) ** 3 * 20000).long() + 1
    sizes[3], sizes[7] = 3, 0
    # bucket 0: FAR_ROWS rows of zeros, never probed; buckets 1..n_cat
    # behind it, random unit rows with sentinel gaps between them
    tail, offsets, counts = random_store(D_SEARCH, sizes.tolist(), dev, gen,
                                         torch.bfloat16)
    data = torch.zeros((FAR_ROWS + tail.shape[0], D_SEARCH),
                       dtype=torch.bfloat16, device=dev)
    data[FAR_ROWS:] = tail
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    offsets = torch.cat([zero, offsets + FAR_ROWS])
    counts = torch.cat([zero + FAR_ROWS, counts])
    del tail
    nq, p, k, k_out, mc = 2000, 2, 10, 20, 1024
    qf = torch.randn((nq, D_SEARCH), generator=gen, device=dev)
    qf = qf / qf.norm(dim=1, keepdim=True)
    q = qf.to(torch.bfloat16)
    probes = 1 + torch.argsort(torch.rand((nq, n_cat), generator=gen,
                                          device=dev), dim=1)[:, :p]
    probes[:, 1] = torch.where(torch.rand(nq, generator=gen, device=dev)
                               < 0.2, n_cat + 1, probes[:, 1])   # dumped
    layout = group_slots(probes.int(), offsets, counts)
    live = layout.slot_of_row < nq * p
    items = worklist_total(layout, counts, mc)

    def note(name, err, what):
        errs[name] = max(errs.get(name, 0.0), err)
        log(f"[far] {name} {what}: max |err| {err:.3g}")

    def far_ids(out, what):
        ids = out[1][live]
        if not bool(((ids < 0) | (ids >= FAR_ROWS)).all()):
            raise AssertionError(f"{what} returned a row before the probed "
                                 f"buckets")
        return out

    kinds = store_kinds(q, qf, data, layout, ("full", "quant8", "int8q8"))
    for name, fn, plain, args, tail, own, tol, rescale in kinds:
        what = f"k={k} probes={p} queries={nq}"
        note(name, compare(far_ids(fn(*args, k, *tail), name),
                           plain(*args, k, *tail), own, layout, nq * p,
                           tol), what)
        note("probe_pair", compare(
            far_ids(fn(*args, k, *tail, pair=True), "the 128-row tile"),
            plain(*args, k, *tail, pair=True), own, layout, nq * p, tol),
            f"{name} {what}")
        note("probe_worklist", compare(
            far_ids(fn(*args, k, *tail, wl_pad=items, item_rows=mc)[:2],
                    "the worklist"),
            plain(*args, k, *tail, wl_pad=items, item_rows=mc)[:2], own,
            layout, nq * p, tol), f"{name} {what} items={items}")
        parts = fn(*args, k, *tail, wl_pad=items, item_rows=mc, merge=False)
        merged = merge_items(layout.blocks, parts, k)
        want = merge_items_plain(layout.blocks, parts, k)
        if not (torch.equal(merged[0][live], want[0][live])
                and torch.equal(merged[1][live], want[1][live])):
            raise AssertionError(f"the merge kernel differs from its plain "
                                 f"version past element 2**31 ({name})")
        note("merge_items", 0.0, f"{name} {what}, to the bit")
        note("probe_pool", compare_pool(
            far_ids(fn(*args, k, *tail, k_out=k_out), "the pool"),
            plain(*args, k, *tail, k_out=k_out),
            plain(*args, k, *tail, k_out=k_out, merge=False, wl_pad=items,
                  item_rows=mc), rescale, own, layout, nq * p, k, tol),
            f"{name} {what} k_out={k_out}")
    log(f"[far] a store of {data.shape[0]} x {D_SEARCH} rows whose "
        f"{n_cat} probed buckets begin at row {FAR_ROWS} (element "
        f"{FAR_ROWS * D_SEARCH} > 2**31): K1, K2, K3, the 128-row tile, "
        f"the worklist and its merge kernel and the pool equal to their "
        f"plain versions, every id past the filler; "
        f"{time.perf_counter() - t:.1f}s")
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
                                             loop_launch_counts,
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
            before = launch_counts()["probe_topk"]
            torch.cuda.synchronize()
            t = time.perf_counter()
            dists, ids = index.search(*queries, n_buckets=p, k=10)
            runs.append(time.perf_counter() - t)
            if launch_counts()["probe_topk"] <= before:
                raise AssertionError(f"search at {p} probes launched no "
                                     f"probe kernel")
        searches[p] = (runs, dists, ids)
    loops = loop_launch_counts()
    if loops["staged"] or not loops["wgmma"]:
        raise AssertionError(f"the main path's searches did not all take "
                             f"the wgmma loop: {loops}")
    # a float32 search (compute_dtype=None) goes through the kernel too
    before = launch_counts()["probe_topk"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    f32_ids = index.search(*host, n_buckets=2, k=10,
                           search_config=SearchConfig(compute_dtype=None))[1]
    f32_s = time.perf_counter() - t
    if launch_counts()["probe_topk"] <= before:
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


def phase_hoststore(index, ds, dev, gt, cache):
    """Host-store builds (the JAX package's large-scale build): the native
    host library; build_with_host_store on the main data against build
    (pred, layout, store rows) and in bfloat16 (recall); then a realistic
    size, BIG_N rows made on the card by synthetic_dataset_big into the
    directory
    `cache`: an int8 host-store build (native gather, overlapped upload),
    the same layout again down the source-sequential path, a search at 4
    probes with the native rerank against a float32 oracle, and the
    rerank's two paths on the same candidates. Returns the BIG_N data and
    its oracle's ids, for phase_hier."""
    import gc
    import os

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
    t = time.perf_counter()
    big = synthetic_dataset_big(n=BIG_N, n_queries=N_QUERIES,
                                d_nav=D_NAV, d_search=D_SEARCH,
                                n_clusters=N_CAT, seed=SEED,
                                cache_dir=cache, backend="device", device=dev)
    gen_s = time.perf_counter() - t
    corpus = big["data_search"]
    log(f"[hoststore] synthetic_dataset_big(backend='device'): {BIG_N} x "
        f"{D_SEARCH} "
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
    del li, corpus
    gc.collect()
    torch.cuda.empty_cache()
    launches = launch_counts()
    for name in ("probe_topk", "probe_topk_quant_int8"):
        if not launches[name] > 0:
            raise AssertionError(f"the phase's searches launched no {name}")
    log(f"[hoststore] native calls {native_layout.calls}; launches "
        f"{ {n: c for n, c in launches.items() if c} }")
    return big, gt_big


def router_digest(index, pred) -> str:
    """sha256 of a build's centroids (a hierarchy's outer ones), router
    parameters (by name) and every row's bucket."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    built = index.built
    state = built.classifier.model.state_dict()
    for t in (built.centroids, *(state[n] for n in sorted(state))):
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    h.update(np.ascontiguousarray(pred).tobytes())
    return h.hexdigest()


def hier_config(n_groups=8):
    """bench_20m.py's hierarchical configuration (:188-206): `n_groups`
    groups (8; bench_40m.py's 16) x 61 buckets, an MLP-5 outer router (6
    epochs) and inner routers (8 epochs, batch 4096), row_align 1024;
    calibrated as a step of its own."""
    from tpulmi_torch import HierarchicalConfig, IndexConfig

    return HierarchicalConfig(
        n_groups=n_groups, outer_epochs=6, outer_lr=0.003, calibrate_budget=0,
        router_restarts=1,
        inner=IndexConfig(n_categories=61, epochs=8, lr=0.003,
                          model_type="MLP-5", batch_size=4096, seed=SEED,
                          row_align=1024))


def hier_build(tag, big, dev, store_dtype="int8", n_groups=8):
    """HierarchicalIndex(hier_config(n_groups)).build_with_host_store of
    `big` (navigation rows rounded to bfloat16 on the card, as bench_20m.py
    rounds them on the host; an int8 or int4 host store, overlapped
    upload), logged with its stages, the layout's own lines (its path and
    rows a second), bucket sizes, store bytes, where the rerank's corpus
    lives and a digest. Returns (index, pred)."""
    import numpy as np
    import torch
    from tpulmi_torch import HierarchicalIndex
    from tpulmi_torch.hoststore import is_memory_mapped, release_pages

    cfg = hier_config(n_groups)
    n_cat = cfg.inner.n_categories
    nav = big["data_nav"]
    t = time.perf_counter()
    nav_bf16 = torch.empty(nav.shape, dtype=torch.bfloat16, device=dev)
    for s in range(0, nav.shape[0], 1 << 21):
        nav_bf16[s:s + (1 << 21)] = torch.from_numpy(
            np.array(nav[s:s + (1 << 21)])).to(dev)
        release_pages(nav)
    conv_s = time.perf_counter() - t
    hi = HierarchicalIndex(cfg, device=dev)
    torch.cuda.synchronize()
    with kept_log("tpulmi_torch.hoststore") as lines:
        pred, build_s = hi.build_with_host_store(
            nav_bf16, big["data_search"], normalized=True,
            store_dtype=store_dtype, overlap_upload=True)
    del nav_bf16
    for line in lines:
        if "host layout" in line or "memory-mapped" in line:
            log(f"{tag} {line}")
    stages = hi.last_build_stages
    st = hi.built.store
    counts = st.counts.cpu().numpy()
    groups = np.bincount(pred // n_cat, minlength=n_groups)
    store_bytes = (st.data_sorted.numel() + st.scales.numel() * 4
                   + st.ids_sorted.numel() * 4)
    kept = hi._host_corpus[0]
    log(f"{tag} {nav.shape[0]} rows, {n_groups} x {n_cat} = "
        f"{st.n_categories} buckets, {store_dtype} host store: "
        f"build_with_host_store "
        f"{build_s:.2f}s = nav stages {stages['nav']:.2f}s + waiting for the "
        f"corpus copy {stages['materialize_wait']:.2f}s + layout and upload "
        f"{stages['layout_upload']:.2f}s (navigation rows rounded to "
        f"bfloat16 in {conv_s:.2f}s); outer groups {groups.tolist()}; "
        f"bucket rows max / mean / min {counts.max()} / {counts.mean():.0f}"
        f" / {counts.min()}; store on the card "
        f"{tuple(st.data_sorted.shape)} {store_dtype} + scales + ids = "
        f"{store_bytes / 1e9:.3f} GB; the rerank's corpus "
        f"({kept.nbytes / 1e9:.2f} GB) "
        + ("left memory-mapped" if is_memory_mapped(kept)
           else "copied into RAM"))
    log(f"{tag} build digest (sha256 of outer centroids, router "
        f"parameters, pred): {router_digest(hi, pred)}")
    return hi, pred


def hier_calibrate(tag, hi, data_nav, beside=""):
    t = time.perf_counter()
    cal = hi.calibrate_outer_weight(data_nav, probe_budget=24)
    log(f"{tag} calibrate_outer_weight at 24 probes: w {cal['best']}, "
        f"containment at w=1 {cal['baseline_w1']:.4f}, at the best w "
        f"{cal['best_containment']:.4f}; mass_temp {cal['mass_temp']}; "
        f"{time.perf_counter() - t:.2f}s{beside}")


def hier_searcher(hi, queries, rerank_extra=10):
    """search(p, batch=queries, **opts) -> (dists, ids, seconds, host
    rerank seconds, 0 where the rerank ran on the card): a warm-up and one
    timed search, int8 queries, rerank depth `rerank_extra` (10; opts may
    name another), items of 1024 rows (bench_20m.py's)."""
    import numpy as np
    import torch
    from tpulmi_torch import SearchConfig

    seen = {}
    plain_rerank = hi._rerank_host

    def timed_rerank(*a, **kw):
        t = time.perf_counter()
        out = plain_rerank(*a, **kw)
        seen["rerank_s"] = time.perf_counter() - t
        return out

    def search(p, batch=queries, int8_queries=True, **opts):
        opts.setdefault("rerank_extra", rerank_extra)
        kw = dict(n_buckets=p, k=10, search_config=SearchConfig(
            k=10, n_buckets=p, int8_queries=int8_queries, pallas_mc=1024,
            **opts))
        hi._rerank_host = timed_rerank
        seen.clear()
        try:
            hi.search(*batch, **kw)
            torch.cuda.synchronize()
            t = time.perf_counter()
            d, ids = hi.search(*batch, **kw)
            secs = time.perf_counter() - t
        finally:
            del hi._rerank_host
        if d.shape != (batch[0].shape[0], 10) or not np.isfinite(d).all():
            raise AssertionError(f"bad hierarchical result {d.shape}")
        return d, ids, secs, seen.get("rerank_s", 0.0)
    return search


def hier_sweep(tag, search, oracles, n_buckets, beside="",
               budgets=(6, 8, 12, 16, 24, 32, 48), required=True, ref=None,
               **opts):
    """bench_20m.py's probe sweep over `budgets` (6 to 48 probes) until
    recall@10 against the first of `oracles` ({label: 0-based ids}) reaches
    RECALL_GATE; `opts` go to every search (a rerank depth), and `ref`
    ({budget: recall@10}) is printed beside each budget it names. Returns
    (budget, (dists, ids)); if no budget does, the phase fails, or with
    ``required=False`` None is returned."""
    from tpulmi_torch.evaluate import recall_at_k

    depth = (f" depth {opts['rerank_extra']}" if "rerank_extra" in opts
             else "")
    for p in budgets:
        d, ids, secs, rr = search(p, **opts)
        recs = {lbl: recall_at_k(ids - 1, gt, 10)
                for lbl, gt in oracles.items()}
        log(f"{tag} probes={p}{depth}: recall@10 " + ", ".join(
            f"{r:.4f} against the {lbl} oracle" for lbl, r in recs.items())
            + (f" (the JAX package: {ref[p]})" if ref and p in ref else "")
            + f"; search {secs:.4f}s = {len(ids) / secs:.0f} QPS, of which "
            f"rerank {rr:.4f}s ({rr / secs:.1%})")
        if next(iter(recs.values())) >= RECALL_GATE:
            log(f"{tag} first budget with recall@10 >= {RECALL_GATE}: {p} "
                f"of {n_buckets} probes{depth}{beside}")
            return p, (d, ids)
    if not required:
        return None
    raise AssertionError(f"no probe budget up to {budgets[-1]} reached "
                         f"recall@10 {RECALL_GATE}")


def hier_variants(tag, search, p, dense, queries, corpus, gt,
                  hold_pool=True, pool_beside=""):
    """At budget p: the worklist and the 128-row tile equal to the dense
    search but for ties; the pool and float queries (K2), whose candidate
    lists differ from the dense kernel's by design (the pool's extras are
    per-class best rows; bfloat16 queries round otherwise than int8
    codes), with the rows whose distances differ and a recall within 0.01
    of the dense search's (the pool's only with `hold_pool`: its extras
    cap the rerank's depth, which an int4 store needs deep)."""
    import numpy as np
    from tpulmi_torch.evaluate import recall_at_k

    qs = queries[1]
    want = recall_at_k(dense[1] - 1, gt, 10)
    for label, opts in (("worklist", dict(pallas_worklist=True)),
                        ("128-row tile", dict(pallas_pair=True))):
        d, ids, secs, _ = search(p, **opts)
        rows = equal_but_ties(ids, d, dense[1], dense[0], qs, corpus, 1e-6)
        log(f"{tag} {label} at {p} probes: equal to the dense search but "
            f"for ties ({rows} rows differ); {secs:.4f}s")
    for label, opts in (("pool", dict(pallas_pool=True)),
                        ("float queries (K2)", dict(int8_queries=False))):
        d, ids, secs, _ = search(p, **opts)
        rec = recall_at_k(ids - 1, gt, 10)
        moved = int((np.abs(d - dense[0]) > 1e-6).any(axis=1).sum())
        log(f"{tag} {label} at {p} probes: recall@10 {rec:.4f} (dense "
            f"{want:.4f}); {int((ids != dense[1]).any(axis=1).sum())} rows "
            f"hold other ids, {moved} of them other distances; {secs:.4f}s"
            + (pool_beside if label == "pool" else ""))
        if label == "pool" and not hold_pool:
            continue
        if not abs(rec - want) <= 0.01:
            raise AssertionError(f"{label}: recall@10 {rec} is more than "
                                 f"0.01 from the dense search's {want}")


def stream_equal(tag, index, batches, kw):
    """search_stream (depth STREAM_DEPTH) over `batches` ((nav, search) or
    (nav, search, host mirror)), every batch equal to search's result to
    the bit; the seconds a batch of each."""
    import numpy as np
    import torch

    def search(b):
        return index.search(*b[:2], queries_search_host=(
            b[2] if len(b) > 2 else None), **kw)

    search(batches[0])
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = [search(b) for b in batches]
    search_s = (time.perf_counter() - t) / len(batches)
    t = time.perf_counter()
    got = list(index.search_stream(batches, depth=STREAM_DEPTH, **kw))
    stream_s = (time.perf_counter() - t) / len(batches)
    if len(got) != len(batches):
        raise AssertionError(f"the stream gave {len(got)} results")
    for i, ((gd, gi), (wd, wi)) in enumerate(zip(got, want)):
        if not (np.array_equal(gi, wi) and np.array_equal(gd, wd)):
            raise AssertionError(f"stream batch {i} differs from search")
    log(f"{tag} search_stream: {len(batches)} batches of "
        f"{len(batches[0][0])} "
        + ("with the host mirror of the queries " if len(batches[0]) > 2
           else "") + f"equal to search; {stream_s:.4f}s a batch (search "
        f"{search_s:.4f}s a batch)")


def hier_stream(tag, hi, queries, p, rerank_extra=10):
    """`stream_equal` over 4 batches of the queries (rolled by 2500 each),
    with int8 queries at p probes and rerank depth `rerank_extra`.
    Returns the search keywords."""
    import numpy as np
    from tpulmi_torch import SearchConfig

    batches = [tuple(np.roll(x, -2500 * i, axis=0) for x in queries)
               for i in range(4)]
    kw = dict(n_buckets=p, k=10, search_config=SearchConfig(
        k=10, n_buckets=p, int8_queries=True, rerank_extra=rerank_extra,
        pallas_mc=1024))
    stream_equal(tag, hi, batches, kw)
    return kw


def float16_copy_of(index):
    """The float16 copy of the rerank corpus that a float16 rerank read:
    on the card where the plan put the rerank there, else on the host."""
    return (index._card_copy or index._rerank_shadow)[1]


def rerank_card_on_path(tag, index, search, name):
    """The rerank kernel (csrc/rerank_card.cu) on a path's own candidates.
    `search()` runs float16-rerank searches of `index` that the plan puts
    on the card: the kernel's launches (``rerank_card.launches``, from 0)
    must equal the searches' calls of it, and the counter `rerank_card`
    must grow as `queries` does. On the last call's (q, k_eff) candidates
    and queries the kernel is then held against `rerank_card_plain` on the
    card: distances within RERANK_TOL, ids equal but where the plain
    version's distance lies within RERANK_TOL of a neighbour's (a tie); and
    timed by CUDA events beside the plain version and its bound by the
    bytes that must move (each distinct candidate row, the queries, the
    ids, the results). Returns the numbers of the `kernels` line."""
    import numpy as np
    import torch
    from tpulmi_torch.ops.rerank_card import rerank_card, rerank_card_plain
    from tpulmi_torch.utils.profiling import counters

    calls = []
    on_card = index._rerank_on_card

    def kept(out, queries_search, plan):
        calls.append((out[1].clone(), queries_search.contiguous(), plan.k))
        return on_card(out, queries_search, plan)

    index._rerank_on_card = kept
    before = counters()
    rerank_card.launches = 0
    try:
        search()
        torch.cuda.synchronize()
    finally:
        del index._rerank_on_card
    launches, after = rerank_card.launches, counters()
    counted, queries = (after.get(c, 0) - before.get(c, 0)
                        for c in ("rerank_card", "queries"))
    if not (calls and launches == len(calls) and counted == queries):
        raise AssertionError(
            f"{tag} the float16 searches called the card's rerank "
            f"{len(calls)} times, launched its kernel {launches} times, "
            f"and counted {counted} reranked of {queries} queries")
    ids, qs, k = calls[-1]
    copy, normalized = index._card_copy[1], index._host_corpus[1]

    def kernel():
        return rerank_card(copy, ids, qs, k, normalized=normalized)

    def plain():
        return rerank_card_plain(copy, ids, qs, k, normalized=normalized)

    got, want = kernel(), plain()
    gd, gi, wd, wi = (x.cpu().numpy() for x in (*got, *want))
    err = float(abs(gd - wd).max())
    if not err <= RERANK_TOL:
        raise AssertionError(f"{tag} the rerank kernel's distances differ "
                             f"from its plain version's by {err}")
    step = abs(wd[:, 1:] - wd[:, :-1]) <= RERANK_TOL
    tied = np.zeros(wd.shape, bool)
    tied[:, 1:] |= step
    tied[:, :-1] |= step
    differ = gi != wi
    untied = int((differ & ~tied).any(axis=1).sum())
    if untied:
        raise AssertionError(f"{tag} the rerank kernel's ids differ from "
                             f"its plain version's, untied, in {untied} "
                             f"rows")
    q, k_eff = ids.shape
    n, d = copy.shape
    srt = ids.sort(dim=1).values
    fresh = torch.ones_like(srt, dtype=torch.bool)
    fresh[:, 1:] = srt[:, 1:] != srt[:, :-1]
    rows = int(((srt >= 0) & fresh).sum())
    nbytes = (rows * d * 2 + q * d * 4 + ids.numel() * ids.element_size()
              + q * k * (4 + ids.element_size()))
    bound_ms = nbytes / peaks(name)[1] * 1e3
    ms = cuda_ms(kernel, 20)
    plain_ms = cuda_ms(plain, 3)
    log(f"{tag} rerank_card on the path's candidates (q {q}, k_eff "
        f"{k_eff}, k {k}, d {d}, {n} rows on the card): {len(calls)} "
        f"launches over the float16 searches, rerank_card {counted} = "
        f"queries {queries}; against its plain version max |err| "
        f"{err:.3g}, ids differ in {int(differ.any(axis=1).sum())} rows, "
        f"all at ties; {ms:.4f} ms = {nbytes / ms / 1e6:.1f} GB/s of the "
        f"{nbytes / 1e9:.4f} GB that must move ({rows} distinct rows); "
        f"bound {bound_ms:.4f} ms by bytes; plain {plain_ms:.3f} ms; {name}")
    return dict(launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None,
                q=q, k_eff=k_eff, rows=n)


def hier_float16_shadow(tag, hi, search, p, dense, gt):
    """rerank_dtype="float16" at budget p: the port's guard refuses a
    float16 copy of the corpus that the host's available memory cannot
    hold, before allocating it (the JAX package's 40M run was refused,
    BENCH_40M.md); where the guard admits it, the search with the copy
    must come within 0.01 of the float32 rerank's recall@10, and the copy
    is dropped after it."""
    import gc

    from tpulmi_torch.evaluate import recall_at_k

    t = time.perf_counter()
    try:
        _, ids, secs, _ = search(p, rerank_dtype="float16")
    except RuntimeError as e:
        if "shadow" not in str(e):
            raise
        log(f"{tag} rerank_dtype='float16' refused before the copy was "
            f"allocated ({e}); {host_memory()}")
        return
    made = time.perf_counter() - t
    shadow = float16_copy_of(hi)
    rec, want = (recall_at_k(x - 1, gt, 10) for x in (ids, dense[1]))
    log(f"{tag} rerank_dtype='float16' admitted by the guard at this size: "
        f"a {shadow.nbytes / 1e9:.2f} GB float16 copy of the corpus, made "
        f"and searched twice in {made:.2f}s; recall@10 {rec:.4f} (float32 "
        f"rerank {want:.4f}); {secs:.4f}s a search; {host_memory()}")
    del shadow
    hi._rerank_shadow = hi._card_copy = None
    gc.collect()
    if not abs(rec - want) <= 0.01:
        raise AssertionError(f"the float16 rerank's recall@10 {rec} is more "
                             f"than 0.01 from the float32 rerank's {want}")


def on_path(index, queries, p, dev):
    """The normalized queries and the slot layout of a search of `queries`
    at p probes over the store of `index` (flat or hierarchical), as the
    search program makes them."""
    import torch
    from tpulmi_torch.ops.distance import l2_normalize
    from tpulmi_torch.ops.probe_topk import group_slots
    from tpulmi_torch.search import route_probes, routing_logits

    store = index.built.store
    with torch.no_grad():
        probes = route_probes(routing_logits(
            index.built.classifier.model, torch.as_tensor(
                queries[0], dtype=torch.float32, device=dev),
            need_mass=False)[0], p)
        qf = l2_normalize(torch.as_tensor(queries[1], device=dev).float())
    return qf, group_slots(probes, store.offsets, store.counts)


HOLD_ALL = ("int8q", "worklist", "pair", "pool", "quant")


def hold_on_path(tag, index, queries, p, dev, errs, bits=8, depth=10,
                 kernels=HOLD_ALL):
    """Each kernel of a path against its plain version on the inputs that
    the path gives it (its probes, its store of `bits`-bit codes and
    `queries`), those of `kernels`: "int8q" K3 dense, "worklist" the
    worklist with its merge kernel (the merge to the bit), "pair" the
    128-row tile, each at k 10 + `depth` (the rerank's list), "pool" the
    pool at k 10 / k_out 10 + `depth`, "quant" K2 with bfloat16 queries;
    their errors go into `errs`."""
    import torch
    from tpulmi_torch.ops.probe_topk import (
        apply_query_scale, merge_items, merge_items_plain, probe_topk_int8q,
        probe_topk_int8q_plain, probe_topk_quant, probe_topk_quant_plain)
    from tpulmi_torch.ops.quantize import quantize_rows

    def hold(kname, err, what, how="but for ties"):
        errs[kname] = max(errs.get(kname, 0.0), err)
        log(f"{tag} {kname} {what}: equal to its plain version {how}, "
            f"max |err| {err:.3g}")

    t = time.perf_counter()
    st = index.built.store
    k_eff, k_pool, mc = 10 + depth, 10, 1024   # k + rerank depth; pallas_mc
    qf, lay = on_path(index, queries, p, dev)
    n_q = qf.shape[0]
    n_slots = n_q * p
    q_codes, q_scales = quantize_rows(qf)
    args = (q_codes, q_scales, lay.qidx, st.data_sorted, st.scales,
            lay.blocks)
    own8q = own_quant(q_codes, st.data_sorted, st.scales, bits, q_scales)
    items = worklist_total(lay, st.counts, mc)
    on = (f"at {p} probes over {st.n_categories} buckets of int{bits} "
          f"codes, {n_q} queries, {lay.blocks.shape[0]} blocks")
    plain = probe_topk_int8q_plain(*args, k_eff, bits)
    if "int8q" in kernels:
        hold(f"probe_topk_int8q_int{bits}", compare(
            probe_topk_int8q(*args, k_eff, bits), plain, own8q, lay,
            n_slots, INT8Q_TOL), f"(k {k_eff}) {on}")
    if "worklist" in kernels:
        hold("probe_worklist", compare(
            probe_topk_int8q(*args, k_eff, bits, wl_pad=items,
                             item_rows=mc)[:2], plain, own8q, lay, n_slots,
            INT8Q_TOL), f"(k {k_eff}, {items} items of {mc} rows) {on}")
        parts = probe_topk_int8q(*args, k_eff, bits, wl_pad=items,
                                 item_rows=mc, merge=False)
        merged = merge_items(lay.blocks, parts, k_eff)
        want = merge_items_plain(lay.blocks, parts, k_eff)
        live = lay.slot_of_row < n_slots
        if not (torch.equal(merged[0][live], want[0][live])
                and torch.equal(merged[1][live], want[1][live])):
            raise AssertionError("the merge kernel differs from its plain "
                                 "version on the path's items")
        hold("merge_items", 0.0, f"({items} items, k {k_eff}) {on}",
             "to the bit")
        del parts, merged, want
    if "pair" in kernels:
        hold("probe_pair", compare(
            probe_topk_int8q(*args, k_eff, bits, pair=True), plain, own8q,
            lay, n_slots, INT8Q_TOL), f"(k {k_eff}) {on}")
    del plain
    if "pool" in kernels:
        hold("probe_pool", compare_pool(
            probe_topk_int8q(*args, k_pool, bits, k_out=k_eff),
            probe_topk_int8q_plain(*args, k_pool, bits, k_out=k_eff),
            probe_topk_int8q_plain(*args, k_pool, bits, k_out=k_eff,
                                   merge=False, wl_pad=items, item_rows=mc),
            lambda out: apply_query_scale(out, q_scales, lay.qidx), own8q,
            lay, n_slots, k_pool, INT8Q_TOL),
            f"(k {k_pool}, k_out {k_eff}) {on}")
    if "quant" in kernels:
        qb = qf.to(torch.bfloat16)
        quant = (qb, lay.qidx, st.data_sorted, st.scales, lay.blocks, k_eff,
                 bits)
        hold(f"probe_topk_quant_int{bits}", compare(
            probe_topk_quant(*quant), probe_topk_quant_plain(*quant),
            own_quant(qb, st.data_sorted, st.scales, bits), lay, n_slots,
            DIST_TOL), f"(bfloat16 queries, k {k_eff}) {on}")
    log(f"{tag} the kernels against their plain versions on the path's "
        f"inputs: {time.perf_counter() - t:.1f}s")


def library_int8q(q_codes, codes, scales, bits, layout, k):
    """K3's function as library calls, one set a probed bucket of
    `layout`: torch._int_mm of the bucket's int8 query codes and its codes
    (packed int4 unpacked first), the rows' scales applied, torch.topk (the
    queries' scales, one positive factor a row, are left out). Returns the
    callable; the buckets' query rows are gathered before."""
    import torch
    from tpulmi_torch.ops.probe_topk import Q_LEVELS, bucket_runs
    from tpulmi_torch.ops.quantize import unpack_int4

    sc = scales / Q_LEVELS[bits]
    runs = bucket_runs(layout.blocks)
    qrows = [layout.qidx[rows].long() for _, _, rows in runs]

    def library():
        for (start, cnt, _), qr in zip(runs, qrows):
            # _int_mm wants more than 16 rows and a width in eights
            if qr.numel() <= 16:
                qr = qr.repeat(-(-17 // qr.numel()))
            wide = min(-(-cnt // 8) * 8, codes.shape[0] - start)
            x = codes[start:start + wide]
            x = unpack_int4(x) if bits == 4 else x
            dots = torch._int_mm(q_codes[qr], x.T)[:, :cnt]
            torch.topk(dots.float() * sc[start:start + cnt], min(k, cnt),
                       dim=1)
    return library


def k3_time(tag, index, queries, p, dev, name, bits=8, depth=10):
    """K3 (int8 queries x `bits`-bit codes, k 10 + `depth`) on the path's
    probes, queries and store, by CUDA events, beside the least time the
    card could take, reckoned as phase timing does (each probed bucket's
    rows, d bits / 8 bytes each, and scales, the queries and the slot
    layout read once, the results written once; 2 d slots rows operations
    per bucket at the int8 tensor-core rate), and beside `library_int8q`
    on the same slots. Returns K3's ms."""
    from tpulmi_torch.ops.probe_topk import probe_topk_int8q
    from tpulmi_torch.ops.quantize import quantize_rows

    st = index.built.store
    qf, lay = on_path(index, queries, p, dev)
    q_codes, q_scales = quantize_rows(qf)
    k = 10 + depth
    args = (q_codes, q_scales, lay.qidx, st.data_sorted, st.scales,
            lay.blocks, k, bits)
    ms = cuda_ms(lambda: probe_topk_int8q(*args), 20)
    lib_ms = cuda_ms(library_int8q(q_codes, st.data_sorted, st.scales, bits,
                                   lay, k), 3)
    slots, rows = lay.slot_counts.double(), st.counts.double()
    n_q = qf.shape[0]
    ops = float(2 * D_SEARCH * (slots * rows).sum())
    nbytes = (float(rows[slots > 0].sum()) * (D_SEARCH * bits // 8 + 4)
              + n_q * (D_SEARCH + 4) + lay.qidx.numel() * 4
              + lay.blocks.numel() * 4 + n_q * p * k * 8)
    peak_flops, peak_bw = peaks(name)
    t_ops = ops / (peak_flops * INT8_OVER_BF16) * 1e3
    t_bytes = nbytes / peak_bw * 1e3
    bound = max(t_ops, t_bytes)
    log(f"{tag} K3 (int8 x int{bits}, k {k}) at {p} probes over "
        f"{st.n_categories} buckets, {n_q} queries: {ms:.4f} ms (CUDA "
        f"events, mean of 20); {ops / 1e9:.2f} GOP -> {t_ops:.4f} ms, "
        f"{nbytes / 1e9:.4f} GB -> {t_bytes:.4f} ms; bound {bound:.4f} ms "
        f"by {'operations' if t_ops >= t_bytes else 'bytes'} "
        f"({ms / bound:.1f}x); library {lib_ms:.4f} ms (per probed bucket "
        f"torch._int_mm, scale, topk; mean of 3), {lib_ms / ms:.2f}x K3's "
        f"time")
    return ms


def phase_hier(index, ds, dev, gt, big, gt_big, cache, name, errs):
    """The hierarchical index at the JAX package's 20M configuration
    (`hier_config`, bench_20m.py:188-206: 8 groups x 61 buckets = 488,
    row_align 1024, int8 store, int8 queries, rerank depth 10). Cut in
    scale only: the BIG_N rows and 122 data clusters of phase_hoststore's
    corpus (phase_hier20m runs 20M rows and 244 clusters), ~4.1k rows a
    bucket (~41k there). Steps: `hier_build` with a digest of what it
    built; calibrate_outer_weight at 24 probes; `hier_sweep` of 10k host
    queries against the float32 oracle; at the found budget
    `hier_variants` and probe_mass 0.95 / 0.9; search_stream over 4
    batches, each equal to search; one save / load; a device-store
    HierarchicalIndex.build of the main data (2 x 61 buckets) searched in
    bfloat16 at 2 probes (K1) beside the flat index. Every kernel of the
    path must launch. Then `hold_on_path` on all 10k queries and K1 on the
    device store against its plain version; their errors go into `errs`.
    Last, K3's time at the found budget. Launches made after the path's
    count was read are not counted."""
    import gc
    import os

    import numpy as np
    import torch
    from tpulmi_torch import (HierarchicalConfig, HierarchicalIndex,
                              IndexConfig)
    from tpulmi_torch.evaluate import recall_at_k
    from tpulmi_torch.ops.probe_topk import (launch_counts, probe_topk,
                                             probe_topk_plain,
                                             reset_launch_counts)
    from tpulmi_torch.search import route_probes, routing_logits

    tag = "[hier]"
    corpus = big["data_search"]
    queries = qn, qs = big["queries_nav"], big["queries_search"]
    reset_launch_counts()
    hi, pred = hier_build(tag, big, dev)
    st = hi.built.store
    hier_calibrate(tag, hi, big["data_nav"])
    search = hier_searcher(hi, queries)
    p, dense = hier_sweep(tag, search, {"float32": gt_big}, st.n_categories,
                          " (the JAX package's 20M run: 0.9105 at 8, "
                          "BENCH_20M.md)")
    hier_variants(tag, search, p, dense, queries, corpus, gt_big)
    with torch.no_grad():
        logits, mass = routing_logits(hi.built.classifier.model,
                                      torch.as_tensor(qn, device=dev),
                                      need_mass=True)
    for m in (0.95, 0.9):
        d, ids, secs, _ = search(p, probe_mass=m)
        kept = route_probes(logits, p, probe_mass=m, dump_id=st.n_categories,
                            mass_logits=mass)
        kept = float((kept < st.n_categories).float().sum(1).mean())
        log(f"{tag} probe_mass {m} at {p} probes: recall@10 "
            f"{recall_at_k(ids - 1, gt_big, 10):.4f}, {kept:.2f} probes kept "
            f"a query on average; {secs:.4f}s")

    # ---- serving ----
    kw = hier_stream(tag, hi, queries, p)

    # ---- checkpoint ----
    path = os.path.join(cache, "hier_ckpt")
    t = time.perf_counter()
    hi.save(path)
    save_s = time.perf_counter() - t
    t = time.perf_counter()
    back = HierarchicalIndex.load(path, device=dev)
    load_s = time.perf_counter() - t
    # the build's RAM copy of the corpus has no file to record: reattach
    # it (checked against the checkpoint's fingerprint)
    back.attach_host_corpus(hi._host_corpus[0])
    a, b = hi.built.classifier.model, back.built.classifier.model
    if (a.outer_weight, a.mass_temp) != (b.outer_weight, b.mass_temp):
        raise AssertionError("the checkpoint lost the outer weight or the "
                             "mass temperature")
    d1, i1 = hi.search(qn, qs, **kw)
    d2, i2 = back.search(qn, qs, **kw)
    if not (np.array_equal(i1, i2) and np.array_equal(d1, d2)):
        raise AssertionError("the restored index searches differently")
    log(f"{tag} save {save_s:.2f}s, load {load_s:.2f}s, corpus reattached:"
        f" outer weight, mass_temp and results equal")
    del back, a, b

    # ---- the device store, small ----
    n_cat = hier_config().inner.n_categories
    small = HierarchicalIndex(HierarchicalConfig(
        n_groups=2, outer_epochs=12, calibrate_budget=2,
        inner=IndexConfig(n_categories=n_cat, epochs=12, lr=0.003,
                          model_type="MLP-5", batch_size=1024, seed=SEED)),
        device=dev)
    _, small_s = small.build(ds["data_nav"], ds["data_search"])
    host = (ds["queries_nav"], ds["queries_search"])
    small_rec = recall_at_k(small.search(*host, n_buckets=2, k=10)[1] - 1,
                            gt, 10)
    flat_rec = recall_at_k(index.search(*host, n_buckets=2, k=10)[1] - 1,
                           gt, 10)
    log(f"{tag} device store, main data, 2 x {n_cat} buckets: build "
        f"{small_s:.2f}s; bfloat16 search at 2 probes recall@10 "
        f"{small_rec:.4f} (the flat index, 122 buckets: {flat_rec:.4f})")

    # ---- every kernel of the path launched ----
    launches = launch_counts()
    for kname in ("probe_topk", "probe_topk_quant_int8",
                  "probe_topk_int8q_int8", "probe_worklist", "merge_items",
                  "probe_pool", "probe_pair"):
        if not launches[kname] > 0:
            raise AssertionError(f"the hierarchical phase launched no "
                                 f"{kname}")
    log(f"{tag} launches {({n: c for n, c in launches.items() if c})}")

    # ---- each kernel against its plain version on the path's inputs
    # (these launches come after the count was read) ----
    hold_on_path(tag, hi, queries, p, dev, errs)
    sst = small.built.store
    qf1, lay1 = on_path(small, host, 2, dev)
    q1, data1 = qf1.to(torch.bfloat16), sst.data_as(torch.bfloat16)
    full = (q1, lay1.qidx, data1, lay1.blocks, 10)
    err = compare(probe_topk(*full), probe_topk_plain(*full),
                  own_full(q1, data1), lay1, N_QUERIES * 2, DIST_TOL)
    errs["probe_topk"] = max(errs.get("probe_topk", 0.0), err)
    log(f"{tag} probe_topk (bfloat16, k 10) at 2 probes over the device "
        f"store's {sst.n_categories} buckets: equal to its plain version "
        f"but for ties, max |err| {err:.3g}")
    del small, sst, data1, full
    k3_time(tag, hi, queries, p, dev, name)
    # what phase_shard holds its mesh build to; the flat store stays on
    # the card until then
    ref = dict(cfg=hier_config(), pred=pred, store=st, p=p, dense=dense,
               outer_weight=hi.built.classifier.model.outer_weight,
               mass_temp=hi.built.classifier.model.mass_temp)
    del hi, dense
    gc.collect()
    torch.cuda.empty_cache()
    return launches, ref


def host_memory() -> str:
    """This process's resident memory (with its anonymous and file-mapped
    parts and its peak, where the kernel reports them) and its control
    group's use, GB."""
    names = {"VmRSS": "resident", "RssAnon": "anonymous",
             "RssFile": "file-mapped", "VmHWM": "peak"}
    parts = []
    with open("/proc/self/status") as f:
        for line in f:
            key, _, val = line.partition(":")
            if key in names:
                parts.append(f"{names[key]} "
                             f"{int(val.split()[0]) * 1024 / 1e9:.2f} GB")
    group = "not reported"
    for path in ("/sys/fs/cgroup/memory.current",
                 "/sys/fs/cgroup/memory/memory.usage_in_bytes"):
        try:
            with open(path) as f:
                group = f"{int(f.read()) / 1e9:.1f} GB"
            break
        except (OSError, ValueError):
            continue
    return (f"{', '.join(parts) or 'resident memory not reported'}; "
            f"control group {group}")


@contextlib.contextmanager
def environ(values):
    """The environment variables `values` set inside the block, restored
    after it."""
    import os

    before = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def kept_log(name):
    """The messages that logger `name` emits inside the block, from any
    thread, as a list."""
    import logging

    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Keep()
    logging.getLogger(name).addHandler(handler)
    try:
        yield lines
    finally:
        logging.getLogger(name).removeHandler(handler)


class PeakMemory:
    """The largest resident set of this process and the largest host memory
    in use with the page cache counted (MemTotal - MemFree; the card's
    machine counts a command's page cache against it) seen while the block
    runs, sampled every 0.2 s from a thread of its own, GB."""

    def __enter__(self):
        import threading

        self.rss = self.used = 0.0
        self._stop = threading.Event()
        self._th = threading.Thread(target=self._run, daemon=True)
        self._th.start()
        return self

    def _run(self):
        while True:
            self._sample()
            if self._stop.wait(0.2):
                return

    def _sample(self):
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    self.rss = max(self.rss, int(line.split()[1]) * 1024e-9)
        mem = {}
        with open("/proc/meminfo") as f:
            for line in f:
                key, val = line.split(":", 1)
                mem[key] = int(val.split()[0]) * 1024e-9
        self.used = max(self.used, mem["MemTotal"] - mem["MemFree"])

    def __exit__(self, *exc):
        self._stop.set()
        self._th.join()
        self._sample()

    def __str__(self):
        return (f"peak resident set {self.rss:.2f} GB, peak host memory in "
                f"use with the page cache {self.used:.2f} GB")


def host_resources(path) -> str:
    """The host's RAM (total, available), the free disk under `path` and
    the core count."""
    import os
    import shutil

    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            mem[key] = int(val.split()[0]) * 1024
    disk = shutil.disk_usage(path)
    return (f"RAM {mem['MemTotal'] / 1e9:.1f} GB ("
            f"{mem.get('MemAvailable', 0) / 1e9:.1f} GB available), free "
            f"disk under {path} {disk.free / 1e9:.1f} of "
            f"{disk.total / 1e9:.1f} GB, {os.cpu_count()} cores")


def check_disk(tag, cache, n):
    """Log the host's RAM, disk and cores; fail unless the disk under
    `cache` holds a corpus of n rows (bfloat16 and navigation features)
    and DISK_SPARE."""
    import shutil

    log(f"{tag} host: {host_resources(cache)}; {host_cpu_line()}; "
        f"{host_memory()}")
    need = n * (D_SEARCH * 2 + D_NAV * 4) + DISK_SPARE
    free = shutil.disk_usage(cache).free
    log(f"{tag} free disk {free / 1e9:.1f} GB against {need / 1e9:.1f} GB "
        f"({n} rows of bfloat16 and navigation features, and "
        f"{DISK_SPARE / 1e9:.0f} GB spare)")
    if free < need:
        raise AssertionError(f"{tag} needs {need / 1e9:.1f} GB of free disk "
                             f"under {cache}, but only {free / 1e9:.1f} GB "
                             f"are free")


def big_corpus(tag, n, n_clusters, cache, dev):
    """synthetic_dataset_big(n, n_clusters, backend="device") of 10k
    queries into `cache`, logged with its seconds, GB written a second,
    seconds by stage and the peak host memory while writing."""
    from tpulmi_torch.data import synthetic_dataset_big

    t = time.perf_counter()
    with kept_log("tpulmi_torch.data") as lines, PeakMemory() as peak:
        big = synthetic_dataset_big(
            n=n, n_queries=N_QUERIES, d_nav=D_NAV, d_search=D_SEARCH,
            n_clusters=n_clusters, seed=SEED, cache_dir=cache,
            backend="device", device=dev)
    gen_s = time.perf_counter() - t
    written = big["data_search"].nbytes + big["data_nav"].nbytes
    log(f"{tag} synthetic_dataset_big(backend='device'): {n} x {D_SEARCH} "
        f"bfloat16 + {D_NAV} float32 navigation features, "
        f"{written / 1e9:.2f} GB written in {gen_s:.2f}s = "
        f"{written / gen_s / 1e9:.2f} GB/s; "
        + "; ".join(s for s in lines if "rows written" in s)
        + f"; while writing: {peak}; {host_memory()}")
    return big


def big_oracles(tag, big, dev, dtypes):
    """The streamed exact oracle (exact_knn_streamed) of the big corpus in
    each of `dtypes` ({label: compute dtype}), seconds, GB/s and peak host
    memory each; the corpus's pages released after them (the build copies
    the corpus into RAM, and the pages read would count beside the copy).
    Returns {label: 0-based ids}."""
    import torch
    from tpulmi_torch.baseline import exact_knn_streamed
    from tpulmi_torch.hoststore import release_pages

    corpus = big["data_search"]
    gts = {}
    for label, dtype in dtypes.items():
        torch.cuda.synchronize()
        t = time.perf_counter()
        with PeakMemory() as peak:
            _, gts[label] = exact_knn_streamed(
                big["queries_search"], corpus, k=10, chunk=STREAM_CHUNK,
                compute_dtype=dtype, device=dev)
        secs = time.perf_counter() - t
        log(f"{tag} exact_knn_streamed in {label}: "
            f"{-(-corpus.shape[0] // STREAM_CHUNK)} blocks of "
            f"{STREAM_CHUNK} rows, {N_QUERIES} queries, {secs:.2f}s = "
            f"{corpus.nbytes / secs / 1e9:.2f} GB/s host to card; {peak}; "
            f"{host_memory()}")
    release_pages(corpus)
    log(f"{tag} the corpus's pages released: {host_memory()}")
    return gts


def phase_flat10m(dev, name, errs):
    """bench_10m.py's flat configuration on the card, uncut (FLAT10M_*,
    bench_10m.py:37-52, 78-100: 10M rows of 768 and 96 features in 122
    data clusters, seed 2023, 10k queries; its IndexConfig, 122 buckets;
    the navigation rows rounded to bfloat16 and passed as a HostBF16; an
    int8 host store with the overlapped upload; int8 queries and the
    native rerank at 4 probes), in a temporary directory of its own that is
    removed at the end. Steps, each followed by the host's memory:
    `check_disk`; synthetic_dataset_big(backend="device"); the streamed
    float32 oracle; build_with_host_store (stages, the navigation rows'
    type and bytes on the card, bucket sizes, store shape and bytes, a
    digest, peak host memory); the search, whose recall@10 against the
    oracle must reach 0.90, and bench_10m.py's variants in its order
    (:136-225; each one warm call, then the best of 3, and adopted as
    bench_10m.py adopts it): the worklist (taken: equal to the dense
    search but for ties; or declined, with its items and scratch bytes),
    probe_mass 0.95 and 0.98, the float16 rerank copy, rerank_extra 6 and
    4, rerank off; `stream_equal` over 4 batches with the host mirror;
    every kernel of the path launched; `hold_on_path` on the first
    HIER20M_HOLD queries; `k3_time`, then K3 dense and on the worklist in
    turns; probe_work_model against the card's peaks; the peak card
    memory. Launches made after the path's count was
    read are not counted. Returns `rerank_card_on_path`'s numbers for the
    float16 search at the 10M cell's depth."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from tpulmi_torch import IndexConfig, LearnedIndex, SearchConfig
    from tpulmi_torch.evaluate import recall_at_k
    from tpulmi_torch.hoststore import (HostBF16, f32_to_bf16_bits,
                                        is_memory_mapped, release_pages)
    from tpulmi_torch.native import native_layout
    from tpulmi_torch.ops.probe_topk import (BLOCK_SLOTS,
                                             WL_SCRATCH_BYTES_MAX,
                                             launch_counts,
                                             probe_topk_int8q,
                                             reset_launch_counts,
                                             worklist_scratch_bytes)
    from tpulmi_torch.ops.quantize import quantize_rows
    from tpulmi_torch.utils.profiling import probe_work_model

    tag, p = "[flat10m]", FLAT10M_PROBES
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    with tempfile.TemporaryDirectory() as cache:
        check_disk(tag, cache, FLAT10M_N)
        big = big_corpus(tag, FLAT10M_N, N_CAT, cache, dev)
        corpus = big["data_search"]
        gt = big_oracles(tag, big, dev, {"float32": torch.float32})[
            "float32"]

        # ---- the navigation rows in bfloat16 (bench_10m.py:97-100) ----
        nav = big["data_nav"]
        t = time.perf_counter()
        nav_bf16 = HostBF16.zeros(nav.shape)
        for s in range(0, nav.shape[0], 1 << 21):
            rows = torch.from_numpy(np.array(nav[s:s + (1 << 21)])).to(dev)
            nav_bf16.bits[s:s + (1 << 21)] = rows.to(torch.bfloat16).view(
                torch.int16).cpu().numpy().view(np.uint16)
        if not np.array_equal(nav_bf16.bits[:1 << 16],
                              f32_to_bf16_bits(nav[:1 << 16])):
            raise AssertionError("the card's rounding to bfloat16 differs "
                                 "from the host's")
        release_pages(nav)
        log(f"{tag} navigation rows rounded to bfloat16 on the card "
            f"(nearest even, as the host rounds them): a HostBF16 of "
            f"{nav_bf16.nbytes / 1e9:.2f} GB in RAM in "
            f"{time.perf_counter() - t:.2f}s")

        # ---- the build: bench_10m.py's IndexConfig (:78-83) ----
        cfg = IndexConfig(n_categories=N_CAT, epochs=8, lr=0.003,
                          model_type="MLP-5", batch_size=4096, seed=SEED,
                          row_align=1024)
        li = LearnedIndex(cfg, device=dev)
        seen = {}
        to_card = li._nav_tensor

        def nav_tensor(x):
            out = to_card(x)
            seen["nav"] = (out.dtype, out.numel() * out.element_size())
            return out

        li._nav_tensor = nav_tensor
        reset_launch_counts()
        native_layout.reset_calls()
        torch.cuda.synchronize()
        with kept_log("tpulmi_torch.hoststore") as lines, \
                PeakMemory() as peak:
            pred, build_s = li.build_with_host_store(
                nav_bf16, corpus, normalized=True, store_dtype="int8",
                overlap_upload=True)
        del li._nav_tensor, nav_bf16
        if seen["nav"][0] != torch.bfloat16:
            raise AssertionError(f"the navigation rows reached the card as "
                                 f"{seen['nav'][0]}, not bfloat16")
        if not native_layout.calls["scatter_rows"] > 0:
            raise AssertionError("the int8 host store did not take the "
                                 "native gather")
        for line in lines:
            if "host layout" in line or "memory-mapped" in line:
                log(f"{tag} {line}")
        stages = li.last_build_stages
        st = li.built.store
        counts = st.counts.cpu().numpy()
        store_bytes = (st.data_sorted.numel() + st.scales.numel() * 4
                       + st.ids_sorted.numel() * 4)
        kept = li._host_corpus[0]
        log(f"{tag} {FLAT10M_N} rows, {st.n_categories} buckets, int8 host "
            f"store: build_with_host_store {build_s:.2f}s = nav stages "
            f"{stages['nav']:.2f}s + waiting for the corpus copy "
            f"{stages['materialize_wait']:.2f}s + layout and upload "
            f"{stages['layout_upload']:.2f}s; navigation rows on the card "
            f"{seen['nav'][0]} ({seen['nav'][1] / 1e9:.2f} GB); bucket rows "
            f"max / mean / min {counts.max()} / {counts.mean():.0f} / "
            f"{counts.min()}; store on the card "
            f"{tuple(st.data_sorted.shape)} int8 + scales + ids = "
            f"{store_bytes / 1e9:.3f} GB; the rerank's corpus "
            f"({kept.nbytes / 1e9:.2f} GB) "
            + ("left memory-mapped" if is_memory_mapped(kept)
               else "copied into RAM") + f"; {peak}")
        log(f"{tag} build digest (sha256 of centroids, router parameters, "
            f"pred): {router_digest(li, pred)}; {host_memory()}")

        # ---- bench_10m.py's searches (:104-225) ----
        qn = torch.as_tensor(big["queries_nav"], device=dev)
        qs = torch.as_tensor(big["queries_search"], device=dev)
        q_host = np.ascontiguousarray(big["queries_search"], np.float32)
        rerank_s = []
        plain_rerank = li._rerank_host

        def timed_rerank(*a, **kw):
            t = time.perf_counter()
            out = plain_rerank(*a, **kw)
            rerank_s.append(time.perf_counter() - t)
            return out

        li._rerank_host = timed_rerank

        def run_cfg(label, scfg, beside=""):
            """bench_10m.py's run_cfg: a warm call, then the best of 3."""
            li.search(qn, qs, n_buckets=p, k=10, search_config=scfg,
                      queries_search_host=q_host)
            best = None
            for _ in range(3):
                torch.cuda.synchronize()
                del rerank_s[:]
                t = time.perf_counter()
                d, ids = li.search(qn, qs, n_buckets=p, k=10,
                                   search_config=scfg,
                                   queries_search_host=q_host)
                secs = time.perf_counter() - t
                if best is None or secs < best[0]:
                    best = (secs, sum(rerank_s), d, ids)
            secs, rr, d, ids = best
            if d.shape != (N_QUERIES, 10) or not np.isfinite(d).all():
                raise AssertionError(f"bad 10M result {d.shape}")
            rec = recall_at_k(ids - 1, gt, 10)
            log(f"{tag} {label}: {secs:.4f}s = {N_QUERIES / secs:.0f} QPS"
                + (f", of which rerank {rr:.4f}s ({rr / secs:.1%})" if rr
                   else "") + f"; recall@10 {rec:.4f}{beside}")
            return secs, rec, d, ids

        before = native_layout.calls["rerank_dot"]
        base = SearchConfig(k=10, int8_queries=True)
        t_base, rec, dense_d, dense_i = run_cfg(
            f"int8 queries + native rerank at {p} of {N_CAT} probes",
            base, f" against the float32 oracle (the JAX package's 10M "
            f"run: {JAX10M_RECALL['float32']} with the float32 rerank, "
            f"{JAX10M_RECALL['float16']} with the float16 one, "
            f"BENCH_10M.md; quality targets only, on other data)")
        if not native_layout.calls["rerank_dot"] > before:
            raise AssertionError("the rerank did not take rerank_dot")
        if not rec >= RECALL_GATE:
            raise AssertionError(f"10M recall@10 {rec} under the gate")
        best, t_best, mass_used = base, t_base, None

        # the worklist, taken or declined by the port's scratch rule
        cfgw = dataclasses.replace(base, pallas_worklist=True)
        tw, rw, dw, iw = run_cfg("the worklist", cfgw)
        wl = li._wl_pads.get((N_QUERIES, p), 0)
        _, lay = on_path(li, (qn, qs), p, dev)
        items = worklist_total(lay, st.counts, base.pallas_mc)
        pad = max(-(-int(items * 1.15) // 1024) * 1024, 1024)
        scratch = worklist_scratch_bytes(
            max(wl, pad), 20, int(lay.blocks.shape[0]), False)
        about = (f"{items} items of {base.pallas_mc} rows at {N_QUERIES} "
                 f"queries x {p} probes, {scratch / 1e9:.3f} GB of scratch "
                 f"(limit {WL_SCRATCH_BYTES_MAX / 1e9:.3f})")
        if wl > 0:
            rows = equal_but_ties(iw, dw, dense_i, dense_d, q_host, kept,
                                  1e-6)
            log(f"{tag} the worklist taken: a list of {wl} for {about}; "
                f"equal to the dense search but for ties ({rows} rows "
                f"differ); {tw:.4f}s against {t_base:.4f}s")
        else:
            log(f"{tag} the worklist declined, one CTA per block kept: "
                f"{about}")
        use_wl = wl > 0 and rw >= RECALL_GATE and tw < t_best
        if use_wl:
            best, t_best = cfgw, tw
        for mass in (0.95, 0.98):
            cfgm = dataclasses.replace(base, probe_mass=mass,
                                       pallas_worklist=use_wl)
            tm, rm, _, _ = run_cfg(f"probe_mass={mass}", cfgm)
            if rm >= RECALL_GATE and tm < t_best:
                best, t_best, mass_used = cfgm, tm, mass
                break
        cfg16 = dataclasses.replace(base, rerank_dtype="float16",
                                    probe_mass=mass_used,
                                    pallas_worklist=use_wl)
        t = time.perf_counter()
        t16, r16, _, _ = run_cfg("rerank_dtype='float16'", cfg16)
        log(f"{tag} the float16 rerank copy: "
            f"{float16_copy_of(li).nbytes / 1e9:.2f} GB, made and searched "
            f"4 times in {time.perf_counter() - t:.2f}s; {host_memory()}")
        # the rerank kernel at the 10M cell's depth (rerank_extra 4)
        cell16 = dataclasses.replace(cfg16, rerank_extra=4)
        card_rerank = rerank_card_on_path(tag, li, lambda: li.search(
            qn, qs, n_buckets=p, k=10, search_config=cell16,
            queries_search_host=q_host), name)
        if r16 >= RECALL_GATE and t16 < t_best:
            best, t_best = cfg16, t16
        else:
            li._rerank_shadow = li._card_copy = None
            gc.collect()
        for extra in (6, 4):
            cfge = dataclasses.replace(best, rerank_extra=extra)
            te, re_, _, _ = run_cfg(f"rerank_extra={extra}", cfge)
            if re_ >= RECALL_GATE and te < t_best:
                best, t_best = cfge, te
        t_dev, _, _, _ = run_cfg("rerank off", dataclasses.replace(
            base, rerank=False, pallas_worklist=use_wl))
        log(f"{tag} adopted as bench_10m.py adopts: worklist {use_wl}, "
            f"probe_mass {best.probe_mass}, rerank_dtype "
            f"{best.rerank_dtype!r}, rerank_extra {best.rerank_extra}: "
            f"{t_best:.4f}s = {N_QUERIES / t_best:.0f} QPS; the host rerank "
            f"~{max(t_best - t_dev, 0):.4f}s of it (rerank off "
            f"{t_dev:.4f}s)")
        del li._rerank_host

        # ---- 4 stream batches with the host mirror (:227-250) ----
        batches = [(torch.roll(qn, -2500 * i, 0), torch.roll(qs, -2500 * i, 0),
                    np.roll(q_host, -2500 * i, 0)) for i in range(4)]
        stream_equal(tag, li, batches, dict(n_buckets=p, k=10,
                                            search_config=best))
        launches = launch_counts()
        path = ["probe_topk_int8q_int8"]
        if wl > 0:
            path += ["probe_worklist", "merge_items"]
        for kname in path:
            if not launches[kname] > 0:
                raise AssertionError(f"phase flat10m launched no {kname}")
        log(f"{tag} launches {({n: c for n, c in launches.items() if c})}")

        # ---- the kernels on the path's inputs ----
        queries = (big["queries_nav"], big["queries_search"])
        hold_on_path(tag, li, tuple(x[:HIER20M_HOLD] for x in queries), p,
                     dev, errs, kernels=("int8q", "worklist") if wl > 0
                     else ("int8q",))
        k3_ms = k3_time(tag, li, queries, p, dev, name)
        qf, lay = on_path(li, queries, p, dev)
        args = (*quantize_rows(qf), lay.qidx, st.data_sorted, st.scales,
                lay.blocks, 20, 8)
        listed = dict(wl_pad=max(wl, pad), item_rows=base.pallas_mc)
        turns = [cuda_ms(lambda o=o: probe_topk_int8q(*args, **o), 10)
                 for o in ({}, listed, listed, {})]
        log(f"{tag} K3 on the path by CUDA events, in turns: one CTA per "
            f"block {(turns[0] + turns[3]) / 2:.4f} ms, the worklist with "
            f"its merge {(turns[1] + turns[2]) / 2:.4f} ms (turns "
            f"{', '.join(f'{t:.4f}' for t in turns)})")

        # ---- the probe's work model (bench_10m.py:256-275) ----
        peak_flops, peak_bw = peaks(name)
        flops, nbytes = probe_work_model(
            lay.slot_counts.cpu().numpy(), counts, D_SEARCH, BLOCK_SLOTS,
            64, 1)
        share = [f"{flops / t / (peak_flops * INT8_OVER_BF16):.3f} of the "
                 f"int8 peak and {nbytes / t / peak_bw:.3f} of the memory "
                 f"rate" for t in (k3_ms / 1e3, t_best)]
        log(f"{tag} probe_work_model at the port's tiling (blocks of "
            f"{BLOCK_SLOTS} slots, tiles of 64 rows): {flops / 1e12:.3f} "
            f"TOP, {nbytes / 1e9:.3f} GB; over K3's {k3_ms:.4f} ms "
            f"{share[0]}, over the search's {t_best:.4f}s {share[1]} "
            f"({name})")
        del li, big, corpus, kept, qn, qs, qf, batches, lay, args
        gc.collect()
        torch.cuda.empty_cache()
    log(f"{tag} {host_memory()}")
    log(f"{tag} phase {time.perf_counter() - t_phase:.1f}s; peak card "
        f"memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, of "
        f"which earlier phases held {held / 1e9:.2f} GB; {name}")
    return card_rerank


def phase_hier20m(dev, name, errs):
    """The hierarchical index at the JAX package's own 20M configuration
    (bench_20m.py:67-75, 188-206: HIER20M_N rows, cut from 20M, of 768 and
    96 features in 244 data clusters, seed 2023, 10k queries; `hier_config`'s
    8 x 61 buckets; int8 store and queries, rerank depth 10), in a
    temporary directory of its own that is removed at the end. Steps: the
    host's RAM, disk and cores; synthetic_dataset_big(backend="device"),
    its seconds by stage and GB written a second; the streamed exact
    oracle (exact_knn_streamed) in float32 and in bfloat16, seconds and
    GB/s each; `hier_build`; calibrate_outer_weight at 24 probes beside the
    JAX package's containment; `hier_sweep` against both oracles until the
    float32 one's recall@10 reaches 0.90 (the phase fails if none does);
    `hier_variants` at that budget; every kernel of the path launched;
    `hold_on_path` on the first HIER20M_HOLD queries (the plain worklist
    walks its items one by one); K3's time, bound and library time; the
    peak card memory; then `rerank_card_on_path` on a float16 search at
    that budget, whose numbers it returns. Launches made after the path's
    count was read are not counted."""
    import gc
    import torch
    from tpulmi_torch.ops.probe_topk import (launch_counts,
                                             reset_launch_counts)

    tag = "[hier20m]"
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    with tempfile.TemporaryDirectory() as cache:
        log(f"{tag} host: {host_resources(cache)}; {host_cpu_line()}; "
            f"{host_memory()}")

        big = big_corpus(tag, HIER20M_N, 244, cache, dev)
        corpus, qs = big["data_search"], big["queries_search"]
        gts = big_oracles(tag, big, dev, {"float32": torch.float32,
                                          "bf16-input": torch.bfloat16})

        # ---- the build, the calibration, the sweep ----
        reset_launch_counts()
        hi, _ = hier_build(tag, big, dev)
        n_buckets = hi.built.store.n_categories
        log(f"{tag} after the build: {host_memory()}")
        hier_calibrate(tag, hi, big["data_nav"],
                       " (the JAX package's 20M run: 0.9019 at w=1, "
                       "0.9805 at w 0.25, BENCH_20M.md round 3; 0.8467 and "
                       "0.9819 in round 4)")
        queries = (big["queries_nav"], qs)
        search = hier_searcher(hi, queries)
        p, dense = hier_sweep(tag, search, gts, n_buckets,
                              " (the JAX package's 20M run against its "
                              "bf16-input oracle: 8 at 0.9105 in round 3, "
                              "12 at 0.9302 in round 4, BENCH_20M.md)")
        hier_variants(tag, search, p, dense, queries, corpus, gts["float32"])
        launches = launch_counts()
        for kname in ("probe_topk_quant_int8", "probe_topk_int8q_int8",
                      "probe_worklist", "merge_items", "probe_pool",
                      "probe_pair"):
            if not launches[kname] > 0:
                raise AssertionError(f"phase hier20m launched no {kname}")
        log(f"{tag} launches {({n: c for n, c in launches.items() if c})}")

        # ---- the kernels on the path's inputs ----
        hold_on_path(tag, hi, tuple(x[:HIER20M_HOLD] for x in queries), p,
                     dev, errs)
        k3_time(tag, hi, queries, p, dev, name)
        card_rerank = rerank_card_on_path(
            tag, hi, lambda: search(p, rerank_dtype="float16"), name)
        del hi, search, dense, big, corpus
        gc.collect()
        torch.cuda.empty_cache()
    log(f"{tag} {host_memory()}")
    log(f"{tag} phase {time.perf_counter() - t_phase:.1f}s; peak card "
        f"memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, of "
        f"which earlier phases held {held / 1e9:.2f} GB; {name}")
    return card_rerank


def phase_hier40m(dev, name, errs):
    """bench_40m.py's configuration on the card (HIER40M_*: 16 x 61 = 976
    buckets, 488 data clusters, a packed int4 host store, int8 queries, items
    of 1024 rows, the rerank depth 30 rising to 60 and 100), at HIER40M_N rows,
    in a temporary directory of its own that is removed at the end. Steps, each
    followed by the host's memory: `check_disk`;
    synthetic_dataset_big(backend="device"), its seconds, GB/s and peak memory;
    the streamed exact oracle in float32; `hier_build` with an int4 store (the
    corpus stays memory-mapped through the layout; the layout's rows a second,
    the build's peak memory); calibrate_outer_weight at 24 probes; the sweep at
    16 / 20 / 24 probes at depth 30 and, if none reaches recall@10 0.90, depth
    60 then 100 at 24 probes and back down to the lowest budget that still
    reaches it (the phase fails if nothing does), each beside the JAX package's
    round 4; at the found (budget, depth) `hier_variants` (the pool's recall
    printed, not held), what the port does with the worklist at this shape,
    `hier_float16_shadow` and `hier_stream`; every kernel of the path launched;
    `hold_on_path` on the first HIER20M_HOLD queries with int4 codes; K3's
    time, bound and library time; the peak card memory. Launches made after the
    path's count was read are not counted."""
    import gc

    import torch
    from tpulmi_torch.hoststore import is_memory_mapped
    from tpulmi_torch.ops.probe_topk import (launch_counts,
                                             reset_launch_counts)

    tag = "[hier40m]"
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    with tempfile.TemporaryDirectory() as cache:
        check_disk(tag, cache, HIER40M_N)
        big = big_corpus(tag, HIER40M_N, HIER40M_CLUSTERS, cache, dev)
        qs = big["queries_search"]
        gt = big_oracles(tag, big, dev, {"float32": torch.float32})[
            "float32"]

        # ---- the build, the calibration ----
        scale = HIER40M_N / HIER40M_FULL_N
        fracs = {k: f"{v * scale:g}" for k, v in HIER40M_FRACS.items()}
        log(f"{tag} the build runs with " + ", ".join(
            f"{k}={v}" for k, v in fracs.items()) + f" ({HIER40M_N} of "
            f"{HIER40M_FULL_N} rows times the defaults "
            + " and ".join(f"{v:g}" for v in HIER40M_FRACS.values())
            + "): the corpus meets the RAM rules as the uncut one would")
        reset_launch_counts()
        with PeakMemory() as peak, environ(fracs):
            hi, _ = hier_build(tag, big, dev, store_dtype="int4",
                               n_groups=HIER40M_GROUPS)
        n_buckets = hi.built.store.n_categories
        log(f"{tag} the build: {peak}; after it: {host_memory()}")
        hier_calibrate(tag, hi, big["data_nav"],
                       " (the JAX package's 40M run: containment@24 0.9707 "
                       "at w 0.25, 0.8208 at w=1, BENCH_40M.md)")

        # ---- the sweep and the rerank-depth ladder ----
        queries = (big["queries_nav"], qs)
        oracles = {"float32": gt}
        rerank_corpus = hi._host_corpus[0]
        search = hier_searcher(hi, queries)
        depth = HIER40M_DEPTHS[0]
        found = hier_sweep(tag, search, oracles, n_buckets,
                           budgets=HIER40M_BUDGETS, required=False,
                           ref=JAX40M_RECALL[depth], rerank_extra=depth)
        for deeper in HIER40M_DEPTHS[1:]:
            if found is not None:
                break
            depth = deeper
            found = hier_sweep(tag, search, oracles, n_buckets,
                               budgets=HIER40M_BUDGETS[-1:], required=False,
                               ref=JAX40M_RECALL.get(depth),
                               rerank_extra=depth)
            # a deeper rerank may reach the gate at a lower budget
            for lower in reversed(HIER40M_BUDGETS[:-1]):
                if found is None:
                    break
                got = hier_sweep(tag, search, oracles, n_buckets,
                                 budgets=(lower,), required=False,
                                 ref=JAX40M_RECALL.get(depth),
                                 rerank_extra=depth)
                if got is None:
                    break
                found = got
        if found is None:
            raise AssertionError(
                f"no probe budget of {HIER40M_BUDGETS} at a rerank depth of "
                f"{HIER40M_DEPTHS} reached recall@10 {RECALL_GATE}")
        p, dense = found
        log(f"{tag} the lowest budget reaching recall@10 {RECALL_GATE}: {p} "
            f"of {n_buckets} probes at rerank depth {depth} (the JAX "
            f"package's round 4: 16 probes at depth 60, 0.9040)")

        # ---- the variants at the found (budget, depth) ----
        search = hier_searcher(hi, queries, depth)
        hier_variants(tag, search, p, dense, queries, rerank_corpus, gt,
                      hold_pool=False,
                      pool_beside=" (the JAX package's round 4: 0.8773 at "
                      "16 probes, depth 60, rejected by its gate)")
        wl = hi._wl_pads.get((N_QUERIES, p), 0)
        log(f"{tag} the worklist at {N_QUERIES} queries x {p} probes: "
            + (f"a list of {wl} items" if wl > 0 else
               "declined, one CTA per block kept (its scratch would pass "
               "the limit; the JAX package declined its worklist at "
               "61,440 items, BENCH_40M.md)"))
        hier_float16_shadow(tag, hi, search, p, dense, gt)
        hier_stream(tag, hi, queries, p, depth)
        launches = launch_counts()
        path = ["probe_topk_quant_int4", "probe_topk_int8q_int4",
                "probe_pool", "probe_pair"]
        if wl > 0:
            path += ["probe_worklist", "merge_items"]
        for kname in path:
            if not launches[kname] > 0:
                raise AssertionError(f"phase hier40m launched no {kname}")
        log(f"{tag} launches {({n: c for n, c in launches.items() if c})}")

        # ---- the kernels on the path's inputs ----
        hold_on_path(tag, hi, tuple(x[:HIER20M_HOLD] for x in queries), p,
                     dev, errs, bits=4, depth=depth)
        k3_time(tag, hi, queries, p, dev, name, bits=4, depth=depth)
        log(f"{tag} the rerank's corpus "
            + ("left memory-mapped" if is_memory_mapped(rerank_corpus)
               else "copied into RAM") + f"; {host_memory()}")
        del hi, search, dense, big, rerank_corpus
        gc.collect()
        torch.cuda.empty_cache()
    log(f"{tag} {host_memory()}")
    log(f"{tag} phase {time.perf_counter() - t_phase:.1f}s; peak card "
        f"memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, of "
        f"which earlier phases held {held / 1e9:.2f} GB; {name}")


def hold_shards(sstore, probes, qf, *, k, compute_dtype, int8_queries,
                pair, tol):
    """Each of a sharded store's shards: its probe kernel's launch against
    the kernel's plain version (`compare`) on the shard's own inputs, the
    global `probes` remapped to its buckets, its slot layout and its store,
    as the sharded program gives them (`qf` the normalized queries).
    Returns the largest distance error; raises on a disagreement."""
    from tpulmi_torch.ops.probe_topk import (group_slots, probe_topk,
                                             probe_topk_int8q,
                                             probe_topk_int8q_plain,
                                             probe_topk_plain,
                                             probe_topk_quant,
                                             probe_topk_quant_plain)
    from tpulmi_torch.ops.quantize import quantize_rows
    from tpulmi_torch.parallel.sharded import local_probes

    worst = 0.0
    for s, st in sstore.local():
        lay = group_slots(local_probes(probes, sstore.bucket_start[s],
                                       sstore.cat_pad), st.offsets, st.counts)
        if not st.is_quantized:
            q, data = qf.to(compute_dtype).contiguous(), st.data_as(
                compute_dtype)
            args = (q, lay.qidx, data, lay.blocks, k)
            kern, plain, own = probe_topk, probe_topk_plain, own_full(q, data)
        elif int8_queries:
            q_codes, q_scales = quantize_rows(qf)
            args = (q_codes, q_scales, lay.qidx, st.data_sorted, st.scales,
                    lay.blocks, k, st.quant_bits)
            kern, plain = probe_topk_int8q, probe_topk_int8q_plain
            own = own_quant(q_codes, st.data_sorted, st.scales,
                            st.quant_bits, q_scales)
        else:
            q = qf.to(compute_dtype).contiguous()
            args = (q, lay.qidx, st.data_sorted, st.scales, lay.blocks, k,
                    st.quant_bits)
            kern, plain = probe_topk_quant, probe_topk_quant_plain
            own = own_quant(q, st.data_sorted, st.scales, st.quant_bits)
        worst = max(worst, compare(kern(*args, pair=pair), plain(*args), own,
                                   lay, probes.numel(), tol))
    return worst


def median_s(fn, reps=5):
    """(median host seconds of reps calls after one warm-up, last result)."""
    import statistics

    import torch

    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t)
    return statistics.median(times), out


def phase_shard(index, stores, ds, dev, gt, big, gt_big, hier, cache, errs):
    """The bucket-sharded store and search, the data-parallel build and the
    process-group runtime (tpulmi_torch.parallel), S shards on one card (a
    mesh that lists cuda:0 S times). 1. phase_main's index cut into 4
    shards (31 buckets each): 10k queries at 2 probes through K1, K2 (int8
    store, float queries, host rerank), K3 (int8 queries) and K6, each
    equal to the unsharded search but for ties, the host times of both
    (median of 5) and the bytes; then each shard's kernel launch against
    its plain version on that shard's own remapped probes and store. 2.
    build_distributed of the main data over 4 "data" entries: seconds,
    final loss, recall@10 at 1, 2, 4 probes beside the flat build's, a
    digest, the sharded search equal to the one after unshard, each
    shard's K1 launch against its plain version. 3. phase hier's
    configuration through build_with_host_store(mesh=8 x cuda:0), one group
    a shard: pred equal to phase hier's, the shards holding exactly its
    flat store's rows, the search at its budget equal to its unsharded
    search but for ties, each shard's K3 launch against its plain version,
    recall, time, rerank share, bytes, and a save / load to one flat
    store. 4. the process groups: one NCCL rank
    and two gloo ranks sharing the card (child processes of this script),
    each checked by its exit code and OK line. The kernel launches of the
    sharded searches are counted from 0 just before them and read just
    after; each of K1, K2, K3, K6 must have launched."""
    import os

    import numpy as np
    import torch
    from tpulmi_torch import HierarchicalIndex, LearnedIndex, SearchConfig
    from tpulmi_torch.build import build_digest
    from tpulmi_torch.evaluate import recall_at_k
    from tpulmi_torch.hoststore import HostBF16
    from tpulmi_torch.ops.distance import l2_normalize
    from tpulmi_torch.ops.probe_topk import (launch_counts,
                                             reset_launch_counts)
    from tpulmi_torch.parallel import make_mesh
    from tpulmi_torch.search import route_probes, routing_logits

    host = (ds["queries_nav"], ds["queries_search"])
    corpus = ds["data_search"]
    full = index.built.store
    mesh = make_mesh(devices=[dev] * SHARDS)
    path = {}

    def count(fn):
        """fn() with the launch counts set to 0 before it and added to the
        path's after it."""
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        for name, c in launch_counts().items():
            path[name] = path.get(name, 0) + c
        return out

    def store_bytes(st):
        return sum(t.numel() * t.element_size() for t in (
            st.data_sorted, st.ids_sorted, st.offsets, st.counts, st.scales)
            if t is not None)

    # ---- 1. the 300K index in 4 shards, K1 / K2 / K3 / K6 ----
    t_phase = time.perf_counter()
    variants = {"K1": (None, {}, "probe_topk", DIST_TOL),
                "K2": (8, {}, "probe_topk_quant_int8", DIST_TOL),
                "K3": (8, dict(int8_queries=True), "probe_topk_int8q_int8",
                       INT8Q_TOL),
                "K6": (None, dict(pallas_pair=True), "probe_pair", DIST_TOL)}
    qn_dev, qs_dev = (torch.as_tensor(x, device=dev) for x in host)
    with torch.no_grad():
        probes = route_probes(routing_logits(
            index.built.classifier.model, qn_dev, need_mass=False)[0], 2)
    qf = l2_normalize(qs_dev.float())
    for label, (bits, opts, kname, tol) in variants.items():
        index.unshard()
        index.built.store = full if bits is None else stores[bits]
        index._search_programs = {}
        index._host_corpus = None if bits is None else (corpus, True)
        scfg = SearchConfig(k=10, n_buckets=2, **opts)

        def search():
            return index.search(*host, n_buckets=2, k=10,
                                search_config=scfg)

        flat_s, (fd, fi) = median_s(search)
        index.shard(mesh)
        shard_s, (sd, si) = count(lambda: median_s(search))
        if sd.shape != (N_QUERIES, 10) or not np.isfinite(sd).all():
            raise AssertionError(f"bad sharded result {sd.shape}")
        rows = equal_but_ties(si, sd, fi, fd, host[1], corpus,
                              DIST_TOL if bits is None else 1e-6,
                              bf16=bits is None)
        sstore = index._sharded[0]
        log(f"[shard] {label} ({kname}), 4 shards of {sstore.cat_pad} "
            f"buckets on one card, 2 probes: equal to the unsharded search "
            f"but for ties ({rows} rows differ); search {shard_s * 1e3:.2f} "
            f"ms sharded, {flat_s * 1e3:.2f} ms flat (host clock, median of "
            f"5); shards {sstore.nbytes() / 1e9:.4f} GB, flat store "
            f"{store_bytes(index.built.store) / 1e9:.4f} GB")
        plan = index._plan_search(qn_dev, 2, 10, scfg)
        worst = hold_shards(sstore, probes, qf, k=plan.k_eff,
                            compute_dtype=plan.compute_dtype,
                            int8_queries=plan.int8_queries, pair=plan.pair,
                            tol=tol)
        errs[kname] = max(errs.get(kname, 0.0), worst)
        log(f"[shard] {kname} on each of the {SHARDS} shards (k "
            f"{plan.k_eff}, the shard's remapped probes and store): equal "
            f"to its plain version but for ties, max |err| {worst:.3g}")
    index.unshard()
    index.built.store = full
    index._search_programs = {}
    index._host_corpus = None

    # ---- 2. the data-parallel build over 4 "data" entries ----
    dli = LearnedIndex(index.config, device=dev)
    torch.cuda.synchronize()
    pred, build_s = dli.build_distributed(
        ds["data_nav"], ds["data_search"],
        mesh=make_mesh(axis_names=("data",), devices=[dev] * SHARDS))
    st = dli.built.store
    line = []
    for p in (1, 2, 4):
        got = count(lambda: dli.search(*host, n_buckets=p, k=10))
        flat = index.search(*host, n_buckets=p, k=10)[1]
        line.append(f"{p}: {recall_at_k(got[1] - 1, gt, 10):.4f} (flat "
                    f"build {recall_at_k(flat - 1, gt, 10):.4f})")
    stages = dli.last_build_stages
    log(f"[shard] build_distributed, {N} rows over {SHARDS} data entries: "
        f"{build_s:.2f}s (navigation {stages['nav']:.2f}s), final loss "
        f"{stages['final_loss']:.4f}; recall@10 at probes "
        + ", ".join(line))
    log(f"[shard] build_distributed digest (sha256 of centroids, router "
        f"parameters, store rows, ids and offsets): " + build_digest(
            dli.built.centroids, dli.built.classifier.model, st.data_sorted,
            st.ids_sorted, st.offsets))
    sd, si = dli.search(*host, n_buckets=2, k=10)
    plan = dli._plan_search(qn_dev, 2, 10, SearchConfig(k=10, n_buckets=2))
    with torch.no_grad():
        probes = route_probes(routing_logits(
            dli.built.classifier.model, qn_dev, need_mass=False)[0], 2)
    worst = hold_shards(dli._sharded[0], probes, qf, k=plan.k_eff,
                        compute_dtype=plan.compute_dtype,
                        int8_queries=plan.int8_queries, pair=plan.pair,
                        tol=DIST_TOL)
    errs["probe_topk"] = max(errs.get("probe_topk", 0.0), worst)
    log(f"[shard] build_distributed: probe_topk on each of its {SHARDS} "
        f"shards (k {plan.k_eff}, 2 probes, the shard's remapped probes and "
        f"store): equal to its plain version but for ties, max |err| "
        f"{worst:.3g}")
    dli.unshard()
    fd, fi = dli.search(*host, n_buckets=2, k=10)
    rows = equal_but_ties(si, sd, fi, fd, host[1], corpus, DIST_TOL,
                          bf16=True)
    log(f"[shard] build_distributed: sharded search equal to the search "
        f"after unshard but for ties ({rows} rows differ)")
    del dli, st

    # ---- 3. the 2M hierarchical index, one group a shard ----
    qn, qs = big["queries_nav"], big["queries_search"]
    corpus_big = big["data_search"]
    n_groups = hier["cfg"].n_groups
    hm = HierarchicalIndex(hier["cfg"], device=dev)
    nav_bf16 = HostBF16.from_float32(big["data_nav"])
    torch.cuda.synchronize()
    pred, build_s = hm.build_with_host_store(
        nav_bf16, corpus_big, normalized=True, store_dtype="int8",
        overlap_upload=True, mesh=make_mesh(devices=[dev] * n_groups))
    del nav_bf16
    stages = hm.last_build_stages
    if not np.array_equal(pred, hier["pred"]):
        raise AssertionError("the mesh build's pred differs from phase "
                             "hier's")
    sstore, flat = hm._sharded[0], hier["store"]
    offsets = flat.offsets.cpu().numpy()
    for s, sh in sstore.local():
        lo = int(sstore.bucket_start[s])
        hi_ = min(lo + sstore.cat_pad, flat.n_categories)
        r0, r1 = int(offsets[lo]), int(offsets[hi_])
        n_rows = r1 - r0
        same = (torch.equal(sh.data_sorted[:n_rows], flat.data_sorted[r0:r1])
                and torch.equal(sh.ids_sorted[:n_rows],
                                flat.ids_sorted[r0:r1])
                and torch.equal(sh.scales[:n_rows], flat.scales[r0:r1])
                and not sh.data_sorted[n_rows:].any()
                and bool((sh.ids_sorted[n_rows:] == -1).all()))
        if not same:
            raise AssertionError(f"shard {s} does not hold phase hier's "
                                 f"rows {r0}:{r1}")
    hm.set_outer_weight(hier["outer_weight"])
    hm.set_mass_temp(hier["mass_temp"])
    p = hier["p"]
    seen = {}
    plain_rerank = hm._rerank_host

    def timed_rerank(*a, **kw):
        t = time.perf_counter()
        out = plain_rerank(*a, **kw)
        seen["s"] = time.perf_counter() - t
        return out

    hm._rerank_host = timed_rerank
    kw = dict(n_buckets=p, k=10, search_config=SearchConfig(
        k=10, n_buckets=p, int8_queries=True, rerank_extra=10,
        pallas_mc=1024))
    secs, (d, ids) = count(lambda: median_s(lambda: hm.search(qn, qs, **kw),
                                            reps=3))
    del hm._rerank_host
    rows = equal_but_ties(ids, d, hier["dense"][1], hier["dense"][0], qs,
                          corpus_big, 1e-6)
    log(f"[shard] hierarchical {n_groups} x {sstore.cat_pad}, "
        f"build_with_host_store(mesh={n_groups} x cuda:0) {build_s:.2f}s = "
        f"nav {stages['nav']:.2f}s + corpus wait "
        f"{stages['materialize_wait']:.2f}s + layout and upload "
        f"{stages['layout_upload']:.2f}s; pred equal to phase hier's; every "
        f"shard holds exactly its rows of phase hier's flat store")
    log(f"[shard] hierarchical sharded search at {p} probes: recall@10 "
        f"{recall_at_k(ids - 1, gt_big, 10):.4f}; equal to phase hier's "
        f"unsharded search but for ties ({rows} rows differ); "
        f"{secs:.4f}s (median of 3), rerank {seen['s']:.4f}s "
        f"({seen['s'] / secs:.1%}); shards {sstore.nbytes() / 1e9:.3f} GB "
        f"on the card, flat store {store_bytes(flat) / 1e9:.3f} GB; the "
        f"index's flat layout on the host: "
        f"{hm.built.store.data_sorted.device}")
    qn_big = torch.as_tensor(qn, device=dev)
    plan = hm._plan_search(qn_big, p, 10, kw["search_config"])
    with torch.no_grad():
        probes = route_probes(routing_logits(
            hm.built.classifier.model, qn_big, need_mass=False)[0], p)
    worst = hold_shards(
        sstore, probes, l2_normalize(torch.as_tensor(qs, device=dev).float()),
        k=plan.k_eff, compute_dtype=plan.compute_dtype,
        int8_queries=plan.int8_queries, pair=plan.pair, tol=INT8Q_TOL)
    errs["probe_topk_int8q_int8"] = max(
        errs.get("probe_topk_int8q_int8", 0.0), worst)
    log(f"[shard] hierarchical: probe_topk_int8q_int8 on each of the "
        f"{n_groups} shards (k {plan.k_eff}, {p} probes, the shard's "
        f"remapped probes and store): equal to its plain version but for "
        f"ties, max |err| {worst:.3g}")
    del qn_big, probes
    ckpt = os.path.join(cache, "hier_mesh_ckpt")
    t = time.perf_counter()
    hm.save(ckpt)
    save_s = time.perf_counter() - t
    t = time.perf_counter()
    back = HierarchicalIndex.load(ckpt, device=dev)
    load_s = time.perf_counter() - t
    back.attach_host_corpus(hm._host_corpus[0])
    bd, bi = back.search(qn, qs, **kw)
    rows = equal_but_ties(bi, bd, ids, d, qs, corpus_big, 1e-6)
    log(f"[shard] the mesh-built index saved in {save_s:.2f}s and loaded "
        f"flat on one card in {load_s:.2f}s: search equal but for ties "
        f"({rows} rows differ)")
    del hm, back, sstore, flat

    # ---- every kernel of the sharded path launched ----
    for kname in ("probe_topk", "probe_topk_quant_int8",
                  "probe_topk_int8q_int8", "probe_pair"):
        if not path.get(kname, 0) > 0:
            raise AssertionError(f"the sharded searches launched no {kname}")
    log(f"[shard] launches of the sharded searches "
        f"{({n: c for n, c in path.items() if c})}; phase "
        f"{time.perf_counter() - t_phase:.1f}s before the process groups")

    # ---- 4. the process groups, in child processes ----
    run_children()
    return path


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_children():
    """One NCCL rank, and two gloo ranks that share the card, as child
    processes of this script (`child`), all at once. Each must exit 0 and
    print its OK line; the gloo ranks' losses and parameter hashes must be
    equal."""
    t = time.perf_counter()
    gloo_port, nccl_port = _free_port(), _free_port()
    jobs = [("nccl", 0, 1, nccl_port), ("gloo", 0, 2, gloo_port),
            ("gloo", 1, 2, gloo_port)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--child", backend, str(rank), str(world),
         str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for backend, rank, world, port in jobs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    oks = []
    for (backend, rank, world, _), p, out in zip(jobs, procs, outs):
        ok = [line for line in out.splitlines() if line.startswith("OK ")]
        if p.returncode != 0 or len(ok) != 1:
            raise AssertionError(f"the {backend} rank {rank} of {world} "
                                 f"failed (exit {p.returncode}):\n"
                                 f"{out[-3000:]}")
        oks.append(dict(kv.split("=", 1) for kv in ok[0].split()[1:]))
        log(f"[shard] child {ok[0]}")
    for key in ("loss", "params"):
        if oks[1][key] != oks[2][key]:
            raise AssertionError(f"the gloo ranks are not in lockstep: "
                                 f"{key} {oks[1][key]} != {oks[2][key]}")
    log(f"[shard] process groups: one NCCL rank, two gloo ranks sharing "
        f"the card in lockstep (loss and parameter hash equal); "
        f"{time.perf_counter() - t:.1f}s")


def child(args) -> int:
    """A process-group rank on cuda:0: ``--child BACKEND RANK WORLD
    PORT``. A data-parallel train step over a mesh of 2 entries a rank (3
    steps; with nccl also run before the group is joined, and the params
    must be equal to the bit), then the sharded search over a store that
    each rank lands only its own shards of, from the host layout, on the
    xla scan and the kernels, equal to the exact expectation on the host.
    Prints ``OK backend= rank= loss= params=``."""
    import hashlib

    import numpy as np
    import torch
    from tpulmi_torch.hoststore import layout_host_store
    from tpulmi_torch.models.mlp import make_model
    from tpulmi_torch.parallel import (init_distributed, make_dp_train_step,
                                       make_mesh, shard_store_from_host,
                                       sharded_probe_search)

    backend, rank, world, port = args[0], int(args[1]), int(args[2]), args[3]
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)

    def train():
        mesh = make_mesh(axis_names=("data",), devices=[dev, dev])
        step = make_dp_train_step(make_model(
            "MLP-5", 8, 6, generator=torch.Generator().manual_seed(0)), 1e-2,
            mesh)
        rng = np.random.default_rng(0)
        for _ in range(3):
            xb = rng.normal(size=(4 * mesh.size, 8)).astype(np.float32)
            loss = float(step(xb, rng.integers(0, 6, size=4 * mesh.size)))
        h = hashlib.sha256()
        for v in step.model.state_dict().values():
            h.update(v.cpu().numpy().tobytes())
        return loss, h.hexdigest()[:16]

    alone = train() if backend == "nccl" else None
    if init_distributed(backend, f"tcp://localhost:{port}", world,
                        rank) != rank:
        raise AssertionError("init_distributed returned another rank")
    loss, params = train()
    if alone is not None and alone != (loss, params):
        raise AssertionError(f"one NCCL rank changed the step: {alone} != "
                             f"{(loss, params)}")

    rng = np.random.default_rng(1)
    n, d, q, k = 20_000, 64, 256, 10
    mesh = make_mesh(devices=[dev, dev])
    n_cat = 4 * mesh.size
    data = rng.normal(size=(n, d)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    labels = rng.integers(0, n_cat, size=n).astype(np.int32)
    arrays = layout_host_store(labels, data, n_cat, row_align=128,
                               store_dtype="float32", normalized=True)
    sstore = shard_store_from_host(arrays, mesh, slab_rows=4096)
    if [s for s, _ in sstore.local()] != mesh.local_entries() or sum(
            st is None for st in sstore.shards) != 2 * (world - 1):
        raise AssertionError("a rank landed shards it does not own")
    queries = rng.normal(size=(q, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    probes = np.stack([rng.permutation(n_cat)[:3] for _ in range(q)]
                      ).astype(np.int32)
    want = np.empty((q, k), np.float32)
    for i in range(q):
        want[i] = np.sort(1.0 - data[np.isin(labels, probes[i])]
                          @ queries[i])[:k]
    for be in ("xla", "cuda"):
        dists, _ = sharded_probe_search(probes, queries, sstore, mesh, k=k,
                                        backend=be)
        gap = float(np.abs(dists.cpu().numpy() - want).max())
        if not gap <= 1e-5:
            raise AssertionError(f"{be}: {gap} from the host expectation")
    torch.distributed.destroy_process_group()
    print(f"OK backend={backend} rank={rank} world={world} loss={loss.hex()}"
          f" params={params}", flush=True)
    return 0


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


def phase_baseline(ds, dev, gt, big, gt_big):
    """The exact oracle streamed from host memory (the JAX package's
    ground-truth pass of its 10M-40M runs) over the hoststore phase's 2M x
    768 bfloat16 corpus and 10k queries, in blocks of STREAM_CHUNK rows:
    in bfloat16 (ids equal to a bf16-input oracle's but for ties) and in
    float32 (equal to the float32 oracle's but for ties); a resumable pass
    with a checkpoint every 2 blocks, interrupted after its 5th block,
    resumed at row 4 x STREAM_CHUNK and equal to the uninterrupted bfloat16
    pass to the bit; `Baseline` on the main data against its oracle; one
    block's float32 product (and under TF32), top-k and merge, timed."""
    import logging
    import os

    import numpy as np
    import torch
    from tpulmi_torch import Baseline
    from tpulmi_torch.baseline import exact_knn_streamed

    corpus, qs = big["data_search"], big["queries_search"]
    n = corpus.shape[0]
    nbytes = corpus.nbytes

    def stream(host=corpus, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        d, i = exact_knn_streamed(qs, host, k=10, chunk=STREAM_CHUNK,
                                  device=dev, **kw)
        secs = time.perf_counter() - t
        if d.shape != (N_QUERIES, 10) or not np.isfinite(d).all():
            raise AssertionError(f"bad streamed result {d.shape}")
        return d, i, secs

    d16, i16, s16 = stream()
    t = time.perf_counter()
    gt16 = exact_ids(qs, corpus.bits, dev, bf16_inputs=True)
    oracle_s = time.perf_counter() - t
    rows16 = equal_but_ties(i16 + 1, d16, gt16 + 1, d16, qs, corpus, 1e-5,
                            bf16=True)
    log(f"[baseline] exact_knn_streamed, {n} x {D_SEARCH} bfloat16 host "
        f"corpus, {N_QUERIES} queries, blocks of {STREAM_CHUNK}, bfloat16 "
        f"products summed in float32: {s16:.2f}s = {nbytes / s16 / 1e9:.2f}"
        f" GB/s host to card; ids equal to a bf16-input oracle's "
        f"({oracle_s:.2f}s) but for ties ({rows16} rows differ)")
    d32, i32, s32 = stream(compute_dtype=torch.float32)
    rows32 = equal_but_ties(i32 + 1, d32, gt_big + 1, d32, qs, corpus, 1e-5)
    log(f"[baseline] the same in float32: {s32:.2f}s = "
        f"{nbytes / s32 / 1e9:.2f} GB/s; ids equal to the float32 oracle's "
        f"but for ties ({rows32} rows differ)")

    class Interrupted:
        """The corpus, failing when a block from row `stop` on is read."""

        def __init__(self, arr, stop):
            self.arr, self.stop, self.shape = arr, stop, arr.shape

        def __getitem__(self, idx):
            if isinstance(idx, slice) and (idx.start or 0) >= self.stop:
                raise RuntimeError("injected failure")
            return self.arr[idx]

    resumed = []

    class Resumed(logging.Handler):
        def emit(self, record):
            if "resuming" in record.getMessage():
                resumed.append(record.getMessage())

    handler = Resumed()
    logging.getLogger("tpulmi_torch.baseline").addHandler(handler)
    with tempfile.TemporaryDirectory() as tmp:
        part = os.path.join(tmp, "gt.part")
        t = time.perf_counter()
        try:
            stream(Interrupted(corpus, 5 * STREAM_CHUNK), resume_path=part,
                   checkpoint_every=2)
            raise AssertionError("the interrupted pass did not fail")
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
        fail_s = time.perf_counter() - t
        with np.load(part) as z:
            lo = int(z["lo"])
        dr, ir, sr = stream(resume_path=part, checkpoint_every=2)
    logging.getLogger("tpulmi_torch.baseline").removeHandler(handler)
    if lo != 4 * STREAM_CHUNK or len(resumed) != 1 or \
            f"at {lo}/" not in resumed[0]:
        raise AssertionError(f"resumed at {lo} ({resumed}), not at "
                             f"{4 * STREAM_CHUNK}")
    if not (np.array_equal(dr, d16) and np.array_equal(ir, i16)):
        raise AssertionError("the resumed pass differs from the "
                             "uninterrupted one")
    log(f"[baseline] resumable pass, a checkpoint every 2 blocks, failed "
        f"after its 5th block in {fail_s:.2f}s; rerun {resumed[0]!r} in "
        f"{sr:.2f}s = {(n - lo) * D_SEARCH * 2 / sr / 1e9:.2f} GB/s; equal "
        f"to the uninterrupted pass to the bit")

    base = Baseline(device=dev)
    build_s = base.build(ds["data_search"])
    bd, bi, search_s = base.search(ds["queries_search"], k=10)
    rows = equal_but_ties(bi, bd, gt + 1, bd, ds["queries_search"],
                          ds["data_search"], 1e-5)
    log(f"[baseline] Baseline on the main data ({N} x {D_SEARCH}): build "
        f"{build_s:.3f}s, search {search_s:.3f}s; 1-based ids equal to the "
        f"oracle's but for ties ({rows} rows differ)")
    del base

    # one block's device work by step (CUDA events, mean of 3), and what
    # TF32 would save and cost on the float32 product
    from tpulmi_torch.baseline import _block_topk, _merge_block

    q16 = torch.as_tensor(qs, device=dev).to(torch.bfloat16)
    block = torch.from_numpy(np.ascontiguousarray(
        corpus.bits[:STREAM_CHUNK]).view(np.int16)).to(dev).view(
            torch.bfloat16)
    qf, bf = q16.float(), block.float()
    prod_ms = cuda_ms(lambda: qf @ bf.T, 3)
    exact = qf @ bf.T
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_ms = cuda_ms(lambda: qf @ bf.T, 3)
        tf32_err = float(((qf @ bf.T) - exact).abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    dists = exact.neg_().add_(1.0)
    ids = torch.arange(STREAM_CHUNK, dtype=torch.int32, device=dev).expand(
        qs.shape[0], -1)
    topk_ms = cuda_ms(lambda: _block_topk(dists, ids, 10), 3)
    del dists, exact, ids
    best_d = torch.full((qs.shape[0], 10), 10_000.0, device=dev)
    best_i = torch.zeros((qs.shape[0], 10), dtype=torch.int32, device=dev)
    merge_ms = cuda_ms(lambda: _merge_block(best_d, best_i, q16, block, 0,
                                            STREAM_CHUNK, 10), 3)
    blocks = -(-n // STREAM_CHUNK)
    log(f"[baseline] one block of {STREAM_CHUNK} rows x {qs.shape[0]} "
        f"queries on the card: float32 product {prod_ms:.2f} ms (under "
        f"TF32 {tf32_ms:.2f} ms, {tf32_err:.2e} from the float32 one), "
        f"running top-k of 10 with the tie rule {topk_ms:.2f} ms, the whole "
        f"block merge {merge_ms:.2f} ms; {blocks} merges "
        f"{blocks * merge_ms / 1e3:.2f}s of the bfloat16 pass's {s16:.2f}s")
    del q16, block, qf, bf
    torch.cuda.empty_cache()


def phase_cli(index, ds, dev, gt):
    """The experiment CLI and the sweeps on the main data, the launch
    counts set to 0 before each part that searches and read after it:
    (a) the command line ``--synthetic N --n-categories 122 --epochs 12
    --lr 0.003 -bp 1 2 3`` (phase main's IndexConfig and data), whose
    results at 1, 2 and 3 probes must be the main index's searches and
    whose logged recalls theirs, through `cli.main` in this process with
    its result writer (`_store`, an h5 file) replaced by one that keeps the
    arrays, so that the check needs no h5py; (b) `cli.run` with an int8
    store, the worklist and the 128-row tile (K2, K4, K6 launched; ids equal
    to the main index quantized the same way under the same SearchConfig),
    and ``index_type="baseline"`` (ids equal to the oracle's but for ties);
    (c) `run_sweep` crashed after one learning rate and resumed with two:
    one new row, the first row's recall the main index's (K1 launched by
    (a) and (c)); (d) `train_lr_sweep` over four learning rates on the
    main navigation data, every loss falling, its first 20 steps fed one
    draw equal to a `BucketClassifier` at lr 0.003 within 1e-5, timed
    beside one single-lr run of the same length; (e) one search inside
    `trace`, whose Chrome trace must name the probe kernel."""
    import copy
    import importlib.util
    import logging
    import os
    import re

    import numpy as np
    import torch
    import tpulmi_torch.cli as cli
    from tpulmi_torch import SearchConfig
    from tpulmi_torch.evaluate import recall_at_k
    from tpulmi_torch.models import train_lr_sweep
    from tpulmi_torch.models.mlp import make_model
    from tpulmi_torch.models.train import BucketClassifier
    from tpulmi_torch.ops.probe_topk import (launch_counts,
                                             reset_launch_counts)
    from tpulmi_torch.sweep import SweepGrid, _load_done, run_sweep
    from tpulmi_torch.utils.profiling import trace

    host = (ds["queries_nav"], ds["queries_search"])
    size = "300K"      # the SISAP size label of the main shape
    argv = ["--synthetic", str(N), "--n-categories", str(N_CAT), "--epochs",
            "12", "--lr", "0.003", "-bp", "1", "2", "3", "--size", size]
    budgets = [int(b / 100 * N_CAT) for b in (1, 2, 3)]
    want = {p: index.search(*host, n_buckets=p, k=10) for p in budgets}
    recalls = {p: recall_at_k(want[p][1] - 1, gt, 10) for p in budgets}
    lines, kept = [], {}

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    def keep_store(result_dir, kind, size, identifier, algo, dists, nns,
                   build_t, search_t):
        kept[identifier] = (dists, nns)

    handler = Keep()
    logging.getLogger("tpulmi_torch.cli").addHandler(handler)
    plain_store = cli._store
    cli._store = keep_store
    try:
        # (a) the command line
        h5 = "is" if importlib.util.find_spec("h5py") else "is not"
        log(f"[cli] h5py {h5} installed here; the command line runs through "
            f"tpulmi_torch.cli.main in this process, its result writer "
            f"(_store) replaced by one that keeps the arrays")
        reset_launch_counts()
        t = time.perf_counter()
        cli.main(argv, device=dev)
        cli_s = time.perf_counter() - t
        k1 = launch_counts()["probe_topk"]
        got = {int(ident.rsplit("=", 1)[1]): v for ident, v in kept.items()}
        logged = [float(r) for r in re.findall(
            r"recall@10 vs exact oracle: ([\d.]+)", "\n".join(lines))]
        if sorted(got) != budgets or len(logged) != len(budgets):
            raise AssertionError(f"the CLI wrote {sorted(kept)} and logged "
                                 f"{logged}")
        for p, rec in zip(budgets, logged):
            if not (np.array_equal(got[p][1], want[p][1])
                    and np.array_equal(got[p][0], want[p][0])):
                raise AssertionError(f"the CLI's {p}-probe ids or distances"
                                     f" differ from the main index's search")
            if f"{rec:.4f}" != f"{recalls[p]:.4f}":
                raise AssertionError(f"the CLI's recall {rec} at {p} probes"
                                     f" is not the main index's "
                                     f"{recalls[p]}")
        stages = "; ".join(line for line in lines if re.match(
            r"(data:|build time|search with)", line))
        log(f"[cli] (a) {' '.join(argv)}: {cli_s:.1f}s ({stages}); ids and "
            f"distances at {budgets} probes equal to the main index's "
            f"searches, recall@10 {logged} equal to theirs; K1 launched "
            f"{k1} times")
        if not k1 > 0:
            raise AssertionError("the CLI's searches launched no K1")

        # (b) an int8 store with the worklist and the 128-row tile
        kept.clear()
        reset_launch_counts()
        t = time.perf_counter()
        cli.run(synthetic=N, n_categories=N_CAT, epochs=12, lr=0.003,
                buckets_perc=[2], size=size, store_dtype="int8",
                pallas_worklist=True, pallas_pair=True, result_dir="unused",
                device=dev)
        int8_s = time.perf_counter() - t
        launched = {n: c for n, c in launch_counts().items() if c}
        (cli_d, cli_i), = kept.values()
        kept.clear()
        t = time.perf_counter()
        cli.run(synthetic=N, n_categories=N_CAT, index_type="baseline",
                size=size, result_dir="unused", device=dev)
        base_s = time.perf_counter() - t
        base_d, base_i = kept["li-baseline"]
    finally:
        cli._store = plain_store
        logging.getLogger("tpulmi_torch.cli").removeHandler(handler)
    for name in ("probe_topk_quant_int8", "probe_worklist", "probe_pair"):
        if not launched.get(name, 0) > 0:
            raise AssertionError(f"the int8 CLI run launched no {name}: "
                                 f"{launched}")
    full = index.built.store
    index.quantize(host_corpus=np.asarray(ds["data_search"], np.float32),
                   bits=8)
    scfg = SearchConfig(k=10, prune_after=0, backend="auto",
                        rerank_dtype="float32", pallas_worklist=True,
                        pallas_extract="group", pallas_pair=True,
                        rerank_extra=10)
    fd, fi = index.search(*host, n_buckets=budgets[1], k=10,
                          search_config=scfg)
    index.built.store = full
    index._search_programs = {}
    index._host_corpus = None
    if not (np.array_equal(cli_i, fi) and np.array_equal(cli_d, fd)):
        raise AssertionError("the int8 CLI run differs from the main index "
                             "quantized the same way")
    rows = equal_but_ties(base_i, base_d, gt + 1, base_d,
                          ds["queries_search"], ds["data_search"], 1e-5)
    log(f"[cli] (b) cli.run int8 store, worklist, 128-row tile, "
        f"{budgets[1]} probes: {int8_s:.1f}s, launches {launched}; ids and "
        f"distances equal to the main index quantized the same way, "
        f"recall@10 {recall_at_k(cli_i - 1, gt, 10):.4f}; "
        f"index_type=baseline {base_s:.1f}s, ids equal to the oracle's but "
        f"for ties ({rows} rows differ)")

    # (c) the sweep, crashed after one learning rate, then resumed
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sweep.csv")
        kw = dict(gt_ids=gt + 1, resume_path=path, device=dev)
        data = (ds["data_nav"], ds["queries_nav"], ds["data_search"],
                ds["queries_search"])
        t = time.perf_counter()
        first = run_sweep(*data, grid=SweepGrid(
            lrs=(0.003,), epochs=(12,), n_categories=(N_CAT,),
            buckets_perc=(2,)), **kw)
        crash_s = time.perf_counter() - t
        t = time.perf_counter()
        rest = run_sweep(*data, grid=SweepGrid(
            lrs=(0.003, 0.009), epochs=(12,), n_categories=(N_CAT,),
            buckets_perc=(2,)), **kw)
        resume_s = time.perf_counter() - t
        done = _load_done(path)
    k1 = launch_counts()["probe_topk"]
    if len(first) != 1 or len(rest) != 1 or rest[0].lr != 0.009 or \
            len(done) != 2:
        raise AssertionError(f"sweep rows {first} then {rest}, {done}")
    if not abs(first[0].recall - recalls[budgets[1]]) <= 1e-9:
        raise AssertionError(f"the sweep's recall {first[0].recall} is not "
                             f"the main index's {recalls[budgets[1]]}")
    if not k1 > 0:
        raise AssertionError("the sweep's searches launched no K1")
    log(f"[cli] (c) run_sweep with lr 0.003, then resumed with (0.003, "
        f"0.009): {crash_s:.1f}s + {resume_s:.1f}s, one new row; recall@10 "
        f"{first[0].recall:.4f} (the main index's {recalls[budgets[1]]:.4f})"
        f" and {rest[0].recall:.4f} at lr 0.009; builds "
        f"{first[0].build_s:.2f} / {rest[0].build_s:.2f}s; K1 launched {k1}"
        f" times")

    # (d) train_lr_sweep: four learning rates at once
    X = torch.as_tensor(ds["data_nav"], device=dev)
    y = index.built.pred_categories.to(dev)
    lrs = (0.001, 0.003, 0.009, 0.03)
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, losses = train_lr_sweep("MLP-5", X, y, lrs, epochs=12,
                               batch_size=1024, seed=SEED, device=dev)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t
    losses = losses.cpu().numpy()
    if losses.shape != (len(lrs), 12) or not (
            losses[:, -1] < losses[:, 0]).all():
        raise AssertionError(f"train_lr_sweep losses {losses[:, [0, -1]]}")
    clf = BucketClassifier(D_NAV, N_CAT, lr=0.003, seed=SEED, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    clf.train(X, y, epochs=12, batch_size=1024)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t
    init = make_model("MLP-5", D_NAV, N_CAT,
                      generator=torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED + 1)
    batch = min(1024, X.shape[0] // 20)
    draw = [torch.randperm(X.shape[0], generator=gen)[:20 * batch]
            .reshape(20, batch)]
    stacked, _ = train_lr_sweep("MLP-5", X, y, lrs, device=dev,
                                init_models=[copy.deepcopy(init)
                                             for _ in lrs], batches=draw)
    one = BucketClassifier(D_NAV, N_CAT, lr=0.003, device=dev,
                           model=copy.deepcopy(init))
    one.train(X, y, batches=draw)
    with torch.no_grad():
        err = max(max(float((stacked.weights[j][1] - layer.weight).abs()
                            .max()),
                      float((stacked.biases[j][1] - layer.bias).abs().max()))
                  for j, layer in enumerate(one.model.layers))
    if not err <= 1e-5:
        raise AssertionError(f"20 stacked steps at lr 0.003 differ from "
                             f"BucketClassifier's by {err}")
    log(f"[cli] (d) train_lr_sweep, MLP-5 on {N} x {D_NAV}, lrs {lrs}, 12 "
        f"epochs of {N // 1024} steps of 1024: {sweep_s:.2f}s; one "
        f"BucketClassifier run of the same length {single_s:.2f}s; loss "
        f"first / last epoch " + ", ".join(
            f"{a:.4f} / {b:.4f}" for a, b in losses[:, [0, -1]]) + f"; 20 "
        f"steps fed one draw equal to BucketClassifier's at lr 0.003 "
        f"within {err:.2e}")

    # (e) one search inside trace
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp, device=dev):
            index.search(*host, n_buckets=2, k=10)
        (name,) = os.listdir(tmp)
        with open(os.path.join(tmp, name)) as f:
            text = f.read()
    if "probe_kernel" not in text:
        raise AssertionError("the trace names no probe kernel")
    log(f"[cli] (e) trace of one search: {name}, {len(text)} bytes, names "
        f"the probe kernel")


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

        results[f"probe_topk_int8q_int{bits}"] = measure(
            f"probe_topk_int8q int{bits} store, int8 queries",
            lambda: probe_topk_int8q(*iargs),
            lambda: probe_topk_int8q_plain(*iargs),
            library_int8q(q_codes, codes, scales, bits, layout, k),
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

    t0 = time.perf_counter()

    def done(phase):
        log(f"[time] {phase} done at {time.perf_counter() - t0:.1f}s")

    phase_build()
    done("build")
    kernel_errs = phase_far(dev, phase_variants(dev, phase_kernels(dev)))
    done("kernels")
    if "--kernels-only" in args:
        log("[kernels] --kernels-only: stopping after the kernel checks")
        return 0
    index, ds, main_launches, gt, f32_recall = phase_main(dev)
    done("main")
    quant_launches, stores = phase_quantized(index, ds, dev, gt, f32_recall)
    done("quantized")
    serving_launches = phase_serving(index, stores, ds, dev, gt,
                                     "--profile" in args)
    done("serving")
    # the 2M corpus of the hoststore phase serves the hier phase too
    with tempfile.TemporaryDirectory() as cache:
        big, gt_big = phase_hoststore(index, ds, dev, gt, cache)
        done("hoststore")
        _, hier = phase_hier(index, ds, dev, gt, big, gt_big, cache, name,
                             kernel_errs)
        done("hier")
        phase_shard(index, stores, ds, dev, gt, big, gt_big, hier, cache,
                    kernel_errs)
        done("shard")
        del hier
        phase_baseline(ds, dev, gt, big, gt_big)
        done("baseline")
        del big
    card_rerank = {"flat10m": phase_flat10m(dev, name, kernel_errs)}
    done("flat10m")
    card_rerank["hier20m"] = phase_hier20m(dev, name, kernel_errs)
    done("hier20m")
    phase_hier40m(dev, name, kernel_errs)
    done("hier40m")
    phase_prune(index, stores, ds, dev)
    done("prune")
    phase_cli(index, ds, dev, gt)
    done("cli")
    timing = phase_timing(index, stores, ds, dev, name)
    phase_timing_skewed(dev)
    done("timing")

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
    # replaces no TPU kernel: the JAX package reranks on the host
    for phase, t in card_rerank.items():
        kernels.append({
            "name": f"rerank_card.{phase}", "route": "cuda",
            "source": KERNEL_SOURCES["rerank_card"], "replaces": None,
            **{key: t[key] for key in (
                "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "q", "k_eff", "rows")}})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2:]))
    sys.exit(main(sys.argv[1:]))
