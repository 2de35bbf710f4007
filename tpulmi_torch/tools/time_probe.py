"""Time the probe kernel's two main loops on one NVIDIA card.

    python3 -m tpulmi_torch.tools.time_probe [--off BITS] [--clocks]
                                             [--rounds N] [--match TEXT]
                                             [--store main|skewed]
                                             [--orders] [--cluster 2,4]

A synthetic store of the main path's shape (about 300K unit rows of 768
features in 122 buckets of 960 to 3,960 rows, 10k queries at 2 probes drawn
in proportion to bucket size, k = 10) is probed by every configuration
that has the wgmma loop: full precision, int8 and int4 codes under bfloat16
queries, int8 and int4 codes under int8 queries, each with the 64- and the
128-row tile, through the worklist (items of 1024 rows, with either tile)
and with the rerank pool (k_out = 2k, with either tile), beside the staged
loop on the same inputs. Each line names the main loop that the launch
took. Prints one line per configuration and round with the mean time of
20 launches, after the card's name and power limit. ``--store skewed``
takes chip_smoke.py's skewed store instead (122 buckets of 400 to 4,400
rows but one of 25 times their mean, probed in proportion to size). The
store is not a built index: compare these times with each other, and take
the main path's from chip_smoke.py.

``--orders`` times each worklist configuration in three orders of its
items, in turns (each order, then each again in reverse), each checked
against the one-CTA-per-block launch to the bit, with the lists made
before the timing: the block-major list that `build_worklist` gives; a
grouped one in which, bucket by bucket, the j-th group of g chunks of
every block of the bucket stand side by side (g = ceil(items / CTAs), with
one CTA on each SM), so that CTAs whose ranges start together read the
same rows of a bucket; and a strided one, in which the s-th item of every
CTA's range is about block-major item s G + c, so that the G CTAs at their
s-th items hold neighbouring items, as the one-CTA-per-block launch runs a
bucket's blocks together. The kernel takes items in any order, but cuts
the CTAs' ranges at the places where the block-major items' tiles would
cut them, so the other two are balanced only about as well; the wrapper
lays the items out block-major.

``--off BITS`` builds the wgmma loop with parts left out
(csrc/probe_wgmma.cuh, PROBE_PARTS_OFF: 1 the list inserts, 2 the whole
epilogue, 4 the wgmmas, 8 the column scales of a quantized store, 16 the
pool's gate (every column folded from the registers instead, a pool
without a gate), 32 the pool's folds, 64 its extras), into libraries of
their own, to see what the rest costs; the staged loop and the worklist's
merge are then not run, and no result is checked. ``--match TEXT`` times
only the configurations whose line would hold TEXT. ``--clocks``
builds it with PROBE_CLOCKS=1: one warp of every 97th CTA prints where its
cycles went (on the worklist's persistent grid, over all of its pieces),
and each configuration is launched twice only (the times printed then mean
little).

``--cluster 2,4`` times every one-CTA-per-block configuration of the wgmma
loop, with either tile, in thread-block clusters of each listed size and
without one, in turns (1, 2, 4, 4, 2, 1), each result checked against the
launch without a cluster to the bit (not with ``--off``), and prints the
tile walks that each grouping gives. The libraries are then built with
PROBE_CLUSTER_ALL=1, so that the 64-row tile, which launches without a
cluster, can be timed in one too; it combines with ``--off``,
``--clocks`` and either store.
"""

import argparse
import subprocess
import sys
import time

import torch

from tpulmi_torch.ops import _kernels
from tpulmi_torch.ops import probe_topk as probe
from tpulmi_torch.ops.quantize import quantize_rows, quantize_rows_int4

N_CAT, N_QUERIES, D, K, SEED = 122, 10_000, 768, 10, 1


def cuda_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ordered_worklist(order, blocks, wl_pad, span, ctas):
    """`build_worklist`'s items in one of the orders of ``--orders``; the
    block items and the total as it gives them: they name an item by its
    block-major place, where the kernel writes a piece's lists."""
    items, block_items, total = BUILD_WORKLIST(blocks, wl_pad, span)
    n = min(int(total), wl_pad)
    g = min(ctas, n)
    blk, chunk = items[:n, 0].long(), items[:n, 1].long()
    if order == "grouped":
        # bucket by bucket, the j-th group of ceil(n / g) chunks of each of
        # its blocks, block after block
        start = blocks[blk, 0].long()
        key = start * (wl_pad + 1) + chunk // -(-n // g)
        first = torch.argsort(key, stable=True)
    else:
        # strided: the s-th item of CTA c's range is block-major item about
        # s g + c, so the CTAs at their s-th items hold g neighbours
        p = torch.arange(n, device=items.device)
        c = ((p + 1) * g + n - 1) // n - 1
        s = p - c * n // g
        first = torch.empty_like(p)
        first[torch.argsort(s * g + c)] = p
    out = items.clone()
    out[:n] = items[first]
    return out, block_items, total


BUILD_WORKLIST = probe.build_worklist


def store_sizes(kind, rng):
    """Bucket sizes of the main-shaped or the skewed store."""
    if kind == "main":
        return (torch.rand(N_CAT, generator=rng) * 3000).long() + 960
    sizes = (torch.rand(N_CAT, generator=rng) * 4000).long() + 400
    sizes[0] = int(25 * float(sizes.float().mean()))
    return sizes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--off", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--match", default="")
    ap.add_argument("--store", choices=("main", "skewed"), default="main")
    ap.add_argument("--orders", action="store_true")
    ap.add_argument("--cluster", default="",
                    help="cluster sizes to time in turns, e.g. 2,4")
    args = ap.parse_args(argv)
    sizes_c = [int(c) for c in args.cluster.split(",") if c]
    if any(c not in probe.CLUSTER_SIZES[1:] for c in sizes_c):
        ap.error(f"--cluster takes sizes of {probe.CLUSTER_SIZES[1:]}")
    if not torch.cuda.is_available():
        print("time_probe: no CUDA device", file=sys.stderr)
        return 1
    if args.off:
        _kernels.NVCC_FLAGS += (f"-DPROBE_PARTS_OFF={args.off}",)
    if args.clocks:
        _kernels.NVCC_FLAGS += ("-DPROBE_CLOCKS=1",)
    if sizes_c:
        _kernels.NVCC_FLAGS += ("-DPROBE_CLUSTER_ALL=1",)
    start = time.perf_counter()
    _kernels.build(_kernels.LIBRARIES)      # all at once, not one by one
    print(f"[build] {len(_kernels.LIBRARIES)} kernel libraries in "
          f"{time.perf_counter() - start:.2f}s", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = torch.Generator().manual_seed(SEED)
    sizes = store_sizes(args.store, rng)
    offsets = torch.cat([torch.zeros(1, dtype=torch.long),
                         torch.cumsum(sizes, 0)])
    x = torch.randn((int(offsets[-1]), D), generator=gen, device=dev)
    x = x / x.norm(dim=1, keepdim=True)
    q = torch.randn((N_QUERIES, D), generator=gen, device=dev)
    q = (q / q.norm(dim=1, keepdim=True)).bfloat16()
    probes = torch.multinomial(sizes.float().expand(N_QUERIES, -1), 2,
                               generator=rng).int().to(dev)
    lay = probe.group_slots(probes, offsets.int().to(dev),
                            sizes.int().to(dev))
    slots = lay.slot_counts.double().cpu()
    flops = float(2 * D * (slots * sizes.double()).sum())
    items = int((-(-slots.long() // probe.BLOCK_SLOTS)
                 * -(-sizes // 1024)).sum())
    wl = dict(wl_pad=-(-int(items * 1.15) // 1024) * 1024, item_rows=1024,
              merge=not args.off)
    ctas = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"{int(offsets[-1])} rows, longest bucket {int(sizes.max())}; "
          f"{int((lay.blocks[:, 2] > 0).sum())} live blocks, {items} work "
          f"items; {flops / 1e9:.2f} GFLOP; parts off: {args.off}",
          flush=True)
    if sizes_c:
        reads = {c: probe.cluster_reads(lay.blocks, c)
                 for c in [1] + sizes_c}
        print(f"tile walks over {reads[1]['buckets']} probed buckets: "
              + ", ".join(f"C={c} {r['groups']} ({r['groups'] / r['buckets']:.3f}"
                          f" a bucket, {r['rows_read'] / r['bucket_rows']:.3f}"
                          f" by rows)" for c, r in reads.items()), flush=True)

    data = x.bfloat16()
    launches = [("full precision", probe.probe_topk,
                 (q, lay.qidx, data, lay.blocks, K))]
    qc, qs = quantize_rows(q.float())
    for bits, quant in ((8, quantize_rows), (4, quantize_rows_int4)):
        codes, scales = quant(x)
        launches.append((f"int{bits} codes", probe.probe_topk_quant,
                         (q, lay.qidx, codes, scales, lay.blocks, K, bits)))
        launches.append((f"int8 queries, int{bits} codes",
                         probe.probe_topk_int8q,
                         (qc, qs, lay.qidx, codes, scales, lay.blocks, K,
                          bits)))
    for rnd in range(args.rounds):
        for name, fn, a in launches:
            configs = [("", {}), ("128-row tile", dict(pair=True)),
                       ("worklist", wl),
                       ("worklist, 128-row tile", dict(pair=True, **wl)),
                       ("pool", dict(k_out=2 * K)),
                       ("pool, 128-row tile", dict(k_out=2 * K, pair=True))]
            if not args.off and not args.clocks:
                configs.insert(1, ("", dict(loop="staged")))
            for label, opts in configs:
                if args.match not in f"{name}, {label}, {opts}":
                    continue
                before = probe.loop_launch_counts()
                fn(*a, **opts)
                after = probe.loop_launch_counts()
                loop = [n for n in after if after[n] != before[n]][0]
                reps = 1 if args.clocks else 20
                if sizes_c and loop == "wgmma" and "wl_pad" not in opts:
                    print(f"round {rnd}: {name}, {loop}"
                          f"{', ' + label if label else ''}: "
                          + time_clusters(fn, a, opts, sizes_c, reps,
                                          check=not args.off), flush=True)
                    continue
                ms = cuda_ms(lambda: fn(*a, **opts), reps)
                print(f"round {rnd}: {name}, {loop}"
                      f"{', ' + label if label else ''}: {ms:.4f} ms = "
                      f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
                if args.orders and "wl_pad" in opts:
                    print(f"round {rnd}: {name}, {loop}, {label}: "
                          + time_orders(fn, a, opts, ctas), flush=True)
    return 0


def time_clusters(fn, a, opts, sizes_c, reps, check):
    """One configuration without a cluster and in clusters of each of
    `sizes_c`, in turns (1, ..., last, last, ..., 1); with `check`, each
    cluster's result against the launch without one, to the bit."""
    order = [1] + sizes_c
    if check:
        alone = fn(*a, **opts, cluster=1)
        for c in sizes_c:
            got = fn(*a, **opts, cluster=c)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], alone[0])
                    and torch.equal(got[1], alone[1])):
                raise AssertionError(f"{opts} in clusters of {c} differs "
                                     f"from the launch without one")
    turns = [cuda_ms(lambda c=c: fn(*a, **opts, cluster=c), reps)
             for c in order + order[::-1]]
    return ", ".join(
        f"C={c} {(turns[i] + turns[-1 - i]) / 2:.4f} ms" for i, c in
        enumerate(order)) + f" (turns {', '.join(f'{t:.4f}' for t in turns)})"


ORDERS = ("block-major", "grouped", "strided")


def time_orders(fn, a, opts, ctas):
    """The item orders of ``--orders``, in turns (each, then each again in
    reverse); each result against the one-CTA-per-block launch of the same
    options, to the bit. The lists are made before the timing."""
    dense = fn(*a, **{n: v for n, v in opts.items()
                      if n in ("pair", "k_out")})
    lists = {}

    def listed(order):
        def build(b, pad, span):
            if (order, pad, span) not in lists:
                lists[order, pad, span] = (
                    BUILD_WORKLIST(b, pad, span) if order == "block-major"
                    else ordered_worklist(order, b, pad, span, ctas))
            return lists[order, pad, span]
        return build

    times = {order: [] for order in ORDERS}
    for order in ORDERS + ORDERS[::-1]:
        probe.build_worklist = listed(order)
        try:
            out = fn(*a, **{**opts, "merge": True})
            torch.cuda.synchronize()
            if not (torch.equal(out[0], dense[0])
                    and torch.equal(out[1], dense[1])):
                raise AssertionError(f"the {order} worklist differs from "
                                     f"one CTA per block")
            times[order].append(cuda_ms(lambda: fn(*a, **opts)))
        finally:
            probe.build_worklist = BUILD_WORKLIST
    return ", ".join(f"{order} {sum(t) / 2:.4f} ms ({t[0]:.4f}, {t[1]:.4f})"
                     for order, t in times.items())


if __name__ == "__main__":
    sys.exit(main())
