// Fused cosine-distance + running top-k probe kernel for Hopper (sm_90a).
//
// Replaces tpulmi/ops/pallas_topk.py::_kernel_core, the TPU probe kernel on
// its dense grid, in all three of its extract modes ("scalar", "group",
// "group2"): they compute one function, so one kernel serves them all.
//
// What it computes. The wrapper (tpulmi_torch/ops/probe_topk.py) groups every
// (query, probe) slot by its probed bucket into blocks of QB slots, so each
// block belongs to one bucket. For each live slot of a block, the kernel
// returns the k smallest  1 - q . x  over the rows [start, start + count) of
// that bucket, ascending, with the store row of each; where the bucket holds
// fewer than k rows the rest is distance 10000 and row -1. Ties keep the
// lower store row, as a stable sort does.
//
// Design. One CTA owns one block of QB slots and loops over its bucket's
// rows in tiles of NB rows, so a small bucket costs a short loop and an empty
// block exits at once (the TPU's dense grid paid one empty step per missing
// chunk instead). The slots' query rows are gathered through the slot ->
// query index, so the wrapper never copies queries into slot order. The
// product of a tile is summed in float32 and kept out of device memory; each
// slot row's candidates that beat its k-th best, found by a vote, are
// inserted one at a time and in column order into the row's sorted list (KPL
// entries per lane, shifted across lanes with a shuffle). After a few tiles
// almost no column beats the threshold, so the top-k costs one compare per
// distance.
//
// Two main loops compute it (csrc/probe_common.cuh::loop_of chooses):
//
//   - bfloat16 and float16, the main path: probe_wgmma.cuh. The block's
//     query rows stay in shared memory for the CTA's life in the layout wgmma
//     reads; one thread streams the store through a ring of TMA tile loads
//     that complete on mbarriers; a warpgroup multiplies with wgmma
//     m64nNBk16 and tests the distances against the thresholds in the
//     accumulator registers, so a tile that improves no list touches shared
//     memory not at all;
//   - float32 (the TPU kernel's compute_dtype=float32; tf32 would round the
//     inputs), and any shape whose resident queries do not fit (d above
//     about 1,000 at k <= 32): probe_common.cuh::probe_kernel, which stages
//     query and store slices of 256 bytes a row through shared memory with
//     plain loads and barriers and multiplies on the CUDA cores (float32) or
//     with WMMA.
//
// This file instantiates both for stores that hold vectors of the queries'
// type. It is compiled twice: as it is (tiles of 64 store rows) and with
// -DPROBE_NB=128 (the paired tile, which replaces the `pair` grid of the TPU
// kernel). Either library also runs the worklist (`items`) and the rerank
// pool (`k_out > k`), see the header.
//
// Limits. k <= 128 (as the TPU kernel's 128-lane scratch), d % 8 == 0 (16-byte
// row loads and the tensor map's row stride). The TPU kernel's
// row_align % mc == 0 and d % 128 == 0 were tiling needs of the TPU and are
// dropped: rows are addressed directly, the last tile is masked, and the
// last feature slice is masked (staged loop) or zero-filled by the TMA unit.
//
// What bounds it. Each probed bucket must be read once (bytes) and
// 2 d slots rows operations done on it; at the 300K x 768 main-path shape in
// bfloat16 the two bounds are of the same order (in float32 the operations,
// at the CUDA cores' rate, bound it). The wgmma loop removes what kept the
// first version at a few percent of that: exposed load latency (the ring
// keeps several stages in flight), the query rows staged again for every
// store tile (they are resident), WMMA from shared memory, and the product
// tile written and read back for every tile. A bucket is still read once
// per 64-slot block, about three times at 2 probes; reading it once per
// cluster group (the 128-row tile) made it no faster, so those reads are
// not the floor: the wgmmas beside shared memory's traffic and the
// epilogue are (probe_wgmma.cuh). One CTA then
// fills an SM, so the blocks run in waves and the longest bucket sets the
// tail; the worklist (`items`) evens that out.

#include "probe_common.cuh"

#ifndef PROBE_NB
#define PROBE_NB 64
#endif

extern "C" {

// Slots per block: the wrapper lays slots out in blocks of this size.
int probe_topk_block_slots() { return probe::QB; }

// Store rows per tile of this library.
int probe_topk_tile_rows() { return PROBE_NB; }
namespace {
int query_bytes(int dtype) { return dtype == 2 ? 4 : 2; }
}  // namespace

// The main loop that a launch of these sizes takes (0 staged, 1 wgmma), and
// the shared memory one CTA of a loop takes.
int probe_topk_loop(int dtype, int d, int k, int pool) {
  return probe::loop_of(query_bytes(dtype), probe::SRC_SAME, d, k, pool != 0,
                        PROBE_NB);
}
long long probe_topk_smem_bytes(int loop, int dtype, int d, int k, int pool) {
  return (long long)probe::loop_smem_bytes(loop, query_bytes(dtype),
                                           probe::SRC_SAME, d, k, pool != 0,
                                           PROBE_NB);
}
// The CTAs of a cluster that a launch of these sizes takes by the rule (1:
// none); `worklist` != 0 for a launch with items.
int probe_topk_cluster(int dtype, int d, int k, int pool, int worklist) {
  return probe::cluster_of(
      probe_topk_loop(dtype, d, k, pool), PROBE_NB, worklist != 0);
}

// Launch on `stream`: one CTA per block of `blocks` (`n_ctas` = `n_blocks`
// of them), or, with `items` (n_ctas, 2; `block_items` (n_blocks, 2)),
// the worklist of `n_ctas` items of `span` store rows. Its partial lists (n_ctas * QB, k) go to out_d /
// out_i, its pool folds into `pool`, and `written` (n_ctas,) int8, zeros on
// entry, gets a 1 where an item starts a written piece: the wgmma loop
// walks the items on a persistent grid (`ctas` CTAs, or with 0 as many as
// the card holds at once), the staged loop takes one CTA per item and
// marks each. `k_out` > k asks for the pool (k_out = k: none). `dtype` is
// the type of q and data: 0 bfloat16, 1 float16, 2 float32. `loop`: 0 or 1
// asks for that main loop (1 is refused where probe_topk_loop gives 0),
// anything else leaves it to the rule. `cluster`: the CTAs of a cluster, 0
// for probe_topk_cluster's (above 1 only for the wgmma loop without items;
// a cluster the card cannot hold is refused). Returns the CUDA error code
// of the launch (0 = ok).
int probe_topk_launch(const void *q, const void *qidx, const void *data,
                      const void *blocks, const void *items,
                      const void *block_items, void *written, void *out_d,
                      void *out_i, void *pool, int n_ctas, int ctas,
                      int n_blocks, int d, long long n_rows, int k, int k_out,
                      int span, int dtype, int loop, int cluster,
                      void *stream) {
  using namespace probe;
  if (n_ctas <= 0) return 0;
  const ProbeArgs a{q, static_cast<const int *>(qidx), data, nullptr,
                    static_cast<const int *>(blocks),
                    static_cast<const int *>(items),
                    static_cast<const int *>(block_items),
                    static_cast<signed char *>(written),
                    static_cast<float *>(out_d), static_cast<int *>(out_i),
                    static_cast<PoolKey *>(pool), n_rows, d, k, k_out, span,
                    n_ctas, n_blocks, 1.0f};
  if (!sizes_ok(a) || ctas < 0 || d < 8 || d % 8 != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_k<__nv_bfloat16, SRC_SAME, PROBE_NB>(a, n_ctas, ctas, loop,
                                                      cluster, s);
    case 1:
      return launch_k<__half, SRC_SAME, PROBE_NB>(a, n_ctas, ctas, loop,
                                                cluster, s);
    case 2:
      return launch_k<float, SRC_SAME, PROBE_NB>(a, n_ctas, ctas, loop,
                                               cluster, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
