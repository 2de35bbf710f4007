// Merge of a block's work items for Hopper (sm_90a): the second kernel of the
// flat worklist.
//
// Replaces the carry of the running top-k from one grid step of a block to
// the next in tpulmi/ops/pallas_topk.py::_kernel_flat. A TPU grid runs in
// order, so the worklist kernel there keeps a block's lists in scratch memory
// across the block's chunks. CUDA blocks run in no order: the item kernel
// (probe_wgmma.cuh on its persistent grid, or probe_common.cuh::probe_kernel
// with one CTA per item) carries a block's lists across the items that one
// CTA takes one after the other, a piece, and writes the sorted partial
// k-list of each of its 64 slots once per piece, to the scratch rows of the
// piece's first item, which it marks in `written`; this kernel merges the
// pieces of a block.
//
// What it computes. One CTA per block; one warp per slot row. The warp
// inserts the entries of the block's written items, in chunk order and in
// list order, into an empty list with the probe kernel's own insert (entries
// <= stay ahead, the gate is a strict <), so equal distances keep the lower
// store row and the result equals the one-CTA-per-block kernel's to the bit.
// The rows of an item that no piece starts are never written and never read.
// A block without items (an alignment block, dumped slots) and the one item
// of an empty probed bucket give rows of (10000, -1). With a rerank pool
// (k_out > k) the block's pool keys were folded together by the pieces'
// atomicMin; the warp appends the k_out - k best of them that are not in
// the merged top-k (probe_common.cuh::write_extras).
//
// What bounds it: bytes. It reads pieces * 64 * k * 8 bytes of partial lists
// once and writes blocks * 64 * k_out * 8; there is no arithmetic to speak
// of. The inserts are serial per slot, but a later piece rarely beats the
// running k-th best, so most entries cost one compare.

#include "probe_common.cuh"

namespace {

using namespace probe;

template <int KPL>
__global__ void __launch_bounds__(THREADS)
merge_items_kernel(const int *__restrict__ blocks,       // (n_blocks, 3)
                   const int *__restrict__ block_items,  // (n_blocks, 2):
                                                         // first item, items
                   const signed char *__restrict__ written,  // (n_items,)
                   const float *__restrict__ part_d,     // (n_items*QB, k)
                   const int *__restrict__ part_i,
                   const PoolKey *__restrict__ pool,       // (n_blocks*QB, POOL)
                   float *__restrict__ out_d,            // (n_blocks*QB, k_out)
                   int *__restrict__ out_i, int n_items, int k, int k_out) {
  __shared__ int ids[WARPS][32 * KPL];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t blk = blockIdx.x;
  const int nq = max(0, min(blocks[blk * 3 + 2], QB));
  const int first = block_items[blk * 2];
  // items past the scratch were dropped by the worklist kernel
  const int last = min(first + block_items[blk * 2 + 1], n_items);
  const float inf = __int_as_float(0x7f800000);

  for (int r = warp; r < QB; r += WARPS) {
    float L[KPL];
    int I[KPL];
#pragma unroll
    for (int s = 0; s < KPL; ++s) {
      L[s] = SENTINEL;
      I[s] = -1;
    }
    float th = SENTINEL;
    if (r < nq) {
      for (int it = first; it < last; ++it) {
        if (!written[it]) continue;
        const size_t base = (size_t(it) * QB + r) * k;
        for (int p0 = 0; p0 < k; p0 += 32) {
          const int p = p0 + lane;
          const float v = p < k ? part_d[base + p] : inf;
          const int id = p < k ? part_i[base + p] : -1;
          insert_candidates<KPL>(__ballot_sync(FULL, v < th), v, id, L, I, th,
                                 k);
        }
      }
    }
    const size_t orow = (blk * QB + r) * k_out;
#pragma unroll
    for (int s = 0; s < KPL; ++s) {
      const int p = lane * KPL + s;
      ids[warp][p] = I[s];
      if (p < k) {
        out_d[orow + p] = L[s];
        out_i[orow + p] = I[s];
      }
    }
    if (k_out > k) {
      __syncwarp();
      write_extras(pool + (blk * QB + r) * POOL, ids[warp], k, k_out,
                   out_d + orow, out_i + orow);
      __syncwarp();
    }
  }
}

template <int KPL>
int launch_merge(const void *blocks, const void *block_items,
                 const void *written, const void *part_d,
                 const void *part_i, const void *pool, void *out_d,
                 void *out_i, int n_blocks, int n_items, int k, int k_out,
                 cudaStream_t stream) {
  merge_items_kernel<KPL><<<n_blocks, THREADS, 0, stream>>>(
      static_cast<const int *>(blocks), static_cast<const int *>(block_items),
      static_cast<const signed char *>(written),
      static_cast<const float *>(part_d), static_cast<const int *>(part_i),
      static_cast<const PoolKey *>(pool), static_cast<float *>(out_d),
      static_cast<int *>(out_i), n_items, k, k_out);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int merge_items_block_slots() { return probe::QB; }

// Merge on `stream`: the partial lists (n_items * QB, k) of the work items
// that `written` (n_items,) marks, `block_items` (n_blocks, 2) = (first
// item, number of items) of each block, into out_d / out_i (n_blocks * QB,
// k_out); `pool` (n_blocks * QB, 128 keys) is read when k_out > k. Returns
// the CUDA error code (0 = ok).
int merge_items_launch(const void *blocks, const void *block_items,
                       const void *written, const void *part_d,
                       const void *part_i, const void *pool, void *out_d,
                       void *out_i, int n_blocks, int n_items, int k, int k_out,
                       void *stream) {
  if (n_blocks <= 0) return 0;
  if (k < 1 || k > 128 || k_out < k || k_out > probe::POOL ||
      written == nullptr || (k_out > k && pool == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (probe::kpl_of(k)) {
    case 1:
      return launch_merge<1>(blocks, block_items, written, part_d, part_i,
                             pool, out_d, out_i, n_blocks, n_items, k, k_out,
                             s);
    case 2:
      return launch_merge<2>(blocks, block_items, written, part_d, part_i,
                             pool, out_d, out_i, n_blocks, n_items, k, k_out,
                             s);
    default:
      return launch_merge<4>(blocks, block_items, written, part_d, part_i,
                             pool, out_d, out_i, n_blocks, n_items, k, k_out,
                             s);
  }
}

}  // extern "C"
