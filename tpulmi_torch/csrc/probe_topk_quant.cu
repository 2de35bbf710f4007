// Fused cosine-distance + running top-k probe kernels over a quantized
// store, for Hopper (sm_90a).
//
// Replaces the quantized branches of tpulmi/ops/pallas_topk.py::_kernel_core:
//
//   - store of int8 codes or packed int4 codes with bfloat16 / float16 /
//     float32 queries (the `quantized` and `packed` branches): the codes are
//     converted to the queries' type while they are staged into shared
//     memory (every code is exact in each type), the product runs as for a
//     full-precision store, and each column is scaled by
//     scales[row] / q_levels (127 or 7) before 1 - s;
//   - int8 x int8 (the `int8q` branch): the queries arrive as int8 codes,
//     the product runs on the tensor cores with int32 sums, and each sum is
//     cast to float32 and scaled the same way. The query's own scale stays
//     out of the kernel, as on the TPU: it is positive and constant per
//     slot, so it changes no ranking, and the wrapper
//     (tpulmi_torch/ops/probe_topk.py) applies it to the final lists.
//
// Design. The CTA design of probe_topk.cu (one CTA per 64-slot block looping
// over its bucket's rows, vote-gated insert into a sorted list, ties to the
// lower store row), in its two main loops (csrc/probe_common.cuh::loop_of
// chooses); this file instantiates them for the two code layouts and the
// four query types:
//
//   - bfloat16 and float16 queries: probe_wgmma.cuh. The TMA ring carries the
//     raw code bytes (64 or 32 a row and slice of 64 features); four
//     converter warps turn each raw stage into an operand stage of the
//     queries' type in wgmma's swizzled layout, beside the warpgroup that
//     multiplies, so the conversion is off both the load and the product.
//     The tile's column scales are read once per tile by each consumer warp;
//   - int8 queries: probe_wgmma.cuh too, with wgmma m64nNBk32 s8 x s8 and
//     int32 sums over slices of 128 features. Over int8 codes the codes are
//     the B operand as they lie: TMA lands them swizzled in the operand ring
//     and no warp converts them. Over packed int4 a raw box of 64 bytes a
//     row holds 128 features, and four converter warps sign-extend its
//     nibbles into int8 bytes with masks and a multiply. Integer sums are
//     exact, so the result equals the staged loop's to the bit;
//   - float32 queries, and shapes whose resident queries do not fit:
//     probe_common.cuh::probe_kernel, which converts the codes while it
//     stages them (int8 queries there: IMmaTile, WMMA 16x16x16 with int32
//     sums, which stays as the reference of the wgmma loop).
//
// What the TPU kernel needed and neither loop does: scales fed as
// (mc/128, 128) tiles, mc % 1024 == 0, int32 shifts for the nibbles. A packed
// byte j holds dim j in the low and dim j + d/2 in the high nibble; the
// staged loop splits it where it is staged (a vector of 4, 8 or 16
// neighbouring features lies in one nibble of as many neighbouring bytes),
// the wgmma loop takes both nibbles of 32 (or, under int8 queries, 64)
// bytes as one slice and gathers the resident queries in the same order.
//
// Limits. k <= 128; int8 codes need d % 16 == 0 (16-byte row loads of the
// int8 queries, the tensor map's row stride), packed int4 d % 32 == 0 (so
// that d/2 keeps that alignment).
//
// What bounds it. Each probed bucket's codes are read once (half or a
// quarter of a bfloat16 store's bytes) and 2 d slots rows operations done on
// them; at the 300K x 768 shape with bfloat16 queries the operations at the
// bf16 tensor-core rate are the larger bound, with int8 queries the two are
// of one order. The wgmma loop makes the fewer bytes count: the ring moves
// a half or a quarter of the bytes per tile, and what is left is the
// re-read of a bucket per 64-slot block (from L2) and, where there are
// converters, their shared-memory traffic.
//
// Like probe_topk.cu this file is compiled twice, for tiles of 64 store rows
// and, with -DPROBE_NB=128, for the paired tile; both run the worklist and
// the rerank pool of the header.

#include "probe_common.cuh"

#ifndef PROBE_NB
#define PROBE_NB 64
#endif

namespace {

using namespace probe;

template <typename T>
int launch_src(ProbeArgs a, int n_ctas, int ctas, int bits, int loop,
               int cluster, cudaStream_t s) {
  if (bits == 8) {
    a.levels = 127.0f;
    return launch_k<T, SRC_INT8, PROBE_NB>(a, n_ctas, ctas, loop, cluster, s);
  }
  a.levels = 7.0f;
  return launch_k<T, SRC_INT4, PROBE_NB>(a, n_ctas, ctas, loop, cluster, s);
}

int query_bytes(int qdtype) { return qdtype == 2 ? 4 : (qdtype == 3 ? 1 : 2); }
int src_of(int bits) { return bits == 4 ? SRC_INT4 : SRC_INT8; }

}  // namespace

extern "C" {

// Slots per block: the wrapper lays slots out in blocks of this size.
int probe_topk_quant_block_slots() { return probe::QB; }

int probe_topk_quant_tile_rows() { return PROBE_NB; }
// The main loop that a launch of these sizes takes (0 staged, 1 wgmma), and
// the shared memory one CTA of a loop takes.
int probe_topk_quant_loop(int qdtype, int bits, int d, int k, int pool) {
  return probe::loop_of(query_bytes(qdtype), src_of(bits), d, k, pool != 0,
                        PROBE_NB);
}
long long probe_topk_quant_smem_bytes(int loop, int qdtype, int bits, int d,
                                      int k, int pool) {
  return (long long)probe::loop_smem_bytes(loop, query_bytes(qdtype),
                                           src_of(bits), d, k, pool != 0,
                                           PROBE_NB);
}
// The CTAs of a cluster that a launch of these sizes takes by the rule, as
// probe_topk_cluster.
int probe_topk_quant_cluster(int qdtype, int bits, int d, int k, int pool,
                             int worklist) {
  return probe::cluster_of(probe_topk_quant_loop(qdtype, bits, d, k, pool),
                           PROBE_NB, worklist != 0);
}

// Launch on `stream`; `n_ctas`, `items`, `block_items`, `written`, `ctas`,
// `n_blocks`, `pool`, `k_out` and `span` as in probe_topk_launch.
// `qdtype` is the type of q: 0 bfloat16, 1 float16, 2 float32, 3 int8 codes
// (int8 x int8). `bits` is the store's code width: 8 (codes is (n_rows, d)
// int8) or 4 (codes is (n_rows, d/2) packed bytes). `d` is the logical
// width; `loop` and `cluster` as in probe_topk_launch. Returns the CUDA
// error code (0 = ok).
int probe_topk_quant_launch(const void *q, const void *qidx,
                            const void *codes, const void *scales,
                            const void *blocks, const void *items,
                            const void *block_items, void *written,
                            void *out_d, void *out_i, void *pool, int n_ctas,
                            int ctas, int n_blocks, int d, long long n_rows,
                            int k, int k_out, int span, int qdtype, int bits,
                            int loop, int cluster, void *stream) {
  if (n_ctas <= 0) return 0;
  const ProbeArgs a{q, static_cast<const int *>(qidx), codes,
                    static_cast<const float *>(scales),
                    static_cast<const int *>(blocks),
                    static_cast<const int *>(items),
                    static_cast<const int *>(block_items),
                    static_cast<signed char *>(written),
                    static_cast<float *>(out_d), static_cast<int *>(out_i),
                    static_cast<PoolKey *>(pool), n_rows, d, k, k_out, span,
                    n_ctas, n_blocks, 1.0f};
  if (!sizes_ok(a) || ctas < 0 || (bits != 8 && bits != 4) || d < 16 ||
      d % (bits == 4 ? 32 : 16) != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (qdtype) {
    case 0:
      return launch_src<__nv_bfloat16>(a, n_ctas, ctas, bits, loop, cluster,
                                       s);
    case 1:
      return launch_src<__half>(a, n_ctas, ctas, bits, loop, cluster, s);
    case 2:
      return launch_src<float>(a, n_ctas, ctas, bits, loop, cluster, s);
    case 3:
      return launch_src<signed char>(a, n_ctas, ctas, bits, loop, cluster, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
