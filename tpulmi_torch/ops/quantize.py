"""Int8 / packed-int4 row quantization for the bucket store.

Counterpart of ``tpulmi/ops/quantize.py``, in plain torch ops on the device
of the tensor given. A probe reads every row of each probed bucket once, so
store bytes are probe time: int8 codes halve a bfloat16 store, packed int4
codes halve it again. Symmetric per-row scales:

    q_i = round(x_i / s_i * L),  L = 127 (int8) or 7 (int4)
    cos(a, x_i) ~ (a . q_i) * s_i / L        (a kept in bf16/f32/int8)

int8: s_i = max|x_i|. int4: s_i = clip_i * max|x_i| with a per-row clip
factor chosen from ``INT4_CLIP_GRID`` to minimise that row's squared
reconstruction error (values past the clip saturate). The int4 cosine error
is an order above int8's, so int4 needs the exact host rerank
(`SearchConfig.rerank`) with a deeper candidate pool.

int4 codes are packed two per byte into an (N, d/2) int8 tensor: byte j of a
row holds dim j in its low nibble and dim j + d/2 in its high nibble, so
unpacking is two shifts and one concatenate, and the halves land in the
original dim order.

The operation order (``x / s * L``, not ``x * (L / s)``) is the JAX
package's: another order rounds some codes the other way.
"""

from dataclasses import replace
from typing import Tuple

import numpy as np
import torch

from tpulmi_torch.buckets import BucketStore

INT4_CLIP = 0.85
INT4_CLIP_GRID = (0.60, 0.65, 0.70, 0.75, 0.80, 0.85, 0.90, 0.95, 1.00)
_TINY = 1e-12


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization. Returns (q int8 (N, d),
    scales f32 (N,)) with x ~ q * (scales/127)[:, None]."""
    x = x.float()
    scales = torch.clamp(x.abs().amax(dim=1), min=_TINY)
    q = torch.clamp(torch.round(x / scales[:, None] * 127.0), -127, 127)
    return q.to(torch.int8), scales


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return q.float() * (scales / 127.0)[:, None]


def quantize_rows_int4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int4 quantization, packed two codes per byte, with
    the per-row clip factor picked from ``INT4_CLIP_GRID`` by reconstruction
    error. Returns (packed int8 (N, d/2), scales f32 (N,)) with
    x ~ unpack_int4(packed) * (scales/7)[:, None]. d must be even.

    Strict ``<`` keeps the first grid point on ties, so an all-zero padding
    row takes clip 0.6 with its scale clamped to 1e-12 and code 0."""
    x = x.float()
    maxabs = x.abs().amax(dim=1)
    best_err = torch.full_like(maxabs, float("inf"))
    best_scale = torch.zeros_like(maxabs)
    for clip in INT4_CLIP_GRID:
        s = torch.clamp(maxabs * clip, min=_TINY)
        q = torch.clamp(torch.round(x / s[:, None] * 7.0), -8, 7)
        err = ((q * (s / 7.0)[:, None] - x) ** 2).sum(dim=1)
        upd = err < best_err
        best_err = torch.where(upd, err, best_err)
        best_scale = torch.where(upd, s, best_scale)
    scales = torch.clamp(best_scale, min=_TINY)
    q = torch.clamp(torch.round(x / scales[:, None] * 7.0), -8, 7)
    return pack_int4(q.to(torch.int8)), scales


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack int4 codes (N, d) in [-8, 7] into (N, d/2) int8: byte j holds
    dim j (low nibble) and dim j + d/2 (high nibble)."""
    d = codes.shape[-1]
    if d % 2:
        raise ValueError(f"int4 packing needs even d, got {d}")
    lo = codes[..., : d // 2].to(torch.uint8) & 0xF
    hi = codes[..., d // 2:].to(torch.uint8) & 0xF
    return (lo | (hi << 4)).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Unpack (..., d/2) int8 bytes into (..., d) int4 codes as int8, in
    the original dim order; both nibbles are sign-extended."""
    b = packed.to(torch.int32)
    lo = ((b & 0xF) ^ 8) - 8
    hi = b >> 4
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def quantize_rows_int4_host(x: np.ndarray):
    """NumPy twin of `quantize_rows_int4` (same per-row adaptive clip, same
    operation order) for host-side layouts. Returns (packed int8 (N, d/2),
    scales f32 (N,)).

    Codes match `quantize_rows_int4` bit for bit where the float32 error
    sum is taken in numpy's order. Where a backend sums in another order, a
    row whose two best grid points lie within rounding of each other may
    pick the neighbouring clip; codes and scale then differ for that row.
    Both picks reconstruct it equally well, and a store only needs its
    scales to match the codes they ship with."""
    x = np.asarray(x, dtype=np.float32)
    n, d = x.shape
    out_codes = np.empty((n, d // 2), np.int8)
    out_scales = np.empty((n,), np.float32)
    # Blocked: the 9-point search allocates ~4 block-sized float32
    # temporaries per grid point; 128k-row blocks bound that transient for
    # identical results (the sweep is row-wise).
    block = 131072
    for blo in range(0, n, block):
        bhi = min(blo + block, n)
        xb = x[blo:bhi]
        maxabs = np.abs(xb).max(axis=1)
        best_err = np.full(xb.shape[0], np.inf, np.float32)
        best_scale = np.zeros(xb.shape[0], np.float32)
        for clip in INT4_CLIP_GRID:
            s = np.maximum(maxabs * np.float32(clip), np.float32(_TINY))
            q = np.clip(np.rint(xb / s[:, None] * np.float32(7.0)), -8, 7)
            err = ((q * (s / np.float32(7.0))[:, None] - xb) ** 2).sum(
                axis=1, dtype=np.float32)
            upd = err < best_err
            best_err = np.where(upd, err, best_err)
            best_scale = np.where(upd, s, best_scale)
        scales = np.maximum(best_scale, np.float32(_TINY))
        q = np.clip(np.rint(xb / scales[:, None] * 7.0), -8, 7).astype(
            np.int8)
        lo = q[:, : d // 2].astype(np.uint8) & 0xF
        hi = q[:, d // 2:].astype(np.uint8) & 0xF
        out_codes[blo:bhi] = (lo | (hi << 4)).astype(np.int8)
        out_scales[blo:bhi] = scales
    return out_codes, out_scales


def int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` of integer codes, exact, as float32 (the int32 sum cast
    to float32). Integer `matmul` is not there for every device, so the
    product runs in floating point where every partial sum is exact:
    float32 while 127 * 127 * d < 2**24, float64 past that."""
    d = int(a.shape[-1])
    wide = torch.float32 if 127 * 127 * d < 2 ** 24 else torch.float64
    return (a.to(wide) @ b.to(wide).T).float()


def cosine_dists_int8(q_queries: torch.Tensor, s_queries: torch.Tensor,
                      q_data: torch.Tensor, s_data: torch.Tensor
                      ) -> torch.Tensor:
    """Cosine distances between int8-quantized normalized vectors: the
    exact integer dot, then both scales."""
    acc = int_dot(q_queries, q_data)
    sims = acc * (s_queries[:, None] / 127.0) * (s_data[None, :] / 127.0)
    return 1.0 - sims


def quantize_store(store: BucketStore, bits: int = 8) -> BucketStore:
    """Quantize a full-precision bucket store to int8 (``bits=8``) or
    packed int4 (``bits=4``) codes + per-row float32 scales, on the store's
    device. The layout (ids, offsets, counts, alignment) is unchanged.
    Padding rows (all zero) get scale 1e-12 and code 0: their similarity is
    0, and they lie outside every bucket's row range anyway. Pruning bounds
    are dropped, as in the JAX package: compute them again on the codes."""
    if bits not in (8, 4):
        raise ValueError(f"quantize_store supports bits in (8, 4), got {bits}")
    if store.is_quantized:
        if store.quant_bits != bits:
            raise ValueError(
                f"store is already int{store.quant_bits}; re-quantizing to "
                f"int{bits} would compound the quantization error: rebuild "
                f"from the full-precision source instead")
        return store
    if bits == 4:
        codes, scales = quantize_rows_int4(store.data_sorted)
    else:
        codes, scales = quantize_rows(store.data_sorted)
    return replace(store, data_sorted=codes, scales=scales, quant_bits=bits,
                   _casts={}, bucket_centroids=None, bucket_cos_r=None,
                   bucket_max_norm=None)
