"""Host C++ kernels (``csrc/layout.cpp``), built with g++ and bound with
ctypes: the counterpart of the JAX package's native library.

- ``scatter_rows``: gather rows ``src[order[i]]``, L2-normalize them (unless
  ``normalized``), convert to the store's dtype (float32, bfloat16 or int8
  with per-row scales) and write them to ``dst[pos[i]]``, on several
  threads: the host-side store layout of `tpulmi_torch.hoststore`.
- ``rerank_dot``: ``sims[i, j] = queries[i] . corpus[max(ids[i, j], 0)]``,
  each candidate row read once and dotted on the fly (F16C/FMA where the
  host has them): the exact host rerank of `LearnedIndex._rerank_host`.

``layout.cpp`` is the JAX package's source byte for byte, and it is built
with the same flags (``-O3 -march=native -shared -fPIC -pthread
-std=c++17``, then without ``-march=native`` where the compiler refuses
it), so that both libraries compute the same bits on one host. The library
is compiled at first use into ``tpulmi_torch/_build/`` (git-ignored), named
by a hash of the source, the flags and the host's CPU (``-march=native``
code runs only where it was built), to a temporary name that is then
moved into place, so that processes building at once never load a
half-written file. Nothing is built at import time. Where no compiler or
library is at hand, `available()` is false and the callers take their numpy
paths; once the library has loaded, its calls are never retried in numpy.

Inputs: numpy float32 / float16 arrays, and bfloat16 arrays as
`tpulmi_torch.hoststore.HostBF16` (uint16 bit patterns, dtype code 2).
``calls`` counts the calls of each entry point.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from tpulmi_torch.utils.logging import get_logger

log = get_logger("tpulmi_torch.native")

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "layout.cpp"
BUILD_DIR = _PKG / "_build"
# the JAX package's g++ command, in its order; -march=native goes after -O3
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
_DTYPE_CODES = {"float32": 0, "float16": 1, "bfloat16": 2, "int8": 3}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # src, src_dtype, order, pos, dst, dst_dtype, scales, ids, n, d,
    # normalize, threads
    "tpulmi_scatter_rows": [_P, _I, _P, _P, _P, _I, _P, _P, _LL, _LL, _I, _I],
    # corpus, corpus_dtype, ids, queries, out_sims, q, k_eff, d, n_rows,
    # normalize, threads
    "tpulmi_rerank_dot": [_P, _I, _P, _P, _P, _LL, _LL, _LL, _LL, _I, _I],
}


def host_cpu() -> str:
    """The host's CPU model and its feature flags, from /proc/cpuinfo
    ("" where there is none)."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return ""
    found = {}
    for line in text.splitlines():
        key, _, value = line.partition(":")
        key = key.strip()
        if key in ("model name", "flags") and key not in found:
            found[key] = value.strip()
    return f"{found.get('model name', '')} | {found.get('flags', '')}"


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    digest.update(host_cpu().encode())
    return BUILD_DIR / f"layout_{digest.hexdigest()[:12]}.so"


def _threads(n_threads: int) -> int:
    return n_threads if n_threads > 0 else min(os.cpu_count() or 1, 32)


def _code(arr):
    """The library's dtype code of a host array (HostBF16: 2), or None."""
    return _DTYPE_CODES.get(str(arr.dtype))


def _data(arr):
    """The array the library reads: a HostBF16's bit patterns, else the
    array itself."""
    return getattr(arr, "bits", arr)


class _NativeLayout:
    def __init__(self):
        self._lib = None
        self._tried = False
        self._lock = threading.Lock()
        self.calls = {"scatter_rows": 0, "rerank_dot": 0}
        # the library's build: {"seconds", "flags", "path"}; empty when it
        # was already built
        self.build_info = {}

    def _compile(self, so: Path) -> None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        base = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        start = time.perf_counter()
        flags = base[:2] + ["-march=native"] + base[2:]
        try:
            subprocess.run(flags, check=True, capture_output=True,
                           timeout=120)
        except subprocess.CalledProcessError:
            flags = base
            subprocess.run(base, check=True, capture_output=True,
                           timeout=120)
        os.replace(tmp, so)
        self.build_info = {"seconds": time.perf_counter() - start,
                           "flags": " ".join(flags[1:-3]), "path": str(so)}
        log.info("compiled the native layout library: %s", so)

    def _load(self):
        with self._lock:
            if self._tried:
                return self._lib
            self._tried = True
            try:
                so = library_path()
                if not so.exists():
                    self._compile(so)
                lib = ctypes.CDLL(str(so))
                for name, args in _SIGNATURES.items():
                    getattr(lib, name).argtypes = args
                    getattr(lib, name).restype = ctypes.c_int
                self._lib = lib
            except (OSError, subprocess.SubprocessError) as e:
                log.info("native layout library unavailable (%s); numpy "
                         "paths", e)
                self._lib = None
            return self._lib

    def available(self) -> bool:
        """Whether the library is built and loaded (builds it once)."""
        return self._load() is not None

    def reset_calls(self) -> None:
        for name in self.calls:
            self.calls[name] = 0

    def scatter_rows(self, src, order, pos, dst, scales=None, ids=None, *,
                     normalized: bool = False, n_threads: int = 0) -> None:
        """Gather rows ``src[order[i]]``, L2-normalize (unless
        `normalized`), convert to ``dst``'s dtype, write to ``dst[pos[i]]``
        (and per-row scales for an int8 ``dst``). ``src`` is float32,
        float16 or HostBF16; ``dst`` a C-contiguous float32 or int8 array
        or HostBF16."""
        lib = self._load()
        if lib is None:
            raise RuntimeError("native layout library unavailable")
        src_code, dst_code = _code(src), _code(dst)
        if src_code in (None, 3) or dst_code in (None, 1):
            raise ValueError(f"unsupported dtypes {src.dtype} -> {dst.dtype}")
        src, dst_bits = np.ascontiguousarray(_data(src)), _data(dst)
        if not dst_bits.flags["C_CONTIGUOUS"]:
            raise ValueError("the destination must be C-contiguous")
        order = np.ascontiguousarray(order, np.int32)
        pos = np.ascontiguousarray(pos, np.int64)
        self.calls["scatter_rows"] += 1
        rc = lib.tpulmi_scatter_rows(
            src.ctypes.data, src_code, order.ctypes.data, pos.ctypes.data,
            dst_bits.ctypes.data, dst_code,
            scales.ctypes.data if scales is not None else None,
            ids.ctypes.data if ids is not None else None,
            order.shape[0], src.shape[1], 0 if normalized else 1,
            _threads(n_threads))
        if rc != 0:
            raise RuntimeError(f"native scatter_rows failed (rc={rc})")

    def rerank_dot(self, corpus, ids, queries, *, normalized: bool = True,
                   n_threads: int = 0) -> np.ndarray:
        """``sims[i, j] = queries[i] . corpus[max(ids[i, j], 0)]`` (rows
        L2-normalized on the fly unless `normalized`), float32 (Q, K).
        ``corpus`` is a C-contiguous float32 or float16 array or HostBF16."""
        lib = self._load()
        if lib is None:
            raise RuntimeError("native rerank library unavailable")
        bits, code = _data(corpus), _code(corpus)
        if code in (None, 3):
            raise ValueError(f"unsupported rerank corpus dtype {corpus.dtype}")
        if not bits.flags["C_CONTIGUOUS"]:
            raise ValueError("the rerank corpus must be C-contiguous")
        ids = np.ascontiguousarray(ids, np.int64)
        queries = np.ascontiguousarray(queries, np.float32)
        q, k_eff = ids.shape
        d = corpus.shape[1]
        if queries.shape != (q, d):
            raise ValueError(f"queries {queries.shape} for ids {ids.shape} "
                             f"over rows of {d}")
        out = np.empty((q, k_eff), np.float32)
        self.calls["rerank_dot"] += 1
        rc = lib.tpulmi_rerank_dot(
            bits.ctypes.data, code, ids.ctypes.data, queries.ctypes.data,
            out.ctypes.data, q, k_eff, d, corpus.shape[0],
            0 if normalized else 1, _threads(n_threads))
        if rc != 0:
            raise RuntimeError(f"native rerank_dot failed (rc={rc})")
        return out


native_layout = _NativeLayout()
