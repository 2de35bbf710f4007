"""Builds the CUDA sources in tpulmi_torch/csrc with nvcc and loads them with
ctypes.

Each library is compiled at first use into ``tpulmi_torch/_build/`` (listed
in .gitignore) as a shared library with a plain C interface, named by a hash
of the source, the headers beside it and the flags, so an edited source is
rebuilt and an unchanged one is reused. A source may give several libraries
that differ in a ``-D`` flag: the probe sources are built for tiles of 64
store rows and, as ``*_pair``, of 128. Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# library name -> (source name, extra nvcc flags)
LIBRARIES = {
    "probe_topk": ("probe_topk", ()),
    "probe_topk_pair": ("probe_topk", ("-DPROBE_NB=128",)),
    "probe_topk_quant": ("probe_topk_quant", ()),
    "probe_topk_quant_pair": ("probe_topk_quant", ("-DPROBE_NB=128",)),
    "merge_items": ("merge_items", ()),
    "rerank_card": ("rerank_card", ()),
}

# C signatures of every entry point, by source name
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _probe_signatures(source: str, launch_args, n_codes: int) -> dict:
    """`n_codes`: the type codes of the entry points (query type; code
    width of a quantized store)."""
    return {f"{source}_launch": (launch_args, _I),
            f"{source}_block_slots": ([], _I),
            f"{source}_tile_rows": ([], _I),
            # type codes, d, k, pool -> main loop
            f"{source}_loop": ([_I] * (n_codes + 3), _I),
            # loop, type codes, d, k, pool -> bytes
            f"{source}_smem_bytes": ([_I] * (n_codes + 4), _LL),
            # type codes, d, k, pool, worklist -> CTAs of a cluster
            f"{source}_cluster": ([_I] * (n_codes + 4), _I)}


SIGNATURES = {
    # q, qidx, data, blocks, items, block_items, written, out_d, out_i,
    # pool, n_ctas, ctas, n_blocks, d, n_rows, k, k_out, span, dtype, loop,
    # cluster, stream
    "probe_topk": _probe_signatures(
        "probe_topk", [_P] * 10 + [_I] * 4 + [_LL] + [_I] * 6 + [_P], 1),
    # q, qidx, codes, scales, blocks, items, block_items, written, out_d,
    # out_i, pool, n_ctas, ctas, n_blocks, d, n_rows, k, k_out, span, qdtype,
    # bits, loop, cluster, stream
    "probe_topk_quant": _probe_signatures(
        "probe_topk_quant", [_P] * 11 + [_I] * 4 + [_LL] + [_I] * 7 + [_P],
        2),
    # blocks, block_items, written, part_d, part_i, pool, out_d, out_i,
    # n_blocks, n_items, k, k_out, stream
    "merge_items": {
        "merge_items_launch": ([_P] * 8 + [_I, _I, _I, _I, _P], _I),
        "merge_items_block_slots": ([], _I),
    },
    # corpus, ids, ids_64, queries, out_d, out_i, q, k_eff, k, d, n_rows,
    # normalize, stream
    "rerank_card": {
        "rerank_card_launch": ([_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _LL,
                                _I, _P], _I),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time, "log": nvcc/ptxas output}; empty entry
# when the library was already built
build_info: Dict[str, dict] = {}


def nvcc_path() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME)")


def library_path(name: str) -> Path:
    source, flags = LIBRARIES[name]
    digest = hashlib.sha256((CSRC / f"{source}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + flags).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile the named libraries that are not built yet, one nvcc process
    per library, all started together. Returns each library's path."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    start = time.perf_counter()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        source, flags = LIBRARIES[n]
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp),
             str(CSRC / f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_info[n] = {"seconds": time.perf_counter() - start, "log": out}
        if proc.returncode != 0:
            failed.append(f"{n}:\n{out}")
            continue
        os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The built library `name`, with argtypes and restype set."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn, (args, res) in SIGNATURES[LIBRARIES[name][0]].items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = res
            _libs[name] = lib
        return lib
