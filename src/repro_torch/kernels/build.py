"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface and are bound with ``ctypes``: every
``.cu`` file is compiled by its own ``nvcc`` process (all started
together), then linked into one shared library for ``sm_90a``.  The
tensor-core kernels build their TMA tensor maps per launch with libcuda's
``cuTensorMapEncodeTiled``, reached through the runtime's entry-point query,
so the link line needs no ``-lcuda``.  ``-Xptxas -v`` reports each kernel's
registers, shared memory and spills; the report is kept in ``build_log``.  The build
runs at first use, into ``src/repro_torch/_build/`` (ignored by git), and
the library name carries a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded.

Nothing here runs at import time: this module imports on hosts without
``nvcc`` or a GPU, where only the kernels' plain PyTorch versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

from repro_torch.errors import EngineConfigError, InternalError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_int64

# C entry points and their argument types (pointers and the stream as
# c_void_p, so ctypes never truncates a 64-bit address).
SIGNATURES = {
    # dtype codes, q, k_pages, v_pages, tables, lens, m, l, acc,
    # B, Hkv, G, D, num_pages, page_size, max_pages, ppb, num_splits, bps,
    # scale, window, softcap, kv_scale, stream
    "paged_decode_partials": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                              _F, _I, _F, _F, _P],
    # the decode op (K1, then K2): K1's arguments with the output after acc
    "paged_decode_attention": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                               _F, _I, _F, _F, _P],
    # K2: out dtype code, m, l, acc, out, B, Hkv, NQ, S, R, D, G, q_block,
    # C, the element strides of m and l (b, h, nq, s, r), of acc (the
    # same; d is 1) and of out (b, token, head; d is 1), stream
    "combine_partials": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, *[_L] * 13, _P],
    # compiled kind, q, k, v, o, kv_num_blocks, kv_indices, is_full, the
    # mask and score descriptor (host int64 words) and its length, B, H,
    # Hkv, Q, K, D, nq, max_kv, batched, q_blk, kv_blk, q_len, kv_len,
    # scale, stream: K4's routes, bf16 ("_tc") and f32 ("_tf32")
    "flex_attention_fwd_tc": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _F, _P],
    "flex_attention_fwd_tf32": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _F, _P],
    # K3's tiles, bf16 q ("_tc") and f32 q ("_tf32"): q, k_pages, v_pages,
    # blocked tables, kv_lens, q_start, m, l, acc, B, C, Hkv, G, D,
    # num_pages (the tensor map's rows), page_size, n_blocks, ppb,
    # num_splits, bps, q_block, scale, softcap, kv_scale (> 0: int8
    # pools), stream
    "paged_prefill_partials_tc": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _F, _F, _F, _P],
    "paged_prefill_partials_tf32": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                    _I, _I, _I, _F, _F, _F, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: float = 0.0  # wall time of this process's build (0 = cached)
build_log: str = ""  # nvcc's output of this process's build ("" = cached)


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise EngineConfigError("nvcc not found: the CUDA kernels are built "
                            "from source at first use on a CUDA host")


def _compile(target: Path) -> str:
    """Build the library at ``target``; returns nvcc's output."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed, logs = [], []
        for src, p in procs:
            out, _ = p.communicate()
            text = f"{src.name}:\n{out.decode(errors='replace')}"
            (failed if p.returncode else logs).append(text)
        if failed:
            raise EngineConfigError("nvcc failed\n" + "\n".join(failed))
        tmp_so = Path(tmp) / target.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o",
                               str(tmp_so), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode:
            raise EngineConfigError("nvcc link failed\n" + link.stdout
                                    + link.stderr)
        os.replace(tmp_so, target)  # atomic: concurrent builders agree
    return "\n".join(logs)


def library_path() -> Path:
    """Where the library of the current sources and flags is built."""
    return BUILD_DIR / f"librepro_torch_{_digest()}.so"


def get_lib() -> ctypes.CDLL:
    """The kernel library, built on first use (rebuilt when sources change)."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    target = library_path()
    if not target.exists():
        t0 = time.perf_counter()
        build_log = _compile(target)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(target))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` code from an entry point."""
    if err:
        raise InternalError(f"CUDA kernel {name} failed to launch "
                            f"(cudaError {err})", kernel=name, code=err)
