"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface and are bound with ``ctypes``: every
``.cu`` file is compiled by its own ``nvcc`` process (all started
together), then linked into one shared library for ``sm_90a``.  The build
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
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points and their argument types (pointers and the stream as
# c_void_p, so ctypes never truncates a 64-bit address).
SIGNATURES = {
    # dtype codes, q, k_pages, v_pages, tables, lens, m, l, acc,
    # B, Hkv, G, D, num_pages, page_size, max_pages, ppb, num_splits, bps,
    # scale, window, softcap, kv_scale, stream
    "paged_decode_partials": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                              _F, _I, _F, _F, _P],
    # out dtype code, m, l, acc, out, B, Hkv, S, G, D, stream
    "combine_partials": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # dtype code, mask variant, q, k, v, o, kv_num_blocks, kv_indices,
    # is_full, lens, B, H, Hkv, Q, K, D, nq, max_kv, batched, q_blk,
    # kv_blk, q_len, kv_len, scale, stream
    "flex_attention_fwd": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _F, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: float = 0.0  # wall time of this process's build (0 = cached)


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


def _compile(target: Path) -> None:
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
        failed = []
        for src, p in procs:
            out, _ = p.communicate()
            if p.returncode:
                failed.append(f"{src.name}:\n{out.decode(errors='replace')}")
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


def get_lib() -> ctypes.CDLL:
    """The kernel library, built on first use (rebuilt when sources change)."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    target = BUILD_DIR / f"librepro_torch_{_digest()}.so"
    if not target.exists():
        t0 = time.perf_counter()
        _compile(target)
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
