"""Build and load the port's hand-written CUDA kernels.

Each source under ``kokoro_tpu_torch/csrc/`` compiles with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``.  The build happens at first use, into ``kokoro_tpu_torch/build/``
(listed in ``.gitignore``); a library is named after the hash of its source
and flags, so an edited source builds anew and an unchanged one is reused.
Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

# library name -> source file under csrc/ (each includes the csrc/*.cuh headers)
SOURCES = {
    "packed_attention": "packed_attention.cu",
    "packed_attention_bwd": "packed_attention_bwd.cu",
    "flash_attention": "flash_attention.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the CUDA "
            "kernels are built on the machine with the card"
        )
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC_DIR / SOURCES[name]).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source that has no library yet, one ``nvcc`` process per
    source, all started together.  Returns ``{name: library path}``; the
    compiler's output (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside each library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in SOURCES}
    procs = {}
    for name, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp)
    failures = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        paths[name].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                path = build_all()[name]
            lib = ctypes.CDLL(str(path))
            _declare(name, lib)
            _loaded[name] = lib
        return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # dropout flag, threshold, 1/keep, seed
    dropout = [i, ctypes.c_uint32, f, ctypes.c_uint64]
    if name == "packed_attention":
        fn = lib.kokoro_packed_attention_fwd
        # q k v o res lse lens, B T H Dh, scale, causal dtype, dropout..., stream
        fn.argtypes = [p] * 7 + [i] * 4 + [f, i, i] + dropout + [p]
    elif name == "packed_attention_bwd":
        fn = lib.kokoro_packed_attention_bwd
        # q k v o res do lse delta dq dk dv lens, B T H Dh, scale, causal dtype, dropout...,
        # stream
        fn.argtypes = [p] * 12 + [i] * 4 + [f, i, i] + dropout + [p]
    elif name == "flash_attention":
        fn = lib.kokoro_flash_attention_fwd
        # q k v o lse q_seg kv_seg, B H Tq Tk Dh, scale, causal dtype, stream
        fn.argtypes = [p] * 7 + [i] * 5 + [f, i, i, p]
        # dtype, cluster size, clusters the card holds (a library built from an
        # earlier tree, which a probe may load, lacks it)
        if hasattr(lib, "kokoro_flash_attention_fwd_clusters"):
            lib.kokoro_flash_attention_fwd_clusters.argtypes = [i, i, ctypes.POINTER(i)]
            lib.kokoro_flash_attention_fwd_clusters.restype = i
        # past Dh 2048: q k v o lse q_seg kv_seg s_ws p_ws l_ws, B H Tq Tk Dh, scale,
        # causal dtype, stream; and the path's grid (Tq Tk Dh causal dtype, counts[5])
        if hasattr(lib, "kokoro_flash_attention_fwd_scores"):
            lib.kokoro_flash_attention_fwd_scores.argtypes = [p] * 10 + [i] * 5 + [f, i, i, p]
            lib.kokoro_flash_attention_fwd_scores.restype = i
            lib.kokoro_flash_attention_scores_grid.argtypes = [i] * 5 + [ctypes.POINTER(i)]
            lib.kokoro_flash_attention_scores_grid.restype = i
    elif name == "flash_attention_bwd":
        fn = lib.kokoro_flash_attention_bwd
        # q k v o do lse delta dq dk dv q_seg kv_seg, B H Tq Tk Dh, scale, causal dtype,
        # stream
        fn.argtypes = [p] * 12 + [i] * 5 + [f, i, i, p]
        # dtype, cluster size, clusters of the dQ and of the dK/dV kernel
        if hasattr(lib, "kokoro_flash_attention_bwd_clusters"):
            lib.kokoro_flash_attention_bwd_clusters.argtypes = [i, i] + [ctypes.POINTER(i)] * 2
            lib.kokoro_flash_attention_bwd_clusters.restype = i
        # past Dh 2048: q k v o do lse delta dq dk dv q_seg kv_seg p_ws ds_ws, B H Tq
        # Tk Dh, scale, causal dtype, stream
        if hasattr(lib, "kokoro_flash_attention_bwd_scores"):
            lib.kokoro_flash_attention_bwd_scores.argtypes = [p] * 14 + [i] * 5 + [f, i, i, p]
            lib.kokoro_flash_attention_bwd_scores.restype = i
    fn.restype = i
