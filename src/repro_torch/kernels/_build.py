"""Build ``csrc/*.cu`` into one shared library and load it with ctypes.

Each source compiles to an object with its own ``nvcc`` process, all
started together, and the objects link into
``_build/libocean_kernels_<digest>.so``, named by a hash of the sources and
flags, so a changed source rebuilds and an unchanged one loads at once.
The C entry points take raw device pointers, ints and the CUDA stream and
return ``cudaGetLastError()``. A failed build raises with nvcc's output;
nothing falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
SRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
U = ctypes.c_uint
LL = ctypes.c_longlong

# argtypes of every C entry point (pointers and the stream as c_void_p,
# so ctypes never truncates them to 32 bits)
SIGNATURES = {
    "ocean_dense_slab": (P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, P),
    "ocean_longrow_max_cap": (I, P),
    "ocean_hash_slab": (P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P),
    "ocean_hash_blocks_per_sm": (I, I, I, P),
    "ocean_hll_merge": (P, P, P, P, P, I, I, I, F, P),
    "ocean_hll_sketch": (P, P, P, P, I, LL, I, I, U, I, P),
    "ocean_hll_sketch_blocks_per_sm": (I, I, P),
    "ocean_count_bin": (P, P, P, P, P, P, P, I, I, I, I, P),
    "ocean_count_rows": (P, P, P, P, P, P, P, I, I, I, I, P),
    "ocean_count_rows_blocks_per_sm": (I, P),
    "ocean_slab_scatter": (P, P, P, P, LL, P, P, P, P, I, P),
    "ocean_pattern_fingerprint": (P, LL, I) * 4 + (P, I, P),
}

_lock = threading.Lock()
_lib = None
BUILD_SECONDS = None   # wall seconds of this process's build (None: loaded)
BUILD_LOG = ""         # ptxas register/shared-memory report of the build


class KernelBuildError(RuntimeError):
    """nvcc was missing or failed; the message carries its output."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels are "
        "built from source at first use")


def _digest(sources) -> str:
    h = hashlib.blake2b(digest_size=8)
    h.update(repr(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()


def _compile(sources, target: Path) -> str:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for cmd, obj, proc in procs:
            out, _ = proc.communicate()
            log.append(f"$ {' '.join(cmd)}\n{out}")
            if proc.returncode != 0:
                failed.append(obj.stem)
        if failed:
            raise KernelBuildError(
                f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp_so = Path(tmp) / target.name
        cmd = [nvcc, "-shared", "-o", str(tmp_so),
               *[str(o) for _, o, _ in procs]]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise KernelBuildError(f"nvcc link failed:\n{res.stdout}")
        os.replace(tmp_so, target)
    return "\n".join(log)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, BUILD_SECONDS, BUILD_LOG
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(SRC_DIR.glob("*.cu"))
        if not sources:
            raise KernelBuildError(f"no CUDA sources under {SRC_DIR}")
        target = BUILD_DIR / f"libocean_kernels_{_digest(sources)}.so"
        if not target.exists():
            t0 = time.perf_counter()
            BUILD_LOG = _compile(sources, target)
            BUILD_SECONDS = time.perf_counter() - t0
        lib = ctypes.CDLL(str(target))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` with ``device`` current and that device's
    current stream as the last argument; raise on a CUDA error."""
    fn = getattr(library(), name)
    with torch.cuda.device(device):
        status = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {status}")
