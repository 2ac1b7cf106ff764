"""HyperLogLog sketch construction, and merge + estimate per A row.

Sketches are one byte a register (``torch.uint8``) on every device: a
register holds at most ``32 - log2(m) + 1 <= 28``, and the paper's cost model
counts one byte a register. The reference's registers are int32; the plain
versions compute in int32 as it does and the wrappers return bytes.

:func:`hll_sketch` is the port of the Pallas ``hll_sketch``
(``repro/kernels/hll.py:64``): for CUDA tensors it launches the kernel in
``csrc/hll_sketch.cu``, which reads B's CSR directly, in chunks of equal
weight over the rows and the ids; for CPU tensors it runs
``core.hll.sketch_registers_impl``. Both hash with the seeded
``core.hll.hash32``, so at seed 0 they equal the Pallas kernel.

:func:`hll_merge` is the port of the Pallas ``hll_merge``
(``repro/kernels/hll.py:108``). For CUDA tensors it launches the kernel in
``csrc/hll_merge.cu``, which reads A's CSR directly and folds 4 registers a
lane with ``__vmaxu4``; for CPU tensors it runs :func:`hll_merge_plain`
(``core.hll.merge_sketches`` + ``estimate_cardinality``). Both return
``(merged (RA, m) uint8, est (RA,) f32)``; the caller clips ``est``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core import hll as chll
from ..obs.metrics import count_launch
from . import _build

# Column ids a thread of the sketch kernel loads at once (two 16-byte loads):
# a chunk of the sketch kernel weighs this many keys a thread, a row its ids
# plus m/4 keys.
SKETCH_IDS_A_THREAD = 8
# Block sizes the sketch kernel may launch with (its ``__launch_bounds__``
# is the largest): powers of two, so that a chunk's keys are one too.
SKETCH_BLOCK_THREADS = (128, 256)


def _check(pairs, device, dtype) -> None:
    for name, x in pairs:
        if x.device != device:
            raise ValueError(f"{name} on {x.device}, expected {device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _aligned(x):
    """``x``, or a copy of it when it does not start on a 16-byte boundary:
    the kernels load and store 16 bytes at a time."""
    return x.clone() if x.data_ptr() % 16 else x


def _check_m(m_regs: int, cuda: bool) -> None:
    if m_regs <= 0 or m_regs > 128 or m_regs & (m_regs - 1):
        raise ValueError(f"m_regs {m_regs} must be a power of two <= 128")
    if cuda and m_regs < 32:
        raise ValueError(f"the CUDA kernels take m_regs 32, 64 or 128, got "
                         f"{m_regs}")


def sketch_chunks(n_ids: int, rows: int, threads: int, m_regs: int) -> int:
    """Chunks (blocks) of the sketch kernel for ``rows`` rows and ``n_ids``
    ids."""
    keys = n_ids + rows * (m_regs // 4)
    return -(-keys // (threads * SKETCH_IDS_A_THREAD))


def sketch_launch_shape(m_regs: int, blocks_per_sm) -> int:
    """Threads a block of the sketch kernel: the block size that lets an SM
    hold the most threads at once, the smallest such. ``blocks_per_sm(
    threads)`` is how many such blocks (with the shared memory the kernel
    takes for that size: a chunk's row offsets and an int a register of
    each of its rows) one SM holds at once, 0 when one cannot launch: on
    the card the CUDA occupancy API's answer for the kernel as built
    (:func:`sketch_launch_shape_on`)."""
    best = None
    for threads in SKETCH_BLOCK_THREADS:
        held = threads * blocks_per_sm(threads)
        if held and (best is None or held > best[1]):
            best = (threads, held)
    if best is None:
        raise ValueError(f"no block of the sketch kernel at m {m_regs} fits "
                         "an SM")
    return best[0]


@functools.lru_cache(maxsize=None)
def sketch_launch_shape_on(device_index: int, m_regs: int) -> int:
    """:func:`sketch_launch_shape` on CUDA device ``device_index``, from the
    occupancy API (``ocean_hll_sketch_blocks_per_sm``)."""
    fn = _build.library().ocean_hll_sketch_blocks_per_sm

    def blocks_per_sm(threads):
        out = ctypes.c_int(0)
        with torch.cuda.device(device_index):
            status = fn(m_regs, threads, ctypes.addressof(out))
        if status != 0:
            raise RuntimeError("CUDA occupancy query failed: cudaError "
                               f"{status}")
        return out.value

    return sketch_launch_shape(m_regs, blocks_per_sm)


def hll_sketch(indptr, indices, *, m_regs: int, seed: int = 0, out=None):
    """Registers of every row of a CSR pattern: (R, m_regs) uint8, where
    R = len(indptr) - 1, written into ``out`` when it is given (a contiguous
    (R, m_regs) uint8 tensor on the same device) and returned.
    ``m_regs`` is a power of two, at most 128, and on the card at least 32.
    The ids are ``indices[indptr[r]: indptr[r + 1]]``; ``indices`` holds at
    least ``indptr[R]`` of them, and its length sizes the sketch kernel's
    launch, so pass the valid ids, not a padded capacity. On the card one
    launch (one count in ``kernel.launches{kernel=hll_sketch}``) is two
    kernels: the chunks' bounds, then the sketch."""
    _check_m(m_regs, indptr.device.type == "cuda")
    r = indptr.shape[0] - 1
    if out is not None and (out.shape != (r, m_regs)
                            or out.dtype != torch.uint8):
        raise ValueError(f"out must be ({r}, {m_regs}) uint8, got "
                         f"{tuple(out.shape)} {out.dtype}")
    if indptr.device.type == "cpu":
        regs = chll.sketch_registers_impl(indptr, indices, m_regs, r, seed)
        return regs.to(torch.uint8) if out is None else out.copy_(regs)
    dev = indptr.device
    _check((("indptr", indptr), ("indices", indices)), dev, torch.int32)
    if out is None:
        out = torch.empty((r, m_regs), dtype=torch.uint8, device=dev)
    _check((("out", out),), dev, torch.uint8)
    if r == 0:
        return out
    indices = _aligned(indices)
    regs = torch.empty_like(out) if out.data_ptr() % 16 else out
    n_ids = indices.shape[0]
    threads = sketch_launch_shape_on(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        m_regs)
    chunks = sketch_chunks(n_ids, r, threads, m_regs)
    bounds = torch.empty(2 * (chunks + 1), dtype=torch.int32, device=dev)
    _build.launch("ocean_hll_sketch", dev, indptr.data_ptr(),
                  indices.data_ptr(), regs.data_ptr(), bounds.data_ptr(), r,
                  n_ids, chunks, m_regs, seed & 0xFFFFFFFF, threads)
    count_launch("hll_sketch")
    return out if regs is out else out.copy_(regs)


def hll_merge_plain(a_indptr, a_indices, sketches_with_sentinel):
    """Plain PyTorch version: segment max of the gathered sketch rows in
    int32, then the estimate; the registers come back as bytes."""
    ra = a_indptr.shape[0] - 1
    merged = chll.merge_sketches(a_indptr, a_indices,
                                 sketches_with_sentinel.int(), num_rows_a=ra)
    return merged.to(torch.uint8), chll.estimate_cardinality(merged)


def hll_merge(a_indptr, a_indices, sketches_with_sentinel):
    """Merge the B-row sketches each A row selects and estimate the
    cardinality of the union.

    a_indptr (RA+1,) int32 and a_indices int32: A's CSR structure.
    sketches_with_sentinel: (NB+1, m) uint8, the last row all zeros; ids
    outside [0, NB+1) read that sentinel.
    Returns (merged (RA, m) uint8, est (RA,) f32).
    """
    sk = sketches_with_sentinel
    if sk.dtype != torch.uint8:
        raise TypeError(f"sketches must be uint8, got {sk.dtype}")
    if a_indptr.device.type == "cpu":
        return hll_merge_plain(a_indptr, a_indices, sk)
    dev = a_indptr.device
    _check((("a_indptr", a_indptr), ("a_indices", a_indices)), dev,
           torch.int32)
    _check((("sketches", sk),), dev, torch.uint8)
    nb1, m = sk.shape
    _check_m(m, True)
    if nb1 == 0:
        raise ValueError("sketches need the zero sentinel row")
    ra = a_indptr.shape[0] - 1
    merged = torch.empty((ra, m), dtype=torch.uint8, device=dev)
    est = torch.empty(ra, dtype=torch.float32, device=dev)
    if ra == 0:
        return merged, est
    sk = _aligned(sk)
    _build.launch(
        "ocean_hll_merge", dev, a_indptr.data_ptr(), a_indices.data_ptr(),
        sk.data_ptr(), merged.data_ptr(), est.data_ptr(), ra, nb1, m,
        chll._alpha(m) * m * m)
    count_launch("hll_merge")
    return merged, est
