"""A 128-bit fingerprint of two sparsity patterns: the pattern part of the
plan cache's key (``core.planner.structure_key``).

The four arrays are A's indptr and indices[:nnz] and B's, int32 or int64.
The element at position ``p`` of array ``t``, its value ``v`` widened to 64
bits with its sign, adds ``fmix64(v ^ fmix64(p + SALTS[t][k]))`` to lane
``k`` (0, 1), mod 2^64; ``fmix64`` is MurmurHash3's finaliser. So every index
of both patterns enters the key, each at its own position, and integer
addition makes the lanes independent of the order the terms are summed in.

For CUDA tensors :func:`pattern_fingerprint` launches the hand-written
kernel in ``csrc/pattern_fingerprint.cu`` (:func:`pattern_fingerprint_cuda`)
and reads back the two lanes, 16 bytes; for CPU tensors it runs
:func:`pattern_fingerprint_plain`. It replaces no TPU kernel: the reference
copies both patterns to the host and hashes them with blake2b
(``repro/core/planner.py:304``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..obs.metrics import count_launch
from . import _build

# one salt an array (A.indptr, A.indices, B.indptr, B.indices) and lane:
# the first hex digits of pi's fraction, as csrc/pattern_fingerprint.cu's
SALTS = ((0x243F6A8885A308D3, 0x13198A2E03707344),
         (0xA4093822299F31D0, 0x082EFA98EC4E6C89),
         (0x452821E638D01377, 0xBE5466CF34E90C6C),
         (0xC0AC29B7C97C50DD, 0x3F84D5B5B5470917))
LANES = 2
MASK = (1 << 64) - 1
THREADS = 256          # csrc/pattern_fingerprint.cu's kThreads
BLOCKS_PER_SM = 8      # 8 x 256 threads of 31 registers fill an SM
PLAIN_CHUNK = 1 << 22  # elements a step of the plain version


def _signed(u: int) -> int:
    """The int64 whose bits are the uint64 ``u``."""
    return u - (1 << 64) if u >> 63 else u


_MUL = (_signed(0xFF51AFD7ED558CCD), _signed(0xC4CEB9FE1A85EC53))


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 ``z`` read as uint64."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def fmix64(z: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's finaliser on int64 ``z`` read as uint64: products and
    sums wrap mod 2^64, as the kernel's unsigned 64-bit integers do."""
    z = (z ^ _shr(z, 33)) * _MUL[0]
    z = (z ^ _shr(z, 33)) * _MUL[1]
    return z ^ _shr(z, 33)


def path(device: torch.device) -> str:
    """``"plain"`` for CPU tensors, ``"cuda"`` (the kernel) otherwise."""
    return "plain" if torch.device(device).type == "cpu" else "cuda"


def _check(arrays: Sequence[torch.Tensor]) -> None:
    if len(arrays) != len(SALTS):
        raise ValueError(f"{len(arrays)} arrays; the fingerprint takes "
                         f"{len(SALTS)}: A.indptr, A.indices, B.indptr, "
                         "B.indices")
    dev = arrays[0].device
    for t, x in enumerate(arrays):
        if x.device != dev:
            raise ValueError(f"array {t} on {x.device}, array 0 on {dev}")
        if x.dim() != 1:
            raise ValueError(f"array {t} has shape {tuple(x.shape)}, not 1-D")
        if x.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"array {t} is {x.dtype}, not int32 or int64")


def pattern_fingerprint_plain(arrays: Sequence[torch.Tensor],
                              chunk: int = PLAIN_CHUNK) -> Tuple[int, int]:
    """Plain PyTorch version, on the arrays' device: the terms of
    ``chunk`` elements at a time, summed mod 2^64."""
    sums = [0] * LANES
    for x, salts in zip(arrays, SALTS):
        for lo in range(0, x.numel(), chunk):
            v = x[lo: lo + chunk].long()
            p = torch.arange(lo, lo + v.numel(), dtype=torch.int64,
                             device=v.device)
            for k, salt in enumerate(salts):
                term = fmix64(v ^ fmix64(p + _signed(salt)))
                sums[k] = (sums[k] + int(term.sum())) & MASK
    return tuple(sums)


def launch_blocks(nbytes: Sequence[int], sms: int) -> int:
    """The kernel's grid: a thread a 16-byte word of the largest array, at
    most :data:`BLOCKS_PER_SM` blocks an SM, at least one block."""
    words = -(-max(nbytes, default=0) // 16)
    return max(1, min(sms * BLOCKS_PER_SM, -(-words // THREADS)))


def launch(arrays: Sequence[torch.Tensor], out: torch.Tensor) -> None:
    """Enqueue the kernel: the two lanes into ``out`` (2,) int64, on the
    arrays' device's current stream. Contiguous CUDA tensors only."""
    _check(arrays)
    dev = arrays[0].device
    if dev.type != "cuda":
        raise ValueError("the fingerprint kernel runs on CUDA tensors; "
                         f"arrays on {dev}")
    if not all(x.is_contiguous() for x in arrays):
        raise ValueError("the fingerprint's arrays must be contiguous")
    if out.shape != (LANES,) or out.dtype != torch.int64 or out.device != dev:
        raise ValueError(f"out must be ({LANES},) int64 on {dev}")
    args = []
    for x in arrays:
        args += [x.data_ptr(), x.numel(), x.element_size()]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = launch_blocks([x.numel() * x.element_size() for x in arrays],
                           sms)
    _build.launch("ocean_pattern_fingerprint", dev, *args, out.data_ptr(),
                  blocks)
    count_launch("pattern_fingerprint")


def pattern_fingerprint_cuda(arrays: Sequence[torch.Tensor]
                             ) -> Tuple[int, int]:
    """One launch of the kernel, then the two lanes read back (16 bytes;
    the read waits for the stream)."""
    out = torch.empty(LANES, dtype=torch.int64, device=arrays[0].device)
    launch(arrays, out)
    return tuple(v & MASK for v in out.tolist())


def pattern_fingerprint(arrays: Sequence[torch.Tensor]) -> Tuple[int, int]:
    """The two 64-bit lanes (unsigned ints) of ``arrays``: A.indptr,
    A.indices[:nnz], B.indptr, B.indices[:nnz], on one device."""
    arrays = [x.contiguous() for x in arrays]
    if path(arrays[0].device) == "plain":
        _check(arrays)
        return pattern_fingerprint_plain(arrays)
    return pattern_fingerprint_cuda(arrays)
