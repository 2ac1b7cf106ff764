"""CSR containers over torch tensors and host-side synthetic generators.

The container keeps the reference's layout: ``indptr`` and ``indices`` are
int32, ``values`` float32, and an optional ``capacity`` pads the tail of
``indices``/``values`` with ``PAD_COL``/0. Every tensor of one CSR lives on
one device; constructors take ``device=`` and default to ``"cuda"``.

The generators are the reference's numpy generators, unchanged, so the same
seed gives the same arrays in both packages.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Tuple

import numpy as np
import torch

PAD_COL = 2**31 - 1  # sorts after every real column index


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent, so a caller never silently gets a CPU result."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available; pass "
            "device='cpu' explicitly to run the plain PyTorch versions")
    return dev


def host(x) -> np.ndarray:
    """Numpy view/copy of a tensor or array (no copy for CPU tensors)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def structure_hash(c: "CSR") -> str:
    """Hash of one matrix's sparsity pattern (values excluded). Hashes the
    same int32 bytes as the reference, so digests are equal."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(host(c.indptr).astype(np.int32)).tobytes())
    h.update(np.ascontiguousarray(
        host(c.indices[: c.nnz]).astype(np.int32)).tobytes())
    h.update(repr(c.shape).encode())
    return h.hexdigest()


def lru_bucket(store, key: str, factory: Callable, maxsize: int = 8):
    """Fetch/create ``store[key]`` in an OrderedDict used as a small LRU
    of per-key buckets (per-RHS sketch caches)."""
    if key not in store:
        store[key] = factory()
    store.move_to_end(key)
    while len(store) > maxsize:
        store.popitem(last=False)
    return store[key]


def pow2_at_least(x: int, *, floor: int) -> int:
    """Smallest power-of-two multiple of ``floor`` that is >= ``x``."""
    if floor <= 0:
        raise ValueError(f"pow2_at_least floor must be positive, got {floor}")
    v = floor
    while v < x:
        v *= 2
    return v


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed-sparse-row matrix.

    indptr:  (m+1,) int32 row offsets.
    indices: (capacity,) int32 column indices, padded with PAD_COL.
    values:  (capacity,) float32, padded with 0.
    shape:   (m, n).
    nnz:     number of valid entries.
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    values: torch.Tensor
    shape: Tuple[int, int]
    nnz: int

    @property
    def capacity(self) -> int:
        return int(self.indices.shape[0])

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    def row_nnz(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def to_dense(self) -> torch.Tensor:
        rows = torch.repeat_interleave(
            torch.arange(self.m, device=self.device),
            self.row_nnz().long())
        out = torch.zeros(self.shape, dtype=self.values.dtype,
                          device=self.device)
        out.index_put_((rows, self.indices[: self.nnz].long()),
                       self.values[: self.nnz], accumulate=True)
        return out

    def to_scipy_like(self):
        """(indptr, indices, values) trimmed to nnz as numpy arrays."""
        return to_numpy(self)


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    # torch refuses to share memory with a read-only array: copy it
    return torch.from_numpy(x if x.flags.writeable else x.copy())


def csr_from_arrays(indptr, indices, values, shape, capacity=None,
                    device="cuda") -> CSR:
    """Build a CSR from numpy arrays or tensors on ``device``, padding to
    ``capacity``."""
    dev = resolve_device(device)
    indptr = _tensor(indptr).to(device=dev, dtype=torch.int32)
    indices = _tensor(indices).to(device=dev, dtype=torch.int32)
    values = _tensor(values).to(device=dev)
    nnz = int(indices.shape[0])
    capacity = nnz if capacity is None else int(capacity)
    if capacity < nnz:
        raise ValueError(f"capacity {capacity} < nnz {nnz}")
    pad = capacity - nnz
    if pad:
        indices = torch.cat([indices, torch.full((pad,), PAD_COL,
                                                 dtype=torch.int32,
                                                 device=dev)])
        values = torch.cat([values, torch.zeros(pad, dtype=values.dtype,
                                                device=dev)])
    return CSR(indptr, indices, values, tuple(int(s) for s in shape), nnz)


def from_numpy_csr(indptr, indices, values, shape, device="cuda") -> CSR:
    """CSR from host arrays, e.g. a reference CSR's ``to_scipy_like()``."""
    return csr_from_arrays(np.asarray(indptr), np.asarray(indices),
                           np.asarray(values), shape, device=device)


def to_numpy(c: CSR):
    """(indptr, indices, values) of ``c`` trimmed to nnz, as numpy."""
    return (host(c.indptr), host(c.indices[: c.nnz]),
            host(c.values[: c.nnz]))


def csr_from_dense(dense, capacity=None, device="cuda") -> CSR:
    """Host-side dense -> CSR (numpy; for tests and small inputs)."""
    a = host(dense)
    m, n = a.shape
    rows, cols = np.nonzero(a)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    vals = a[rows, cols]
    indptr = np.zeros(m + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return csr_from_arrays(indptr, cols, vals, (m, n), capacity, device)


def csr_rows_to_ell(indptr, indices, values, *, num_rows: int,
                    ell_width: int, pad_index: int = -1):
    """CSR -> ELL (padded row-major) tensors. Returns (ell_idx (num_rows,
    ell_width) int32, ell_val or None). Rows longer than ``ell_width`` are
    truncated."""
    dev = indices.device
    e = torch.arange(ell_width, device=dev, dtype=torch.int64)[None, :]
    starts = indptr[:num_rows, None].long()
    lens = (indptr[1: num_rows + 1] - indptr[:num_rows])[:, None].long()
    pos = (starts + e).clamp(0, max(indices.shape[0] - 1, 0))
    valid = e < lens
    if indices.shape[0] == 0:
        ell_idx = torch.full((num_rows, ell_width), pad_index,
                             dtype=torch.int32, device=dev)
        ell_val = (None if values is None else
                   torch.zeros((num_rows, ell_width), dtype=values.dtype,
                               device=dev))
        return ell_idx, ell_val
    ell_idx = torch.where(valid, indices[pos].int(),
                          torch.tensor(pad_index, dtype=torch.int32,
                                       device=dev))
    ell_val = None
    if values is not None:
        ell_val = torch.where(valid, values[pos],
                              torch.zeros((), dtype=values.dtype, device=dev))
    return ell_idx, ell_val


def flat_gather_index(indptr, rows):
    """Vectorized multi-row gather plan (host-side, numpy).

    Returns ``(new_ptr, src)``: ``new_ptr`` is the indptr of the gathered
    sub-CSR and ``src[j]`` the position in the source arrays feeding slot
    ``j``."""
    indptr = host(indptr)
    rows = np.asarray(rows, np.int64)
    starts = indptr[rows].astype(np.int64)
    lens = (indptr[rows + 1] - indptr[rows]).astype(np.int64)
    new_ptr = np.zeros(len(rows) + 1, np.int64)
    np.cumsum(lens, out=new_ptr[1:])
    total = int(new_ptr[-1])
    src = np.repeat(starts - new_ptr[:-1], lens) + np.arange(total,
                                                             dtype=np.int64)
    return new_ptr, src


def pad_axis(x: torch.Tensor, length: int, axis: int = 0, value=0):
    """Pad ``x`` along ``axis`` up to ``length`` with ``value``."""
    cur = x.shape[axis]
    if cur >= length:
        return x
    shape = list(x.shape)
    shape[axis] = length - cur
    fill = torch.full(shape, value, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill], dim=axis)


# ---------------------------------------------------------------------------
# Synthetic matrix generators (host-side numpy, identical to the
# reference's so a seed gives the same arrays in both packages).
# ---------------------------------------------------------------------------

def _dedupe_rows(rows, cols, vals, m, n):
    key = rows.astype(np.int64) * n + cols
    order = np.argsort(key, kind="stable")
    key, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
    keep = np.ones(len(key), bool)
    keep[1:] = key[1:] != key[:-1]
    seg = np.cumsum(keep) - 1
    out_vals = np.zeros(int(seg[-1]) + 1 if len(seg) else 0, vals.dtype)
    np.add.at(out_vals, seg, vals)
    return rows[keep], cols[keep], out_vals


def _to_csr(rows, cols, vals, m, n, device) -> CSR:
    indptr = np.zeros(m + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return csr_from_arrays(indptr, cols, vals, (m, n), device=device)


def random_uniform_csr(key: int, m: int, n: int, nnz_per_row: float,
                       dtype=np.float32, device="cuda") -> CSR:
    """Uniform random sparsity — ER moderate, CR ~ 1-2."""
    rng = np.random.default_rng(key)
    counts = rng.poisson(nnz_per_row, m).clip(0, n)
    rows = np.repeat(np.arange(m), counts)
    cols = rng.integers(0, n, rows.shape[0])
    vals = rng.standard_normal(rows.shape[0]).astype(dtype)
    rows, cols, vals = _dedupe_rows(rows, cols, vals, m, n)
    return _to_csr(rows, cols, vals, m, n, device)


def powerlaw_csr(key: int, m: int, n: int, nnz_per_row: float,
                 alpha: float = 1.5, dtype=np.float32, device="cuda") -> CSR:
    """Power-law column popularity (graph adjacency-like) — high CR rows."""
    rng = np.random.default_rng(key)
    counts = rng.zipf(alpha, m).clip(1, max(1, n // 4))
    scale = nnz_per_row / max(counts.mean(), 1e-9)
    counts = np.maximum(1, (counts * scale).astype(np.int64)).clip(1, n)
    popularity = (1.0 / np.arange(1, n + 1) ** 0.8)
    popularity /= popularity.sum()
    rows = np.repeat(np.arange(m), counts)
    cols = rng.choice(n, rows.shape[0], p=popularity)
    vals = rng.standard_normal(rows.shape[0]).astype(dtype)
    rows, cols, vals = _dedupe_rows(rows, cols, vals, m, n)
    return _to_csr(rows, cols, vals, m, n, device)


def banded_csr(key: int, m: int, n: int, bandwidth: int, fill: float = 0.7,
               dtype=np.float32, device="cuda") -> CSR:
    """Banded (stencil/PDE-like) — narrow column span."""
    rng = np.random.default_rng(key)
    rows_l, cols_l, vals_l = [], [], []
    for i in range(m):
        lo = max(0, int(i * n / m) - bandwidth)
        hi = min(n, int(i * n / m) + bandwidth + 1)
        mask = rng.random(hi - lo) < fill
        c = np.arange(lo, hi)[mask]
        rows_l.append(np.full(c.shape[0], i))
        cols_l.append(c)
        vals_l.append(rng.standard_normal(c.shape[0]).astype(dtype))
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = np.concatenate(vals_l)
    return _to_csr(rows, cols, vals, m, n, device)


def block_sparse_csr(key: int, m: int, n: int, block: int,
                     block_density: float = 0.05, fill: float = 0.8,
                     dtype=np.float32, device="cuda") -> CSR:
    """Block-sparse (TileSpGEMM's favourable case)."""
    rng = np.random.default_rng(key)
    mb, nb = (m + block - 1) // block, (n + block - 1) // block
    active = rng.random((mb, nb)) < block_density
    rows_l, cols_l, vals_l = [], [], []
    bi, bj = np.nonzero(active)
    for i, j in zip(bi, bj):
        r0, c0 = i * block, j * block
        h = min(block, m - r0)
        w = min(block, n - c0)
        mask = rng.random((h, w)) < fill
        rr, cc = np.nonzero(mask)
        rows_l.append(rr + r0)
        cols_l.append(cc + c0)
        vals_l.append(rng.standard_normal(rr.shape[0]).astype(dtype))
    if not rows_l:
        return random_uniform_csr(key, m, n, 1.0, dtype, device)
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = np.concatenate(vals_l)
    rows, cols, vals = _dedupe_rows(rows, cols, vals, m, n)
    return _to_csr(rows, cols, vals, m, n, device)


def skewed_rows_csr(key: int, m: int, n: int, nnz_per_row: float,
                    heavy_frac: float = 0.02, heavy_mult: float = 50.0,
                    dtype=np.float32, device="cuda") -> CSR:
    """A few extremely long rows (load-imbalance stressor; long-row kernel)."""
    rng = np.random.default_rng(key)
    counts = rng.poisson(nnz_per_row, m).clip(1, n)
    heavy = rng.random(m) < heavy_frac
    counts = np.where(heavy, np.minimum(n, (counts * heavy_mult)
                                        .astype(np.int64)), counts)
    rows = np.repeat(np.arange(m), counts)
    cols = rng.integers(0, n, rows.shape[0])
    vals = rng.standard_normal(rows.shape[0]).astype(dtype)
    rows, cols, vals = _dedupe_rows(rows, cols, vals, m, n)
    return _to_csr(rows, cols, vals, m, n, device)


def hypersparse_csr(key: int, m: int, n: int, dtype=np.float32,
                    device="cuda") -> CSR:
    """<1 nnz per row on average — the upper-bound-workflow regime."""
    rng = np.random.default_rng(key)
    nnz = max(1, int(0.6 * m))
    rows = np.sort(rng.integers(0, m, nnz))
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz).astype(dtype)
    rows, cols, vals = _dedupe_rows(rows, cols, vals, m, n)
    return _to_csr(rows, cols, vals, m, n, device)


GENERATORS = {
    "uniform": random_uniform_csr,
    "powerlaw": powerlaw_csr,
    "banded": banded_csr,
    "block": block_sparse_csr,
    "skewed": skewed_rows_csr,
    "hypersparse": hypersparse_csr,
}


def make_suite(scale: int = 1, seed: int = 0, device="cuda"):
    """The reference's matrix suite (same names, seeds and arrays)."""
    s = scale
    d = device
    return [
        ("uniform_small", random_uniform_csr(seed + 1, 256 * s, 256 * s, 8,
                                             device=d)),
        ("uniform_mid", random_uniform_csr(seed + 2, 1024 * s, 1024 * s, 16,
                                           device=d)),
        ("powerlaw", powerlaw_csr(seed + 3, 768 * s, 768 * s, 12, device=d)),
        ("banded_narrow", banded_csr(seed + 4, 512 * s, 512 * s, 8,
                                     device=d)),
        ("banded_wide", banded_csr(seed + 5, 512 * s, 512 * s, 48,
                                   device=d)),
        ("block", block_sparse_csr(seed + 6, 512 * s, 512 * s, 32,
                                   device=d)),
        ("skewed", skewed_rows_csr(seed + 7, 1024 * s, 1024 * s, 6,
                                   device=d)),
        ("hypersparse", hypersparse_csr(seed + 8, 2048 * s, 2048 * s,
                                        device=d)),
    ]
