"""A cell's operands and the work of one multiply, counted by the benchmark.

The generators hand over each matrix as a pattern (``indptr``,
``indices``) with ``V`` value sets, all on one device. The work of
C = A·B is counted here from A's and B's row lengths, never read from the
program: ``products`` is the number of intermediate products a_ik·b_kj,
and one multiply does ``2 * products`` floating-point operations.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass
class Matrix:
    """A CSR pattern with ``values.shape[0]`` value sets.

    indptr: (m + 1,) int64 row offsets; indices: (nnz,) int64 column
    indices, strictly increasing within a row; values: (V, nnz) float32.
    """
    indptr: torch.Tensor
    indices: torch.Tensor
    values: torch.Tensor
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def value_sets(self) -> int:
        return int(self.values.shape[0])

    def row_lengths(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]


@dataclasses.dataclass
class Operands:
    """A and B of a cell; ``b`` None means B is A (the same values)."""
    a: Matrix
    b: Optional[Matrix] = None

    @property
    def rhs(self) -> Matrix:
        return self.a if self.b is None else self.b


def products(ops: Operands) -> int:
    """Intermediate products of C = A·B."""
    return int(ops.rhs.row_lengths()[ops.a.indices].sum())


def flops(ops: Operands) -> int:
    """Floating-point operations of one multiply: a multiply and an add a
    product."""
    return 2 * products(ops)
