"""Generic element matrices with Strassen multiplication.

Role of the reference's ``core/include/math/matrix.h`` (``Matrix<T>``,
used for trapdoor square-matrix variants, ABE/obfuscation protocols) and
``matrixstrassen.h``. Elements can be anything with +, -, * (ring
elements, Field2n, Python ints/floats); storage is a numpy object array
so slicing/stacking are free.

The port's own copy of ``openfhe_tpu/utils/matrix.py`` (same names and
signatures, same results), so that the port imports nothing of the JAX
package.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


class Matrix:
    """Dense rows x cols matrix of arbitrary ring elements."""

    def __init__(self, alloc: Callable | None, rows: int, cols: int,
                 data: np.ndarray | None = None):
        if data is not None:
            self.data = data
        else:
            self.data = np.empty((rows, cols), dtype=object)
            if alloc is not None:
                for i in range(rows):
                    for j in range(cols):
                        self.data[i, j] = alloc()
        self.rows, self.cols = self.data.shape

    @staticmethod
    def from_list(rows: list) -> "Matrix":
        arr = np.empty((len(rows), len(rows[0])), dtype=object)
        for i, r in enumerate(rows):
            for j, v in enumerate(r):
                arr[i, j] = v
        return Matrix(None, 0, 0, data=arr)

    def __call__(self, i: int, j: int):
        return self.data[i, j]

    def set(self, i: int, j: int, v) -> None:
        self.data[i, j] = v

    # -- algebra -----------------------------------------------------------
    def __add__(self, o: "Matrix") -> "Matrix":
        assert self.data.shape == o.data.shape
        return Matrix(None, 0, 0, data=self.data + o.data)

    def __sub__(self, o: "Matrix") -> "Matrix":
        assert self.data.shape == o.data.shape
        return Matrix(None, 0, 0, data=self.data - o.data)

    def __mul__(self, o: "Matrix") -> "Matrix":
        return self.mult(o)

    def mult(self, o: "Matrix", strassen_cutoff: int = 2) -> "Matrix":
        """Matrix product; square power-of-two operands above the cutoff
        recurse via Strassen's 7-multiplication scheme (reference:
        ``matrixstrassen.h``), everything else runs the cubic kernel."""
        assert self.cols == o.rows, (self.cols, o.rows)
        n = self.rows
        if (n == self.cols == o.cols and n >= strassen_cutoff
                and n & (n - 1) == 0):
            return Matrix(None, 0, 0,
                          data=_strassen(self.data, o.data, strassen_cutoff))
        return Matrix(None, 0, 0, data=self.data @ o.data)

    def scalar_mult(self, s) -> "Matrix":
        return Matrix(None, 0, 0, data=self.data * s)

    def transpose(self) -> "Matrix":
        return Matrix(None, 0, 0, data=self.data.T.copy())

    # -- block ops (reference: ExtractRows / VStack / HStack) --------------
    def extract_rows(self, lo: int, hi: int) -> "Matrix":
        """Rows lo..hi INCLUSIVE (the reference's convention)."""
        return Matrix(None, 0, 0, data=self.data[lo:hi + 1].copy())

    def vstack(self, o: "Matrix") -> "Matrix":
        return Matrix(None, 0, 0, data=np.vstack([self.data, o.data]))

    def hstack(self, o: "Matrix") -> "Matrix":
        return Matrix(None, 0, 0, data=np.hstack([self.data, o.data]))

    def __eq__(self, o) -> bool:
        return (isinstance(o, Matrix) and self.data.shape == o.data.shape
                and bool(np.all(self.data == o.data)))


def _strassen(A: np.ndarray, B: np.ndarray, cutoff: int) -> np.ndarray:
    n = A.shape[0]
    if n <= cutoff or n & 1:
        return A @ B
    h = n // 2
    a11, a12, a21, a22 = A[:h, :h], A[:h, h:], A[h:, :h], A[h:, h:]
    b11, b12, b21, b22 = B[:h, :h], B[:h, h:], B[h:, :h], B[h:, h:]
    m1 = _strassen(a11 + a22, b11 + b22, cutoff)
    m2 = _strassen(a21 + a22, b11, cutoff)
    m3 = _strassen(a11, b12 - b22, cutoff)
    m4 = _strassen(a22, b21 - b11, cutoff)
    m5 = _strassen(a11 + a12, b22, cutoff)
    m6 = _strassen(a21 - a11, b11 + b12, cutoff)
    m7 = _strassen(a12 - a22, b21 + b22, cutoff)
    out = np.empty_like(A)
    out[:h, :h] = m1 + m4 - m5 + m7
    out[:h, h:] = m3 + m5
    out[h:, :h] = m2 + m4
    out[h:, h:] = m1 - m2 + m3 + m6
    return out
