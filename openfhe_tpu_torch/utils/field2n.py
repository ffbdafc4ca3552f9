"""Field2n: elements of the 2n-th cyclotomic number field over doubles.

Role of the reference's ``core/include/lattice/field2n.h`` — the real
(floating-point) arithmetic layer that the Micciancio-Peikert
perturbation sampler (``lattice/dgsampling.h`` ZSampleSigma2x2/ZSampleF,
eprint 2017/844 Alg. 4) runs its Schur-complement recursions in.

An element is a vector of n complex coefficients of
Q[x]/(x^n + 1), held in COEFF (coefficient) or EVAL (DFT at the odd
powers of the primitive 2n-th root psi = e^{i pi / n}) format:
eval_j = p(psi^(2j+1)). The negacyclic DFT is realized as a psi-twisted
length-n FFT, so conversions are O(n log n) numpy ffts rather than the
reference's hand-rolled loops.

The port's own copy of ``openfhe_tpu/utils/field2n.py`` (same names and
signatures, same results), so that the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

COEFF = "COEFF"
EVAL = "EVAL"


def _psi_pows(n: int) -> np.ndarray:
    return np.exp(1j * np.pi * np.arange(n) / n)


@dataclasses.dataclass(frozen=True)
class Field2n:
    """Immutable field element; ``data`` is complex128 [n]."""

    data: np.ndarray
    fmt: str = COEFF

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_ints(vals, fmt: str = COEFF) -> "Field2n":
        return Field2n(np.asarray(vals, dtype=np.complex128), fmt)

    @property
    def n(self) -> int:
        return len(self.data)

    def __len__(self) -> int:
        return len(self.data)

    # -- format switching (psi-twisted FFT) --------------------------------
    def to_eval(self) -> "Field2n":
        if self.fmt == EVAL:
            return self
        n = self.n
        ev = n * np.fft.ifft(self.data * _psi_pows(n))
        return Field2n(ev, EVAL)

    def to_coeff(self) -> "Field2n":
        if self.fmt == COEFF:
            return self
        n = self.n
        co = np.fft.fft(self.data) / n / _psi_pows(n)
        return Field2n(co, COEFF)

    def set_format(self, fmt: str) -> "Field2n":
        return self.to_eval() if fmt == EVAL else self.to_coeff()

    # -- arithmetic --------------------------------------------------------
    def _like(self, other: "Field2n"):
        assert self.fmt == other.fmt and self.n == other.n, \
            (self.fmt, other.fmt, self.n, other.n)

    def __add__(self, other):
        if isinstance(other, (int, float)):
            return self.plus_scalar(float(other))
        self._like(other)
        return Field2n(self.data + other.data, self.fmt)

    def __sub__(self, other):
        if isinstance(other, (int, float)):
            return self.plus_scalar(-float(other))
        self._like(other)
        return Field2n(self.data - other.data, self.fmt)

    def __neg__(self):
        return Field2n(-self.data, self.fmt)

    def __mul__(self, other):
        """Field multiplication: pointwise in EVAL (negacyclic
        convolution in COEFF is not needed — the reference converts to
        DFT first, and so do all our callers)."""
        assert self.fmt == EVAL and other.fmt == EVAL
        return Field2n(self.data * other.data, EVAL)

    def plus_scalar(self, s: float) -> "Field2n":
        """+ the constant polynomial s (index 0 in COEFF, everywhere in
        EVAL — the same field element)."""
        if self.fmt == COEFF:
            d = self.data.copy()
            d[0] = d[0] + s
            return Field2n(d, COEFF)
        return Field2n(self.data + s, EVAL)

    def scalar_mult(self, s: float) -> "Field2n":
        return Field2n(self.data * s, self.fmt)

    def inverse(self) -> "Field2n":
        """Multiplicative inverse (pointwise reciprocal in EVAL)."""
        ev = self.to_eval()
        return Field2n(1.0 / ev.data, EVAL)

    def transpose(self) -> "Field2n":
        """The conjugation x -> x(1/X) mod x^n + 1 (reference:
        Field2n::Transpose): COEFF [a0, -a_{n-1}, ..., -a_1]; in EVAL the
        same map is complex conjugation of each evaluation."""
        if self.fmt == EVAL:
            return Field2n(np.conj(self.data), EVAL)
        d = np.empty_like(self.data)
        d[0] = self.data[0]
        d[1:] = -self.data[:0:-1]
        return Field2n(d, COEFF)

    # -- even/odd split (the ZSampleF recursion; f = f0(x^2) + x f1(x^2))
    def extract_even(self) -> "Field2n":
        assert self.fmt == COEFF
        return Field2n(self.data[0::2].copy(), COEFF)

    def extract_odd(self) -> "Field2n":
        assert self.fmt == COEFF
        return Field2n(self.data[1::2].copy(), COEFF)
