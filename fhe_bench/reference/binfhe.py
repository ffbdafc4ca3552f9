"""LWE in plain PyTorch: encryption of the benchmark's gate inputs and
decryption of the program's gate outputs. A bit m is encrypted at q/4:
b = <a, s> + e + m*q/4 mod q, as OpenFHE's LWEEncryptionScheme does."""

from __future__ import annotations

import numpy as np
import torch

GATES = {"AND": lambda x, y: x & y}


def ternary(n: int, rng: np.random.Generator) -> np.ndarray:
    """Uniform coefficients in {-1, 0, 1} (int64)."""
    return rng.integers(-1, 2, size=n, dtype=np.int64)


def encrypt(bits: torch.Tensor, s: torch.Tensor, q: int, sigma: float,
            gen: torch.Generator):
    """bits [...] in {0, 1} -> (a [..., n], b [...]) mod q."""
    a = torch.randint(0, q, (*bits.shape, s.numel()), generator=gen,
                      device=bits.device, dtype=torch.int64)
    e = torch.round(torch.randn(bits.shape, dtype=torch.float64,
                                generator=gen, device=bits.device)
                    * sigma).long()
    b = torch.remainder((a * s).sum(-1) + e + bits * (q // 4), q)
    return a, b


def phase(a: torch.Tensor, b: torch.Tensor, s: torch.Tensor, q: int
          ) -> torch.Tensor:
    """b - <a, s> mod q."""
    return torch.remainder(b - (a * s).sum(-1), q)


def decode(ph: torch.Tensor, q: int):
    """The bit a phase decrypts to: the nearest multiple of q/4, odd or
    even (OpenFHE's LWE decryption)."""
    bit = torch.remainder(torch.div(4 * ph + q // 2, q,
                                    rounding_mode="floor"), 4) & 1
    return bit


def margin_share(ph: torch.Tensor, want: torch.Tensor, q: int
                 ) -> torch.Tensor:
    """|phase - want*q/4| (centered mod q) over q/8: 1 or more decrypts to
    the wrong bit or lies on the boundary."""
    d = torch.remainder(ph - want * (q // 4), q)
    d = torch.where(d > q // 2, q - d, d)
    return d.double() / (q // 8)
