"""CKKS in plain PyTorch: the canonical embedding, secret-key encryption of
the benchmark's inputs, decryption of the program's outputs, and what each
traffic operation does to the slots.

Slot j holds the plaintext polynomial's value at zeta^(5^j), zeta =
exp(i*pi/n) (OpenFHE's CKKSPackedEncoding). Ciphertexts are pairs of [L, n]
residue tensors in the evaluation order of ``modarith.NTT``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .modarith import NTT, mulmod


@lru_cache(maxsize=None)
def _slot_exponents(n: int, device: str) -> torch.Tensor:
    e = np.empty(n // 2, dtype=np.int64)
    v = 1
    for j in range(n // 2):
        e[j] = v
        v = v * 5 % (2 * n)
    return torch.from_numpy(e).to(device)


def embed_inv(z: torch.Tensor, n: int) -> torch.Tensor:
    """n/2 complex slots -> n real coefficients (float64)."""
    exps = _slot_exponents(n, str(z.device))
    v = torch.zeros(2 * n, dtype=torch.complex128, device=z.device)
    v[exps] = z.to(torch.complex128)
    v[(2 * n - exps) % (2 * n)] = z.conj().to(torch.complex128)
    return torch.fft.fft(v)[:n].real / n


def embed(c: torch.Tensor, n: int) -> torch.Tensor:
    """n real coefficients (float64) -> n/2 complex slots."""
    v = torch.zeros(2 * n, dtype=torch.complex128, device=c.device)
    v[:n] = c.to(torch.complex128)
    return (torch.fft.ifft(v) * (2 * n))[_slot_exponents(n, str(c.device))]


def ternary(n: int, rng: np.random.Generator) -> np.ndarray:
    """Uniform coefficients in {-1, 0, 1} (int64), OpenFHE's
    UNIFORM_TERNARY."""
    return rng.integers(-1, 2, size=n, dtype=np.int64)


def unit_disk(count: int, slots: int, gen: torch.Generator, device
              ) -> torch.Tensor:
    """[count, slots] complex128 messages of modulus at most 1: real and
    imaginary parts uniform in (-1/sqrt 2, 1/sqrt 2)."""
    parts = torch.rand(count, slots, 2, dtype=torch.float64, generator=gen,
                       device=device)
    parts = (2 * parts - 1) / 2 ** 0.5
    return torch.complex(parts[..., 0], parts[..., 1])


class Scheme:
    """Encryption and decryption under one secret over the chain Q."""

    def __init__(self, n: int, q_moduli, scale: float, secret: np.ndarray,
                 sigma: float, device):
        self.n, self.q_moduli, self.scale = n, tuple(q_moduli), scale
        self.sigma, self.device = sigma, torch.device(device)
        self.secret = torch.from_numpy(np.asarray(secret, np.int64)
                                       ).to(self.device)
        self._ntt, self._s = {}, {}

    def ntt(self, towers: int) -> NTT:
        if towers not in self._ntt:
            self._ntt[towers] = NTT(self.n, self.q_moduli[:towers],
                                    self.device)
        return self._ntt[towers]

    def residues(self, x: torch.Tensor, towers: int) -> torch.Tensor:
        """Signed int64 coefficients [..., n] -> [..., towers, n]."""
        return torch.remainder(x[..., None, :], self.ntt(towers).q)

    def secret_eval(self, towers: int) -> torch.Tensor:
        if towers not in self._s:
            t = self.ntt(towers)
            self._s[towers] = t.forward(self.residues(self.secret, towers))
        return self._s[towers]

    def encrypt(self, z: torch.Tensor, gen: torch.Generator,
                towers: int | None = None, scale: float | None = None):
        """[count, n/2] slots -> (c0, c1), each [count, towers, n] in the
        evaluation order (default: the whole chain at the chain's scale):
        c1 uniform, c0 = m + e - c1 * s."""
        count = z.shape[0]
        L = len(self.q_moduli) if towers is None else towers
        scale = self.scale if scale is None else scale
        t = self.ntt(L)
        m = torch.stack([torch.round(embed_inv(zi, self.n) * scale)
                         for zi in z]).long()
        e = torch.round(torch.randn(count, self.n, dtype=torch.float64,
                                    generator=gen, device=self.device)
                        * self.sigma).long()
        me = t.forward(self.residues(m + e, L))
        c1 = torch.stack([
            torch.randint(0, q, (count, self.n), generator=gen,
                          device=self.device, dtype=torch.int64)
            for q in self.q_moduli[:L]], dim=1)
        c0 = torch.remainder(me - mulmod(c1, self.secret_eval(L), t.q), t.q)
        return c0, c1

    def decrypt(self, c0: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
        """[L, n] pair -> the phase c0 + c1 * s as centered residues per
        tower, [L, n] int64."""
        L = c0.shape[-2]
        t = self.ntt(L)
        m = t.inverse(torch.remainder(c0 + mulmod(c1, self.secret_eval(L),
                                                  t.q), t.q))
        return torch.where(m > t.q // 2, m - t.q, m)

    def decode(self, centered: torch.Tensor, scale: float) -> torch.Tensor:
        return embed(centered.double(), self.n) / scale


def expected(ops, xs, scale: float, towers: int, q_moduli, dtype):
    """What the traffic's operations make of the operand slots `xs`, in
    `dtype`, with the scale and the tower count they leave: the reference's
    and the control's side of the comparison."""
    acc, acc_scale, acc_towers = None, scale, towers

    def val(name):
        return acc if name == "acc" else xs[int(name[1:])].to(dtype)

    def scale_of(name):
        return acc_scale if name == "acc" else scale

    for op in ops:
        name, args = op[0], op[1:]
        if name == "mult_relin":
            acc_scale = scale_of(args[0]) * scale_of(args[1])
            acc = val(args[0]) * val(args[1])
        elif name == "rescale":
            acc_towers -= 1
            acc_scale /= q_moduli[acc_towers]
        elif name == "rotate":
            acc = torch.roll(acc, -int(args[0]), dims=-1)
        else:
            raise ValueError(f"unknown CKKS operation {name!r}")
    return acc, acc_scale, acc_towers
