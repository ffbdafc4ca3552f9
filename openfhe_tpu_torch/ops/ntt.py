"""Negacyclic NTT / inverse NTT over RNS towers.

Counterpart of ``openfhe_tpu/ops/ntt.py`` (with ``ops/ntt32.py``),
``ops/ntt_pallas.py`` and the twist tables of ``parallel/dntt.py``. Two
decompositions, one per ring size, each with its own kernel and twin:

* Rings of n <= 2^11 (``SMALL_MAX_N``: BINFHE, scheme switching's FHEW side,
  the four-step's sub-transforms, the example programs) run the merged
  network of ``openfhe_tpu/ops/ntt.py``: Cooley-Tukey stages with psi folded
  into the bit-reversed twiddles, Gentleman-Sande back with a final 1/n.
  ``forward_small``/``inverse_small`` launch ``csrc/ntt_small.cu`` (one
  launch per transform) for a CUDA tensor and run
  ``forward_small_plain``/``inverse_small_plain`` for a CPU tensor.
* Larger rings (n = n1*n2, ``split_factors``) run the four-step: each tower
  viewed as [n1, n2], n1-point Cooley-Tukey NTTs down the columns, a twist,
  then n2-point NTTs along the rows; the row-major result is the same slot
  order. The inverse runs Gentleman-Sande stages in reverse with 1/n folded
  into the untwist. ``csrc/ntt.cu`` (radix-16 rounds in registers with lazy
  butterflies for n = 2^12..2^17, radix-2 stages in shared memory above)
  for a CUDA tensor, ``forward_plain``/``inverse_plain`` for a CPU tensor.

``forward``/``inverse`` route by n. In both, slot j holds
p(psi^(2*bitrev(j)+1)) for psi = ``nbtheory.root_of_unity(2n, q)``, so
every route gives the same bits. There is no fallback between a kernel and
its twin.

Tables are built with exact Python ints per (n, q) and stacked per basis on
each device: sub-transform roots come from ``nbtheory.root_of_unity(2R, q)``
(= psi^(n/R)), the twist follows ``dntt.twist_values`` and the untwist
``ntt_pallas._twist_tables``; the merged tables are ``stage_tables`` at
R = n, the JAX package's ``_plan_tables``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import _build
from ..utils import nbtheory
from .modular import (add_mod, check_modulus, check_reduced, mul_mod_shoup,
                      shoup_precon_int, sub_mod, u64_array)

MAX_N1 = 4096  # a kernel tile holds one whole column transform
SMALL_MAX_N = 1 << 11  # rings up to this take the merged network


def split_factors(n: int) -> tuple:
    """Balanced power-of-two split n = n1*n2 with n1 >= n2."""
    bits = n.bit_length() - 1
    b2 = bits // 2
    return 1 << (bits - b2), 1 << b2


def bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@lru_cache(maxsize=None)
def stage_tables(R: int, q: int) -> np.ndarray:
    """[4, R]: bit-reversed powers of the 2R-th root psi_R and of its
    inverse, each with Shoup precons (rows: w, w_pre, w_inv, w_inv_pre).
    Stage m of a size-R transform reads index m + group, as ntt.py does."""
    psi = nbtheory.root_of_unity(2 * R, q)
    rev = bit_reverse_perm(R)
    rows = []
    for root in (psi, pow(psi, -1, q)):
        pw = [1] * R
        for j in range(1, R):
            pw[j] = pw[j - 1] * root % q
        br = [pw[int(rev[j])] for j in range(R)]
        rows.append(br)
        rows.append([shoup_precon_int(v, q) for v in br])
    return u64_array(rows)


@lru_cache(maxsize=None)
def twist_tables(n1: int, n2: int, q: int) -> np.ndarray:
    """[4, n1, n2]: twist T[c1, j2] = psi^((e1(c1) - n1) * j2) with
    e1(c1) = 2*rev_n1(c1) + 1 (dntt.twist_values), its precon, the untwist
    T^-1 / n (ntt_pallas._twist_tables) and its precon."""
    n = n1 * n2
    psi = nbtheory.root_of_unity(2 * n, q)
    ninv = pow(n, -1, q)
    rev1 = bit_reverse_perm(n1)
    tw, itw = [], []
    for c1 in range(n1):
        step = pow(psi, (2 * int(rev1[c1]) + 1 - n1) % (2 * n), q)
        istep = pow(step, -1, q)
        v, vi = 1, ninv
        for _ in range(n2):
            tw.append(v)
            itw.append(vi)
            v = v * step % q
            vi = vi * istep % q
    out = [tw, [shoup_precon_int(v, q) for v in tw],
           itw, [shoup_precon_int(v, q) for v in itw]]
    return u64_array(out).reshape(4, n1, n2)


class NTTTables(NamedTuple):
    """Stacked per-basis tables on one device (int64 bit patterns)."""

    n1: int
    n2: int
    q: torch.Tensor       # [L]
    w1: torch.Tensor      # [4, L, n1]: w, w_pre, w_inv, w_inv_pre
    w2: torch.Tensor      # [4, L, n2]
    tw: torch.Tensor      # [4, L, n1, n2]: twist, pre, untwist, pre


def _check_ring(n: int, moduli: tuple) -> None:
    if n & (n - 1) or n < 2:
        raise ValueError(f"ring dimension {n} is not a power of two >= 2")
    for q in moduli:
        check_modulus(q)  # the kernels' lazy butterflies hold values < 4q
        if (q - 1) % (2 * n):
            raise ValueError(f"{q} is not NTT-friendly for 2n={2 * n}")


@lru_cache(maxsize=None)
def _tables(n: int, moduli: tuple, device: str) -> NTTTables:
    _check_ring(n, moduli)
    n1, n2 = split_factors(n)
    if n1 > MAX_N1:
        raise ValueError(f"ring dimension {n} above the kernel's 2^24 limit")

    def stack(fn, *args):
        arr = np.stack([fn(*args, q) for q in moduli], axis=1)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    q = torch.tensor(list(moduli), dtype=torch.int64, device=device)
    return NTTTables(n1, n2, q, stack(stage_tables, n1),
                     stack(stage_tables, n2), stack(twist_tables, n1, n2))


def _key(moduli: Sequence[int], device) -> tuple:
    if not moduli:
        raise ValueError("NTT over an empty modulus chain (no towers left)")
    return tuple(int(q) for q in moduli), str(torch.device(device))


def tables(n: int, moduli: Sequence[int], device) -> NTTTables:
    """The four-step's tables of ring n over `moduli` on `device`."""
    return _tables(n, *_key(moduli, device))


class SmallTables(NamedTuple):
    """The merged network's tables on one device (int64 bit patterns)."""

    n: int
    q: torch.Tensor       # [L]
    fwd: torch.Tensor     # [L, n, 2]: psi^bitrev(j) and its Shoup precon
    inv: torch.Tensor     # [L, n, 2]: psi^-bitrev(j) and its precon
    scale: torch.Tensor   # [L, 2, 2]: (n^-1, precon) and
    #                       (psi^-bitrev(1) * n^-1, precon)


@lru_cache(maxsize=None)
def _small_tables(n: int, moduli: tuple, device: str) -> SmallTables:
    _check_ring(n, moduli)
    if n > SMALL_MAX_N:
        raise ValueError(f"ring dimension {n} above the merged network's "
                         f"{SMALL_MAX_N}")
    fwd, inv, scale = [], [], []
    for q in moduli:
        tab = stage_tables(n, q)
        fwd.append(np.stack([tab[0], tab[1]], axis=-1))
        inv.append(np.stack([tab[2], tab[3]], axis=-1))
        ninv = pow(n, -1, q)
        last = int(tab[2, 1]) * ninv % q
        scale.append(u64_array([[ninv, shoup_precon_int(ninv, q)],
                                [last, shoup_precon_int(last, q)]]))

    def put(arrs):
        return torch.from_numpy(np.ascontiguousarray(np.stack(arrs))).to(
            device)

    q = torch.tensor(list(moduli), dtype=torch.int64, device=device)
    return SmallTables(n, q, put(fwd), put(inv), put(scale))


def small_tables(n: int, moduli: Sequence[int], device) -> SmallTables:
    """The merged network's tables of ring n <= SMALL_MAX_N."""
    return _small_tables(n, *_key(moduli, device))


# ---------------------------------------------------------------------------
# Plain PyTorch twin: the kernel's own decomposition, stage by stage
# ---------------------------------------------------------------------------


def _stages(x, w, wp, q, fwd: bool, mid: int):
    """All butterfly stages of a size-R transform over axis -2 of
    [..., L, *mid dims, R, C]. w, wp: [L, R]; q: [L]."""
    R, C = x.shape[-2], x.shape[-1]
    lead = x.shape[:-2]
    L = w.shape[0]
    pad = (1,) * mid
    qb = q.reshape((L,) + pad + (1, 1, 1))

    def tw(table, a, b):
        return table[:, a:b].reshape((L,) + pad + (b - a, 1, 1))

    s = 1
    while s < R:
        if fwd:          # m = s groups of half-size t
            groups, t = s, R // (2 * s)
        else:            # h = R/(2s) groups of half-size t = s
            groups, t = R // (2 * s), s
        y = x.reshape(lead + (groups, 2, t, C))
        u, v = y[..., 0, :, :], y[..., 1, :, :]
        w_g = tw(w, groups, 2 * groups)
        wp_g = tw(wp, groups, 2 * groups)
        if fwd:
            v = mul_mod_shoup(v, w_g, wp_g, qb)
            top, bot = add_mod(u, v, qb), sub_mod(u, v, qb)
        else:
            top = add_mod(u, v, qb)
            bot = mul_mod_shoup(sub_mod(u, v, qb), w_g, wp_g, qb)
        x = torch.stack([top, bot], dim=-3).reshape(lead + (R, C))
        s *= 2
    return x


def forward_plain(x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """Twin of the forward kernel: [..., L, n] natural order -> slots."""
    lead = x.shape[:-1]
    q3 = t.q[:, None, None]
    y = x.reshape(lead + (t.n1, t.n2))
    y = _stages(y, t.w1[0], t.w1[1], t.q, True, 0)                # columns
    y = mul_mod_shoup(y, t.tw[0], t.tw[1], q3)                      # twist
    y = _stages(y.unsqueeze(-1), t.w2[0], t.w2[1], t.q, True, 1)   # rows
    return y.reshape(lead + (t.n1 * t.n2,))


def inverse_plain(x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """Twin of the inverse kernel: slots -> natural coefficients."""
    lead = x.shape[:-1]
    q3 = t.q[:, None, None]
    y = x.reshape(lead + (t.n1, t.n2, 1))
    y = _stages(y, t.w2[2], t.w2[3], t.q, False, 1).squeeze(-1)    # rows
    y = mul_mod_shoup(y, t.tw[2], t.tw[3], q3)                      # untwist
    y = _stages(y, t.w1[2], t.w1[3], t.q, False, 0)                # columns
    return y.reshape(lead + (t.n1 * t.n2,))


def forward_small_plain(x: torch.Tensor, t: SmallTables) -> torch.Tensor:
    """Twin of the small-ring forward kernel: [..., L, n] natural order ->
    slots, the merged Cooley-Tukey network stage by stage (the JAX
    package's ``ntt.forward``)."""
    n, lead = t.n, x.shape[:-1]
    L = t.q.numel()
    q = t.q.reshape(L, 1, 1)
    m = 1
    while m < n:
        y = x.reshape(lead + (m, 2, n // (2 * m)))
        w = t.fwd[:, m:2 * m, None]                          # [L, m, 1, 2]
        v = mul_mod_shoup(y[..., 1, :], w[..., 0], w[..., 1], q)
        u = y[..., 0, :]
        x = torch.stack([add_mod(u, v, q), sub_mod(u, v, q)], dim=-2)
        m *= 2
    return x.reshape(lead + (n,))


def inverse_small_plain(x: torch.Tensor, t: SmallTables) -> torch.Tensor:
    """Twin of the small-ring inverse kernel: slots -> natural
    coefficients, the Gentleman-Sande network stage by stage and a final
    multiply by n^-1 (the JAX package's ``ntt.inverse``)."""
    n, lead = t.n, x.shape[:-1]
    L = t.q.numel()
    q = t.q.reshape(L, 1, 1)
    h, s = n // 2, 1
    while h >= 1:
        y = x.reshape(lead + (h, 2, s))
        u, v = y[..., 0, :], y[..., 1, :]
        w = t.inv[:, h:2 * h, None]                          # [L, h, 1, 2]
        bot = mul_mod_shoup(sub_mod(u, v, q), w[..., 0], w[..., 1], q)
        x = torch.stack([add_mod(u, v, q), bot], dim=-2)
        h, s = h // 2, 2 * s
    x = x.reshape(lead + (n,))
    return mul_mod_shoup(x, t.scale[:, 0, 0:1], t.scale[:, 0, 1:2],
                         t.q[:, None])


# ---------------------------------------------------------------------------
# Wrappers: CUDA tensor -> kernel, CPU tensor -> twin
# ---------------------------------------------------------------------------


def _launch(name: str, x: torch.Tensor, t: NTTTables, fwd: bool):
    _build.require_cuda(name, x, t.q)
    out = torch.empty_like(x)
    rows = x.numel() // (t.n1 * t.n2)
    if rows > 65535:
        raise ValueError(f"{name}: {rows} towers exceed one launch's grid")
    w1, w2, tw = (t.w1[0:2], t.w2[0:2], t.tw[0:2]) if fwd else \
        (t.w1[2:4], t.w2[2:4], t.tw[2:4])
    fn = getattr(_build.library(), name)
    _build.check(name, fn(
        x.data_ptr(), out.data_ptr(), rows, t.q.numel(), t.n1, t.n2,
        t.q.data_ptr(), w1[0].data_ptr(), w1[1].data_ptr(),
        w2[0].data_ptr(), w2[1].data_ptr(), tw[0].data_ptr(),
        tw[1].data_ptr(), _build.stream()))
    return out


def _launch_small(name: str, x: torch.Tensor, t: SmallTables, fwd: bool):
    _build.require_cuda(name, x, t.q)
    out = torch.empty_like(x)
    rows = x.numel() // t.n
    if not 0 < rows < 1 << 31:
        raise ValueError(f"{name}: {rows} rows do not fit one launch")
    fn = getattr(_build.library(), name)
    _build.check(name, fn(
        x.data_ptr(), out.data_ptr(), rows, t.q.numel(), t.n.bit_length() - 1,
        t.q.data_ptr(), (t.fwd if fwd else t.inv).data_ptr(),
        t.scale.data_ptr(), _build.stream()))
    return out


def _prepare(x: torch.Tensor, moduli, make=tables):
    """The tables `make` builds for x's ring, after checking x."""
    if x.dtype != torch.int64:
        raise ValueError(f"NTT takes int64 residues, got {x.dtype}")
    t = make(x.shape[-1], moduli, x.device)
    if x.dim() < 2 or x.shape[-2] != t.q.numel():
        raise ValueError(f"NTT input {tuple(x.shape)} does not end in "
                         f"[{t.q.numel()} towers, n]")
    check_reduced(x, t.q[:, None], "ntt")
    return t


def forward(x: torch.Tensor, moduli: Sequence[int]) -> torch.Tensor:
    """Forward negacyclic NTT of [..., L, n] (natural coefficient order) over
    `moduli` into ``ntt.forward``'s bit-reversed evaluation order. Rings up
    to SMALL_MAX_N take ``forward_small``."""
    if x.shape[-1] <= SMALL_MAX_N:
        return forward_small(x, moduli)
    t = _prepare(x, moduli)
    if x.device.type == "cpu":
        return forward_plain(x, t)
    out = _launch("ntt_forward", x.contiguous(), t, True)
    forward.launches += 1
    return out


def inverse(x: torch.Tensor, moduli: Sequence[int]) -> torch.Tensor:
    """Inverse of ``forward`` including the 1/n scaling."""
    if x.shape[-1] <= SMALL_MAX_N:
        return inverse_small(x, moduli)
    t = _prepare(x, moduli)
    if x.device.type == "cpu":
        return inverse_plain(x, t)
    out = _launch("ntt_inverse", x.contiguous(), t, False)
    inverse.launches += 1
    return out


def forward_small(x: torch.Tensor, moduli: Sequence[int]) -> torch.Tensor:
    """``forward`` for a ring of at most SMALL_MAX_N: one launch of
    ``ntt_small_forward`` (any number of rows), or its twin on the CPU."""
    t = _prepare(x, moduli, small_tables)
    if x.device.type == "cpu":
        return forward_small_plain(x, t)
    out = _launch_small("ntt_small_forward", x.contiguous(), t, True)
    forward_small.launches += 1
    return out


def inverse_small(x: torch.Tensor, moduli: Sequence[int]) -> torch.Tensor:
    """``inverse`` for a ring of at most SMALL_MAX_N: one launch of
    ``ntt_small_inverse``, or its twin on the CPU."""
    t = _prepare(x, moduli, small_tables)
    if x.device.type == "cpu":
        return inverse_small_plain(x, t)
    out = _launch_small("ntt_small_inverse", x.contiguous(), t, False)
    inverse_small.launches += 1
    return out


forward.launches = 0
inverse.launches = 0
forward_small.launches = 0
inverse_small.launches = 0
