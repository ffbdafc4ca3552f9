"""Ring-LWE lattice trapdoors (Micciancio-Peikert) and Gaussian preimage
sampling.

Counterpart of ``openfhe_tpu/models/trapdoor.py``, every function by name.
Role of the reference's ``lattice/trapdoor.h`` / ``trapdoor-impl.h``
(``RLWETrapdoorUtility::TrapdoorGen`` / ``GaussSamp``) and the G-lattice
samplers in ``lattice/dgsampling.h``.

Construction (MP12, ring version):
  TrapdoorGen: A = [1, a, g_0 - (a r_0 + e_0), ..., g_{k-1} - (a r_{k-1}
  + e_{k-1})] in R_q^{k+2} with g_i = base^i and short Gaussian (r, e).
  For any x_t in R^k:  A . (r.x_t, e.x_t, x_t) = g.x_t  (the e/r terms
  cancel), so preimages of u reduce to G-lattice preimages of
  v = u - A.p plus a perturbation p.

  GaussSamp: p <- spherical Gaussian perturbation; v = u - A.p;
  z <- randomized Babai nearest-plane on the standard triangular basis of
  the G-lattice coset {z : g.z = v mod q}; x = p + (r.z, e.z, z).

The nearest-plane randomized rounding here draws from a rounded Gaussian
per plane (the reference's exact MP perturbation sampler
``SamplePertSquareMat`` is a further variance correction; preimage
correctness A.x = u and shortness hold identically); ``gauss_samp_exact``
is the exact sampler.

Ring elements are single-tower ``dcrt.RnsPoly`` on the card (or on the CPU
when asked): ``to_eval``/``to_coeff`` run the NTT kernel and every sum of
products (``apply_A``, r.z and e.z, the Gram sums of ``zsample_sigma_p``)
runs as one ``dcrt.mul`` then ``dcrt.mul_add`` (the ``fused_mac_mod``
kernel) a term: the same integers as the reference's ``mul`` + ``add``. The
Gaussian draws, the Field2n recursion and the G-lattice sampling stay on the
host in numpy, in the reference's draw order, so the same numpy Generator
gives the same A, T and preimages.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from .. import _build, dcrt
from ..dcrt import Format, RnsBasis, RnsPoly
from ..utils import sampling
from ..utils.field2n import COEFF, Field2n


@dataclasses.dataclass
class TrapdoorPair:
    """The secret (r, e) short vectors (reference: RLWETrapdoorPair)."""
    r: List[RnsPoly]   # k ring elements, EVAL
    e: List[RnsPoly]


def _ring(basis: RnsBasis, coeffs: np.ndarray, device) -> RnsPoly:
    rows = sampling.signed_to_rns_rows(coeffs.astype(np.int64), basis.moduli)
    return dcrt.to_eval(dcrt.from_int_rows(basis, rows, Format.COEFF, device))


def _gauss_poly(basis: RnsBasis, n: int, sigma: float,
                rng: np.random.Generator, device
                ) -> Tuple[RnsPoly, np.ndarray]:
    c = np.rint(rng.normal(0, sigma, size=n)).astype(np.int64)
    return _ring(basis, c, device), c


def _dot(xs: Sequence[RnsPoly], ys: Sequence[RnsPoly]) -> RnsPoly:
    """sum_i xs[i] * ys[i]: one product, then one fused MAC a term."""
    acc = dcrt.mul(xs[0], ys[0])
    for x, y in zip(xs[1:], ys[1:]):
        acc = dcrt.mul_add(x, y, acc)
    return acc


def _coeffs(p: RnsPoly) -> np.ndarray:
    """A single-tower poly's coefficients in [0, q) as int64."""
    return dcrt.to_int_rows(dcrt.to_coeff(p))[0]


def trapdoor_gen(n: int, q: int, base: int, sigma: float,
                 rng: np.random.Generator, device=None):
    """(role of RLWETrapdoorUtility::TrapdoorGen.) Returns (A, T) with
    A a list of k+2 ring elements and T the trapdoor, on `device` (None:
    the current CUDA device)."""
    device = _build.resolve_device(device)
    basis = RnsBasis(n, (q,))
    k = -(-q.bit_length() // int(np.log2(base)))
    a_rows = sampling.uniform_rns_rows(n, basis.moduli, rng)
    a = dcrt.from_int_rows(basis, a_rows, Format.EVAL, device)
    one = _ring(basis, np.array([1] + [0] * (n - 1)), device)
    rs, es, A_tail = [], [], []
    for i in range(k):
        g_i = pow(base, i, q)
        r_p, _ = _gauss_poly(basis, n, sigma, rng, device)
        e_p, _ = _gauss_poly(basis, n, sigma, rng, device)
        rs.append(r_p)
        es.append(e_p)
        g_poly = _ring(basis, np.array([g_i] + [0] * (n - 1)), device)
        A_tail.append(dcrt.sub(g_poly, dcrt.mul_add(a, r_p, e_p)))
    return [one, a] + A_tail, TrapdoorPair(rs, es)


def _g_lattice_basis(q: int, base: int, k: int) -> np.ndarray:
    """Triangular basis of Lambda^perp(g) = {z : sum z_i base^i = 0 mod q}
    (columns; reference: the S matrix of dgsampling)."""
    assert base ** k > q >= base ** (k - 1), \
        "k must satisfy base^(k-1) <= q < base^k (nonzero top digit)"
    S = np.zeros((k, k), dtype=np.int64)
    for i in range(k - 1):
        S[i, i] = base
        S[i + 1, i] = -1
    # last column: the base-b digits of q
    rem = q
    for i in range(k):
        S[i, k - 1] = rem % base
        rem //= base
    return S


def _g_congruent(z: np.ndarray, v: np.ndarray, q: int, base: int,
                 k: int) -> bool:
    """sum_i base^i z_i == v mod q, coefficient by coefficient."""
    g = np.array([pow(base, i, q) for i in range(k)], dtype=object)
    return bool(np.all((np.tensordot(g, z.astype(object), axes=(0, 0))
                        - v.astype(object)) % q == 0))


def _g_preimage(v: np.ndarray, q: int, base: int, k: int, sigma: float,
                rng: np.random.Generator) -> np.ndarray:
    """Sample short z [k, n] with sum_i z_i base^i = v mod q, per
    coefficient, via randomized Babai nearest-plane on the triangular
    G-lattice basis (role of LatticeGaussSampUtility::GaussSampGqArbBase).
    """
    n = v.shape[0]
    # initial (long) solution: plain digits of v
    t = np.zeros((k, n), dtype=np.int64)
    rem = v.astype(np.int64) % q
    for i in range(k):
        t[i] = rem % base
        rem //= base
    S = _g_lattice_basis(q, base, k)
    # Gram-Schmidt norms of the triangular S are ~base; randomized
    # nearest-plane from the last column back
    z = t.astype(np.float64)
    coeffs = np.zeros((k, n), dtype=np.int64)
    for j in range(k - 1, -1, -1):
        # project onto plane j: c = <z, b*_j>/<b*_j, b*_j> ~ z_j / S[j, j]
        c = z[j] / float(S[j, j])
        ci = np.rint(c + rng.normal(0, sigma / float(S[j, j]), size=n)
                     ).astype(np.int64)
        coeffs[j] = ci
        z -= S[:, j:j + 1] * ci[None, :]
    out = t - S @ coeffs
    assert _g_congruent(out, v, q, base, k)
    return out


def _preimage(basis: RnsBasis, T: TrapdoorPair, ps: List[RnsPoly],
              z: np.ndarray) -> List[RnsPoly]:
    """x = p + (e.z, r.z, z): the "1" slot carries e.z and the "a" slot
    r.z, so that 1*(e.z) + a*(r.z) cancels the -(a r_i + e_i) z_i terms."""
    device = ps[0].device
    z_polys = [_ring(basis, z[i], device) for i in range(len(T.r))]
    rz = _dot(T.r, z_polys)
    ez = _dot(T.e, z_polys)
    x = [dcrt.add(ps[0], ez), dcrt.add(ps[1], rz)]
    x += [dcrt.add(p, zp) for p, zp in zip(ps[2:], z_polys)]
    return x


def gauss_samp(n: int, q: int, base: int, A: List[RnsPoly],
               T: TrapdoorPair, u: RnsPoly, sigma: float,
               rng: np.random.Generator) -> List[RnsPoly]:
    """Sample x in R^{k+2} with A.x = u (role of
    RLWETrapdoorUtility::GaussSamp), on the device of A."""
    basis = RnsBasis(n, (q,))
    k = len(T.r)
    s_big = sigma * (base + 1) * np.sqrt(float(k * n))  # spectral slack
    # 1. perturbation p and v = u - A.p
    ps = [_gauss_poly(basis, n, s_big, rng, A[0].device)[0]
          for _ in range(k + 2)]
    v_coeffs = _coeffs(dcrt.sub(u, apply_A(A, ps)))
    # 2. G-lattice preimage of v; 3. x = p + (e.z, r.z, z)
    z = _g_preimage(v_coeffs, q, base, k, sigma, rng)
    return _preimage(basis, T, ps, z)


def apply_A(A: List[RnsPoly], x: List[RnsPoly]) -> RnsPoly:
    return _dot(A, x)


# ---------------------------------------------------------------------------
# Exact Micciancio-Peikert perturbation sampling (eprint 2017/844 Alg. 4)
# and the discrete-variant G-lattice sampler (eprint 2017/308 Fig. 2).
# Role of the reference's ``lattice/dgsampling{,-impl}.h``
# (LatticeGaussSampUtility::GaussSampGq / ZSampleSigma2x2 / ZSampleF) and
# ``lattice/trapdoor-impl.h`` ZSampleSigmaP. Field arithmetic rides
# utils/field2n.py on the host; integer rounding uses numpy-rounded
# Gaussians (utils/prng.py has the exact Karney/inversion DGG).
# ---------------------------------------------------------------------------

# constants verbatim from ``dgsampling.h:52-66``
DG_ERROR = 8.27181e-25
N_MAX = 16384
SIGMA = float(np.sqrt(np.log(2 * N_MAX / DG_ERROR) / np.pi))
SPECTRAL_CONSTANT = 1.8


def spectral_bound(n: int, k: int, base: int) -> float:
    """(``dgsampling.h:63-65``.)"""
    return (SPECTRAL_CONSTANT * (base + 1) * SIGMA * SIGMA
            * (np.sqrt(n * k) + np.sqrt(2 * n) + 4.7))


def _dgg(rng: np.random.Generator, mean, sigma):
    """Rounded-Gaussian integer sample(s) centered at ``mean``."""
    return np.rint(np.asarray(mean) + rng.normal(0.0, sigma,
                                                 np.shape(mean))).astype(
        np.int64)


def zsample_f(f: Field2n, c: Field2n, rng: np.random.Generator
              ) -> np.ndarray:
    """SampleF (``dgsampling-impl.h:442-476`` ZSampleF): sample an
    integer vector with covariance f and center c, by even/odd splitting
    into a half-size 2x2 Schur system. f, c in COEFF format."""
    if len(f) == 1:
        var = max(float(f.data[0].real), 1e-12)
        return np.array([_dgg(rng, float(c.data[0].real), np.sqrt(var))],
                        dtype=np.int64).reshape(1)
    f0 = f.extract_even().to_eval()
    f1 = f.extract_odd().to_eval()
    q = zsample_sigma_2x2(f0, f1, f0, c.extract_even(), c.extract_odd(),
                          rng)
    # InversePermute: [even half | odd half] -> interleaved
    out = np.empty(len(f), dtype=np.int64)
    h = len(f) // 2
    out[0::2] = q[:h]
    out[1::2] = q[h:]
    return out


def zsample_sigma_2x2(a: Field2n, b: Field2n, d: Field2n,
                      c0: Field2n, c1: Field2n,
                      rng: np.random.Generator) -> np.ndarray:
    """(``dgsampling-impl.h:271-305``): sample [q1; q2] with the 2x2
    block covariance [[a, b], [b*, d]] centered at (c0, c1). a/b/d in
    EVAL format, c0/c1 in COEFF."""
    q2 = zsample_f(d.to_coeff(), c1, rng)
    q2_minus_c2 = (Field2n.from_ints(q2, COEFF) - c1).to_eval()
    product = (b * d.inverse() * q2_minus_c2).to_coeff()
    c1_new = c0 + product
    f = (a - b * d.inverse() * b.transpose()).to_coeff()
    q1 = zsample_f(f, c1_new, rng)
    return np.concatenate([q1, q2])


def _poly_to_reals(p: RnsPoly, q: int) -> np.ndarray:
    """Center-lift a single-tower EVAL poly's COEFFICIENTS to doubles."""
    vals = _coeffs(p)
    return np.where(vals > q // 2, vals - q, vals).astype(np.float64)


def _field(p: RnsPoly, q: int, scale: float) -> Field2n:
    return Field2n(_poly_to_reals(p, q).astype(np.complex128),
                   COEFF).scalar_mult(scale)


def zsample_sigma_p(n: int, q: int, s: float, sigma_c: float,
                    T: TrapdoorPair, rng: np.random.Generator
                    ) -> List[RnsPoly]:
    """Perturbation vector with covariance s^2 I - sigma_c^2 [R;E;I]
    [R;E;I]^t (``trapdoor-impl.h:118-255`` ZSampleSigmaP): returns
    k + 2 EVAL ring elements on the device of T."""
    basis = T.r[0].basis
    device = T.r[0].device
    k = len(T.r)

    def conj(p):
        return dcrt.automorphism(p, 2 * n - 1)

    e_t = [conj(e) for e in T.e]
    va = _dot(T.e, e_t)
    vb = _dot(T.r, e_t)
    vd = _dot(T.r, [conj(r) for r in T.r])

    sf = -s * s * sigma_c * sigma_c / (s * s - sigma_c * sigma_c)
    a = _field(va, q, sf).plus_scalar(s * s).to_eval()
    b = _field(vb, q, sf).to_eval()
    d = _field(vd, q, sf).plus_scalar(s * s).to_eval()

    # p2: k ring elements ~ N(0, sqrt(s^2 - sigma_c^2))
    sigma_large = np.sqrt(s * s - sigma_c * sigma_c)
    p2_ints = _dgg(rng, np.zeros((k, n)), sigma_large)
    p2 = [_ring(basis, p2_ints[i], device) for i in range(k)]

    # centers: -sigma_c^2/(s^2 - sigma_c^2) * (E p2, R p2)
    cf = -sigma_c * sigma_c / (s * s - sigma_c * sigma_c)
    c0 = _field(_dot(T.e, p2), q, cf)
    c1 = _field(_dot(T.r, p2), q, cf)

    p1 = zsample_sigma_2x2(a, b, d, c0, c1, rng)
    return [_ring(basis, p1[:n], device), _ring(basis, p1[n:], device)] + p2


def gauss_samp_gq(v: np.ndarray, stddev: float, k: int, q: int, base: int,
                  rng: np.random.Generator) -> np.ndarray:
    """Discrete-variant G-lattice sampler, vectorized over all n
    coefficients (``dgsampling-impl.h:56-127`` GaussSampGq +
    Perturb/SampleC): returns z [k, n] with sum_i base^i z_i = v mod q
    and near-spherical discrete-Gaussian distribution of width stddev."""
    n = len(v)
    sigma = stddev / (base + 1)
    m_digits = np.zeros(k, dtype=np.int64)
    rem = q
    for i in range(k):
        m_digits[i] = rem % base
        rem //= base
    # L-matrix diagonals (``:79-87``)
    l = np.zeros(k)  # noqa: E741 (the reference's name)
    h = np.zeros(k)
    l[0] = np.sqrt(base * (1 + 1.0 / k) + 1)
    for i in range(1, k):
        l[i] = np.sqrt(base * (1 + 1.0 / (k - i)))
    for i in range(1, k):
        h[i] = np.sqrt(base * (1 - 1.0 / (k - (i - 1))))
    c = np.zeros(k)
    c[0] = m_digits[0] / base
    for i in range(1, k):
        c[i] = (c[i - 1] + m_digits[i]) / base

    v_digits = np.zeros((k, n), dtype=np.int64)
    rem = np.asarray(v, dtype=np.int64) % q
    for i in range(k):
        v_digits[i] = rem % base
        rem //= base

    # Perturb (``:208-223``), vectorized over coefficients
    z = np.zeros((k, n), dtype=np.int64)
    dval = np.zeros(n)
    for i in range(k):
        z[i] = _dgg(rng, dval / l[i], sigma / l[i])
        dval = -z[i] * h[i]
    p = np.zeros((k, n), dtype=np.int64)
    p[0] = (2 * base + 1) * z[0] + base * z[1]
    for i in range(1, k - 1):
        p[i] = base * (z[i - 1] + 2 * z[i] + z[i + 1])
    p[k - 1] = base * (z[k - 2] + 2 * z[k - 1])

    # a recursion + SampleC (``:254-264``)
    a = np.zeros((k, n))
    a[0] = (v_digits[0] - p[0]) / base
    for t in range(1, k):
        a[t] = (a[t - 1] + v_digits[t] - p[t]) / base
    zc = np.zeros((k, n), dtype=np.int64)
    zc[k - 1] = _dgg(rng, -a[k - 1] / c[k - 1], sigma / c[k - 1])
    a = a + zc[k - 1][None, :] * c[:, None]
    for i in range(k - 1):
        zc[i] = _dgg(rng, -a[i], sigma)

    out = np.zeros((k, n), dtype=np.int64)
    out[0] = base * zc[0] + m_digits[0] * zc[k - 1] + v_digits[0]
    for t in range(1, k - 1):
        out[t] = (base * zc[t] - zc[t - 1] + m_digits[t] * zc[k - 1]
                  + v_digits[t])
    out[k - 1] = m_digits[k - 1] * zc[k - 1] - zc[k - 2] + v_digits[k - 1]
    return out


def gauss_samp_exact(n: int, q: int, base: int, A: List[RnsPoly],
                     T: TrapdoorPair, u: RnsPoly,
                     rng: np.random.Generator) -> List[RnsPoly]:
    """GaussSamp with the EXACT MP perturbation (``trapdoor-impl.h:38-94``
    GaussSampOffline + GaussSampOnline): p ~ Sigma_p via ZSampleSigmaP,
    then the G-lattice sample of the perturbed syndrome at width
    (base+1) * SIGMA."""
    basis = RnsBasis(n, (q,))
    k = len(T.r)
    c_param = (base + 1) * SIGMA
    s = spectral_bound(n, k, base)

    ps = zsample_sigma_p(n, q, s, c_param, T, rng)
    v_coeffs = _coeffs(dcrt.sub(u, apply_A(A, ps)))
    z = gauss_samp_gq(v_coeffs, c_param, k, q, base, rng)
    assert _g_congruent(z, v_coeffs, q, base, k)
    return _preimage(basis, T, ps, z)
