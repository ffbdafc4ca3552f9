"""The port's NTT (``openfhe_tpu_torch.ops.ntt``) against the JAX package's,
bit for bit: the XLA transform (``ntt.forward_jit``/``inverse_jit``), the
Pallas four-step kernels in interpret mode, and the kernels' tables.

On the CPU ``ntt.forward``/``inverse`` run the kernels' plain twin, which
follows the kernels' own decomposition (column stages, twist, row stages),
so these tests check the kernels' tables, stage geometry and output order;
``tests/test_torch_cuda.py`` checks the CUDA indexing on the card. The
schedule of the main-path kernel (radix-16 rounds on register fields, lazy
butterflies) is replayed here in Python ints against the twin's stages, and
the batched call sites that feed the kernel (one mod-down for both key-switch
outputs, one rescale for all polynomials) against their per-polynomial form.
"""

import numpy as np
import pytest
import torch

from openfhe_tpu.ops import limb
from openfhe_tpu.ops import ntt as jntt
from openfhe_tpu.ops import ntt_pallas
from openfhe_tpu.parallel import dntt
from openfhe_tpu.utils import nbtheory
from openfhe_tpu_torch import convert, dcrt, keyswitch
from openfhe_tpu_torch.models import ckks
from openfhe_tpu_torch.ops import elementwise, ntt, rns


def _uniform(moduli, lead, n, seed):
    """[*lead, L, n] reduced residues as int64."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, q, size=lead + (n,), dtype=np.uint64)
            for q in moduli]
    return np.stack(cols, axis=-2).astype(np.int64)


def _to_jax(x):
    return limb.from_int_array(x)


def _from_jax(u):
    return convert.u64_to_tensor(u.lo, u.hi, "cpu")


@pytest.mark.parametrize("n", [16, 256, 2048])
@pytest.mark.parametrize("bits", [30, 59, 61])
def test_forward_inverse_match_xla(n, bits):
    moduli = tuple(nbtheory.generate_prime_chain(3, bits, n))
    x = _uniform(moduli, (2,), n, seed=n * bits)         # [2, 3, n]
    plan = jntt.make_plan(n, moduli)
    want = jntt.forward_jit(plan, _to_jax(x))
    got = ntt.forward(torch.from_numpy(x), moduli)
    assert torch.equal(got, _from_jax(want))
    back = ntt.inverse(got, moduli)
    assert torch.equal(back, _from_jax(jntt.inverse_jit(plan, want)))
    assert torch.equal(back, torch.from_numpy(x))


@pytest.mark.parametrize("n1,n2", [(None, None), (64, 8)])
def test_matches_pallas_kernels(n1, n2):
    """n = 512 in Pallas interpret mode, with the balanced split (32, 16) and
    the uneven one (64, 8): the port always splits (32, 16), and every split
    gives the same slots."""
    n = 512
    moduli = tuple(nbtheory.generate_prime_chain(2, 55, n))
    x = _uniform(moduli, (), n, seed=99)
    want = ntt_pallas.forward(_to_jax(x), moduli, n1=n1, n2=n2,
                              interpret=True)
    got = ntt.forward(torch.from_numpy(x), moduli)
    assert torch.equal(got, _from_jax(want))
    back = ntt_pallas.inverse(want, moduli, n1=n1, n2=n2, interpret=True)
    assert torch.equal(ntt.inverse(got, moduli), _from_jax(back))


@pytest.mark.parametrize("n1,n2", [(32, 16), (64, 8), (16, 16)])
def test_twist_tables_match_pallas(n1, n2):
    moduli = tuple(nbtheory.generate_prime_chain(2, 59, n1 * n2))
    fwd, inv = ntt_pallas._twist_tables(n1, n2, moduli)
    for l, q in enumerate(moduli):
        port = ntt.twist_tables(n1, n2, q).view(np.uint64)
        for k, (lo, hi) in enumerate([fwd[0:2], fwd[2:4], inv[0:2],
                                      inv[2:4]]):
            want = (hi[l].astype(np.uint64) << np.uint64(32)) | lo[l]
            assert np.array_equal(port[k], want), (q, k)


@pytest.mark.parametrize("R", [8, 32, 256])
@pytest.mark.parametrize("forward", [True, False])
def test_stage_tables_match_pallas_rows(R, forward):
    """The port's flat bit-reversed tables, read at [groups + r // (2t)] as
    the kernel's stages read them, give the Pallas per-row twiddles."""
    moduli = tuple(nbtheory.generate_prime_chain(2, 61, R))
    w_lo, w_hi, p_lo, p_hi, _ = ntt_pallas._row_tables(R, moduli, forward)
    geo = ntt_pallas._stage_geometry(R, forward)
    r = np.arange(R)
    for l, q in enumerate(moduli):
        tab = ntt.stage_tables(R, q).view(np.uint64)
        w, wp = (tab[0], tab[1]) if forward else (tab[2], tab[3])
        for s, (t, base) in enumerate(geo):
            idx = base + r // (2 * t)
            want_w = (w_hi[l, :, s].astype(np.uint64) << np.uint64(32)) \
                | w_lo[l, :, s]
            want_p = (p_hi[l, :, s].astype(np.uint64) << np.uint64(32)) \
                | p_lo[l, :, s]
            assert np.array_equal(w[idx], want_w)
            assert np.array_equal(wp[idx], want_p)


def test_split_factors_match_dntt():
    for n in (2, 16, 512, 1 << 16, 1 << 17):
        assert ntt.split_factors(n) == dntt.split_factors(n)


def test_rejects_bad_inputs(monkeypatch):
    n = 64
    moduli = tuple(nbtheory.generate_prime_chain(2, 30, n))
    x = torch.from_numpy(_uniform(moduli, (), n, seed=1))
    with pytest.raises(ValueError):
        ntt.forward(x[:1], moduli)                       # towers != L
    with pytest.raises(ValueError):
        ntt.forward(x.to(torch.int32), moduli)
    with pytest.raises(ValueError):
        ntt.forward(x[:1], (97,))                        # not NTT-friendly
    bad = x.clone()
    bad[0, 0] = moduli[0]                                # not reduced
    ntt.forward(bad, moduli)                             # unchecked by default
    monkeypatch.setenv("OPENFHE_TPU_TORCH_CHECK", "1")
    with pytest.raises(ValueError):
        ntt.forward(bad, moduli)


def _radix16_rounds(x, tab, q, log_r, fwd):
    """One size-2^log_r transform by the schedule of ``csrc/ntt.cu``'s main
    path, in Python ints: round K runs the stages on index bits BLO..BHI in a
    thread that holds the 16 elements whose bits P..P+3 vary; the butterfly on
    bit b of element i reads twiddle (R + i) >> (b + 1); butterflies are lazy
    (``modarith.cuh``), with the value ranges asserted at every step."""
    R, M = 1 << log_r, (1 << 64) - 1
    w, wp = ([int(v) for v in tab[k].view(np.uint64)]
             for k in ((0, 1) if fwd else (2, 3)))
    bound = 4 * q if fwd else 2 * q

    def shoup_lazy(y, j):
        r = (y * w[j] - ((y * wp[j]) >> 64) * q) & M
        assert r < 2 * q
        return r

    v = [int(a) for a in x]
    for K in range((log_r + 3) // 4):
        if fwd:
            bhi = log_r - 1 - 4 * K
            blo = max(bhi - 3, 0)
            P, bits = blo, range(bhi, blo - 1, -1)
        else:
            blo, bhi = 4 * K, min(4 * K + 3, log_r - 1)
            P, bits = bhi - 3, range(blo, bhi + 1)
        assert P >= 0
        seen = set()
        for u in range(R // 16):
            ibase = ((u >> P) << (P + 4)) | (u & ((1 << P) - 1))
            idx = [ibase | (f << P) for f in range(16)]
            seen.update(idx)
            loc = [v[i] for i in idx]
            for beta in bits:
                lam = beta - P
                t = (R + ibase) >> (beta + 1)
                for g in range(8 >> lam):
                    for k in range(1 << lam):
                        f = (g << (lam + 1)) | k
                        a, b = loc[f], loc[f | (1 << lam)]
                        assert a < bound and b < bound
                        if fwd:
                            a = a - 2 * q if a >= 2 * q else a
                            m = shoup_lazy(b, t + g)
                            a, b = a + m, a - m + 2 * q
                        else:
                            s, d = a + b, a - b + 2 * q
                            a = s - 2 * q if s >= 2 * q else s
                            b = shoup_lazy(d, t + g)
                        assert a < bound and b < bound
                        loc[f], loc[f | (1 << lam)] = a, b
            for i, a in zip(idx, loc):
                v[i] = a
        assert seen == set(range(R))       # every element in exactly one thread
    return [a % q for a in v]


@pytest.mark.parametrize("log_r", [6, 7, 8, 9])
@pytest.mark.parametrize("fwd", [True, False])
@pytest.mark.parametrize("bits", [30, 61])
def test_radix16_schedule_matches_twin_stages(log_r, fwd, bits):
    R = 1 << log_r
    q = nbtheory.generate_prime_chain(1, bits, R)[0]
    x = _uniform((q,), (), R, seed=log_r + bits)[0]
    x[:4] = [q - 1, 0, q - 1, 1]
    tab = ntt.stage_tables(R, q)
    t = torch.from_numpy(tab)[:, None]                        # [4, L=1, R]
    k = 0 if fwd else 2
    want = ntt._stages(torch.from_numpy(x).reshape(1, R, 1), t[k], t[k + 1],
                       torch.tensor([q]), fwd, 0)
    got = _radix16_rounds(x, tab, q, log_r, fwd)
    assert got == want.reshape(R).tolist()


@pytest.mark.parametrize("composite", [1, 2], ids=["60bit", "composite"])
def test_batched_call_sites_match_per_polynomial_form(composite):
    """n = 256: the key switch's mod-down over both outputs at once and the
    rescale over the stacked polynomials give the residues of the
    per-polynomial form."""
    params = ckks.CKKSParams(ring_dim=256, mult_depth=3, scaling_mod_size=59,
                             first_mod_size=60, dnum=3,
                             composite_degree=composite)
    ctx = ckks.gen_context(params, "cpu")
    rng = np.random.default_rng(21)
    pk, sk = ckks.keygen(ctx, rng)
    evk = ckks.relin_keygen(ctx, sk, rng)
    n, ks = ctx.n, evk.params
    lvl = len(ctx.q_moduli) - composite                       # one level down
    q_act, eb = ctx.q_moduli[:lvl], keyswitch.ext_basis(ks, lvl)
    basis = dcrt.RnsBasis(n, q_act)
    ndig = ks.num_digits(lvl)
    digits = torch.from_numpy(_uniform(eb.moduli, (ndig,), n, seed=22))
    got = keyswitch.hoist_inner_product(evk, digits, basis)
    Lfull = len(ks.q_moduli)
    rows = list(range(lvl)) + list(range(Lfull, Lfull + len(ks.p_moduli)))
    accs = elementwise.ks_inner_product(digits, evk.b, evk.a, rows,
                                        eb.mod("cpu"))
    assert accs.shape == (2, lvl + len(ks.p_moduli), n)
    for half, acc in zip(got, accs):
        cc = ntt.inverse(acc, eb.moduli)
        down = rns.approx_mod_down(cc[:lvl], cc[lvl:], q_act, ks.p_moduli)
        assert torch.equal(half.data, ntt.forward(down, q_act))

    ct = ckks.eval_mult(ckks.encrypt(ctx, pk, rng.uniform(-1, 1, n // 2), rng),
                        ckks.encrypt(ctx, pk, rng.uniform(-1, 1, n // 2), rng))
    res = ckks.rescale_ctx(ctx, ct)
    assert len(res.polys) == 3
    for p, r in zip(ct.polys, res.polys):
        data, moduli = p.data, ctx.q_moduli
        for _ in range(composite):
            data = rns.rescale_eval(data, moduli)
            moduli = moduli[:-1]
        assert r.basis.moduli == moduli and torch.equal(r.data, data)
