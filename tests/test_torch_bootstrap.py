"""The port's CKKS bootstrap against the JAX package's, bit for bit.

Tier 1 holds every stage alone against the JAX package, each at a size
where the JAX stage is cheap: the host-side constants (``ckks_fft``'s
factors, ``stc_matrices``, ``setup``, the Chebyshev coefficients, the
rotation sets), and at n = 512 with three towers the keys and, fed one input
through ``openfhe_tpu_torch.convert``, ``mod_raise``, a fold step, the dense
and the staged linear transforms, ``_mult_i``, ``_mult_by_int`` and
``_normalize_scale``. The JAX side runs once, in a module-scoped fixture.
The port's own whole bootstrap runs on the CPU without JAX and must decrypt
within 5e-2.

The tests marked ``slow`` run the whole bootstrap of both packages from one
seed and compare every stage's ciphertext (raised, folded, CoeffsToSlots,
both sine branches, SlotsToCoeffs) and the decoded slots: the dense path,
the staged ``level_budget=(2, 2)`` path and the iterative bootstrap. The
JAX side runs jitted. Each fixture takes about 9 minutes cold on an 8-core
CPU (the three tests 18 minutes alone), so they are left out of tier 1
(``-m 'not slow'``).

Depths: the pipeline spends 15 levels (CoeffsToSlots 1, the sine's
normalisation 2, Chebyshev 6, double angles 5, SlotsToCoeffs 1; the staged
transforms one more each), so the n = 512 configuration of
``tests/test_bootstrap.py`` (depth 14) and of ``tests/test_bootstrap_fft.py``
(depth 16) leave no level for SlotsToCoeffs. The bootstraps here take the
same parameters at depths 18 and 20, which regain 4 towers.
"""

import numpy as np
import pytest
import torch

from openfhe_tpu import dcrt as jdcrt
from openfhe_tpu.models import ckks as jckks
from openfhe_tpu.models import ckks_advanced as jadv
from openfhe_tpu.models import ckks_bootstrap as jboot
from openfhe_tpu.models import ckks_fft as jfft
from openfhe_tpu.ops import automorph as jautomorph
from openfhe_tpu.ops import limb
from openfhe_tpu_torch import convert, dcrt
from openfhe_tpu_torch.models import ckks, ckks_advanced as adv
from openfhe_tpu_torch.models import ckks_bootstrap as boot
from openfhe_tpu_torch.models import ckks_fft as cfft
from openfhe_tpu_torch.ops import automorph
from openfhe_tpu_torch.utils import nbtheory

BOOT = dict(ring_dim=512, scaling_mod_size=35, first_mod_size=50, dnum=3,
            secret_hw=64)
STAGES = dict(BOOT, mult_depth=2)        # three towers: each stage alone
DENSE = dict(BOOT, mult_depth=18)        # the dense bootstrap, 4 regained
STAGED = dict(BOOT, mult_depth=20)       # level_budget (2, 2), 4 regained
VALUES4 = np.array([0.25, -0.5, 0.75, 0.125])
VALUES8 = np.array([0.25, -0.5, 0.75, 0.125, -0.25, 0.5, -0.75, 0.0625])


def _same_poly(jp, tp):
    return (jp.basis.moduli == tp.basis.moduli and jp.fmt.value ==
            tp.fmt.value and torch.equal(convert.poly_from_jax(jp, "cpu").data,
                                         tp.data))


def _same_ct(jct, tct):
    return (len(jct.polys) == len(tct.polys) and jct.scale == tct.scale
            and all(_same_poly(a, b) for a, b in zip(jct.polys, tct.polys)))


def _same_key(jk, tk):
    k = convert.kskey_from_jax(jk, "cpu")
    return (k.params == tk.params and torch.equal(k.b, tk.b)
            and torch.equal(k.a, tk.a))


def _same_value(a, b):
    """Host constants: equal arrays (dtype included), dicts and lists of
    them, or equal plain values."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same_value(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(_same_value(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


# --- host constants ----------------------------------------------------------


FFT_CASES = [(s, budget) for s in (4, 8, 32, 128)
             for budget in range(1, s.bit_length())]


@pytest.mark.parametrize("s,budget", FFT_CASES)
def test_fft_factors(s, budget):
    assert _same_value(cfft.cts_factors(s, budget),
                       jfft.cts_factors(s, budget))
    assert _same_value(cfft.stc_factors(s, budget, fold=2.5),
                       jfft.stc_factors(s, budget, fold=2.5))
    assert _same_value(cfft.bitrev_perm(s), jfft.bitrev_perm(s))
    factors = cfft.cts_factors(s, budget) + cfft.stc_factors(s, budget)
    assert cfft.factors_rotations(factors) == jfft.factors_rotations(factors)


@pytest.mark.parametrize("n,s", [(128, 4), (512, 4), (512, 8), (512, 128),
                                 (4096, 16)])
def test_stc_matrices(n, s):
    A, D = boot.stc_matrices(n, s)
    jA, jD = jboot.stc_matrices(n, s)
    assert _same_value(A, jA) and _same_value(D, jD)


@pytest.mark.parametrize("kw", [dict(slots=4), dict(slots=8, K=12, r=4,
                                                    cheb_deg=20),
                                dict(slots=8, level_budget=(2, 2)),
                                dict(slots=32, level_budget=(3, 2))],
                         ids=["dense", "dense-K12", "staged-2-2",
                              "staged-3-2"])
def test_setup_fields(kw):
    params = dict(BOOT, mult_depth=2, secret_hw=0)
    pre = boot.setup(ckks.gen_context(ckks.CKKSParams(**params), "cpu"), **kw)
    jpre = jboot.setup(jckks.gen_context(jckks.CKKSParams(**params)), **kw)
    assert _same_value(convert.bootstrap_precomp_to_numpy(pre),
                       {f: getattr(jpre, f) for f in convert._PRECOMP_FIELDS})
    assert pre.staged == jpre.staged
    back = convert.bootstrap_precomp_from_jax(jpre)
    assert _same_value(convert.bootstrap_precomp_to_numpy(back),
                       convert.bootstrap_precomp_to_numpy(pre))


@pytest.mark.parametrize("fn,a,b,degree", [
    (lambda u: np.cos(2.0 * np.pi * u), -17 / 32, 17 / 32, 28),
    (np.exp, -1.0, 1.0, 7),
    (lambda x: 1.0 / (1.0 + np.exp(-x)), -4.0, 4.0, 24)],
    ids=["bootstrap-cos", "exp", "logistic"])
def test_chebyshev_coefficients(fn, a, b, degree):
    assert _same_value(adv.chebyshev_coefficients(fn, a, b, degree),
                       jadv.chebyshev_coefficients(fn, a, b, degree))


@pytest.mark.parametrize("n,s", [(512, 4), (512, 8), (512, 128), (512, 256),
                                 (1 << 16, 4), (1 << 16, 1024)])
def test_rotation_index_sets(n, s):
    assert boot.lt_rotation_indices(s) == jboot.lt_rotation_indices(s)
    assert (boot.partial_sum_rotations(n, s)
            == jboot.partial_sum_rotations(n, s))


# --- the conjugation automorphism and the dcrt additions ---------------------


def _uniform(moduli, lead, n, seed):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, q, size=lead + (n,), dtype=np.uint64)
            for q in moduli]
    return np.stack(cols, axis=-2)                  # [lead, L, n] uint64


def _jax_u64(x):
    return limb.U64((x & 0xFFFFFFFF).astype(np.uint32),
                    (x >> np.uint64(32)).astype(np.uint32))


@pytest.mark.parametrize("n", [128, 512])
def test_conjugation_on_the_digit_stack(n):
    """sigma_{2n-1} (complex conjugation of the slots), which the bootstrap
    applies to a hoisted digit stack [ndig, L, n]: the port's permutation
    and gather equal the JAX package's, and in both formats its dcrt
    automorphism does too."""
    k = 2 * n - 1
    assert np.array_equal(automorph.eval_perm(n, k),
                          jautomorph.eval_perm(n, k))
    moduli = tuple(nbtheory.generate_prime_chain(4, 55, n))
    x = _uniform(moduli, (3,), n, seed=n)
    want = jautomorph.apply_eval(_jax_u64(x), n, k)
    got = automorph.apply_eval(torch.from_numpy(x.astype(np.int64)), n, k)
    assert torch.equal(convert.u64_to_tensor(want.lo, want.hi, "cpu"), got)
    basis_j, basis_t = jdcrt.RnsBasis(n, moduli), dcrt.RnsBasis(n, moduli)
    for jfmt, tfmt in ((jdcrt.Format.EVAL, dcrt.Format.EVAL),
                       (jdcrt.Format.COEFF, dcrt.Format.COEFF)):
        jp = jdcrt.automorphism(jdcrt.make_poly(basis_j, _jax_u64(x[0]), jfmt),
                                k)
        tp = dcrt.automorphism(dcrt.make_poly(
            basis_t, torch.from_numpy(x[0].astype(np.int64)), tfmt), k)
        assert _same_poly(jp, tp)


def test_dcrt_additions():
    """make_poly takes a tower slice contiguous; zero_poly and
    mul_tower_const equal the JAX package's."""
    n = 128
    moduli = tuple(nbtheory.generate_prime_chain(3, 45, n))
    x = _uniform(moduli, (2,), n, seed=1)
    stacked = torch.from_numpy(x.astype(np.int64))
    part = dcrt.make_poly(dcrt.RnsBasis(n, moduli[:2]), stacked[1, :2],
                          dcrt.Format.EVAL)
    assert part.data.is_contiguous()
    assert torch.equal(part.data, stacked[1, :2])
    assert _same_poly(jdcrt.zero_poly(jdcrt.RnsBasis(n, moduli)),
                      dcrt.zero_poly(dcrt.RnsBasis(n, moduli), device="cpu"))
    consts = (16 % moduli[0], moduli[1] - 1, 12345)
    jp = jdcrt.make_poly(jdcrt.RnsBasis(n, moduli), _jax_u64(x[0]),
                         jdcrt.Format.EVAL)
    tp = dcrt.make_poly(dcrt.RnsBasis(n, moduli),
                        torch.from_numpy(x[0].astype(np.int64)),
                        dcrt.Format.EVAL)
    assert _same_poly(jdcrt.mul_tower_const(jp, consts),
                      dcrt.mul_tower_const(tp, consts))


# --- stages at n = 512, three towers -----------------------------------------


def _stage_run(mod, booted, jax_run=None):
    """Every stage's output. `mod`, `booted`: one package's ckks and
    ckks_bootstrap. Both make their keys from one seed; the stages of the
    port run on the JAX run's keys and ciphertext, carried over through
    convert (`jax_run`)."""
    port = mod is ckks
    ctx = mod.gen_context(mod.CKKSParams(**STAGES),
                          *(("cpu",) if port else ()))
    rng = np.random.default_rng(3)
    pk, sk = mod.keygen(ctx, rng)
    dense = booted.setup(ctx, slots=4)
    staged = booted.setup(ctx, slots=4, level_budget=(2, 2))
    made = booted.keygen(ctx, sk, staged, rng)  # covers the dense set too
    out = dict(ctx=ctx, keys=made, dense=dense, staged=staged)
    if port:
        keys = convert.bootstrap_keys_from_jax(jax_run["keys"], "cpu")
        ct = convert.ciphertext_from_jax(jax_run["ct"], "cpu")
    else:
        keys = made
        ct = mod.encrypt(ctx, pk, np.tile(VALUES4, ctx.params.num_slots // 4),
                         rng)
    out["ct"] = ct
    low = mod.level_reduce(ct, len(ctx.q_moduli) - 1)
    out["raised"] = raised = booted.mod_raise(ctx, low)
    # n/(2s) = 2 at s = 128: one doubling step (rotation 128, in the set)
    out["fold"] = booted.partial_sums_fold(ctx, keys, raised, 128)
    out["dense_lt"] = booted._linear_transform(ctx, raised, dense.A_half,
                                               keys)
    out["staged_lt"] = booted._lt_diags(ctx, raised, staged.cts[0], keys,
                                        fold=0.75)
    out["mult_i"] = booted._mult_i(ctx, raised, 1)
    out["mult_minus_i"] = booted._mult_i(ctx, raised, -1)
    out["mult_by_int"] = booted._mult_by_int(ctx, ct, 16)
    out["normalize_scale"] = booted._normalize_scale(ctx, raised, ct.scale)
    return out


@pytest.fixture(scope="module")
def stages():
    j = _stage_run(jckks, jboot)
    return j, _stage_run(ckks, boot, j)


def test_stage_keys(stages):
    j, t = stages
    assert sorted(j["keys"].rot) == sorted(t["keys"].rot) == \
        boot.rotation_indices(t["ctx"], t["staged"])
    assert _same_key(j["keys"].evk, t["keys"].evk)
    assert _same_key(j["keys"].conj, t["keys"].conj)
    assert all(_same_key(j["keys"].rot[r], t["keys"].rot[r])
               for r in j["keys"].rot)
    planes = convert.bootstrap_keys_to_numpy(t["keys"])
    assert np.array_equal(planes[1][0], np.asarray(j["keys"].conj.b_lo))
    assert np.array_equal(planes[2][128][3],
                          np.asarray(j["keys"].rot[128].a_hi))


@pytest.mark.parametrize("name", ["raised", "fold", "dense_lt", "staged_lt",
                                  "mult_i", "mult_minus_i", "mult_by_int",
                                  "normalize_scale"])
def test_stage(stages, name):
    j, t = stages
    assert _same_ct(j[name], t[name])


def test_mod_raise_batches_both_polys(stages):
    """ModRaise lifts each polynomial alone; the batched [2, 1, n] lift is
    the same, and the towers it returns are contiguous kernel inputs."""
    _, t = stages
    ctx, ct = t["ctx"], t["ct"]
    low = ckks.level_reduce(ct, ct.towers - 1)
    for p, got in zip(low.polys, t["raised"].polys):
        one = boot.mod_raise(ctx, ckks.Ciphertext((p,), low.scale))
        assert torch.equal(one.polys[0].data, got.data)
        assert got.data.is_contiguous()


def test_missing_fold_key_names_the_rotation(stages):
    _, t = stages
    keys = t["keys"]
    short = boot.BootstrapKeys(keys.evk, keys.conj,
                               {r: k for r, k in keys.rot.items() if r != 16})
    with pytest.raises(boot.MissingRotationKey,
                       match=r"partial-sums fold needs the rotation key for "
                             r"16.*ckks_bootstrap.keygen"):
        boot.partial_sums_fold(t["ctx"], short, t["raised"], 4)
    with pytest.raises(KeyError):  # still a KeyError for existing handlers
        boot.partial_sums_fold(t["ctx"], short, t["raised"], 4)


# --- the port's whole bootstrap, no JAX --------------------------------------


def _port_bootstrap(params, slots, values, seed, **setup):
    ctx = ckks.gen_context(ckks.CKKSParams(**params), "cpu")
    rng = np.random.default_rng(seed)
    pk, sk = ckks.keygen(ctx, rng)
    pre = boot.setup(ctx, slots=slots, K=16, r=5, cheb_deg=28, **setup)
    keys = boot.keygen(ctx, sk, pre, rng)
    ct = ckks.encrypt(ctx, pk, np.tile(values, ctx.params.num_slots // slots),
                      rng)
    low = ckks.level_reduce(ct, len(ctx.q_moduli) - 1)
    return ctx, sk, keys, pre, low


def test_port_bootstrap_on_the_cpu():
    """tests/test_bootstrap.py's round trip, on the port alone (depth 18)."""
    ctx, sk, keys, pre, low = _port_bootstrap(DENSE, 4, VALUES4, 11)
    assert low.towers == 1
    out = boot.eval_bootstrap(ctx, keys, pre, low)
    assert out.towers > 3, "bootstrap must regain usable levels"
    dec = ckks.decrypt(ctx, sk, out, num_slots=4)
    assert np.max(np.abs(dec.real - VALUES4)) < 5e-2, dec


# --- slow: the whole bootstrap of both packages ------------------------------


class _Recorder:
    """Stand-in for the JAX ckks_bootstrap module's ``adv`` alias that
    records the two sine outputs: eval_bootstrap reads their depths with
    adv.depth_of right after EvalSine, and calls it nowhere else."""

    def __init__(self, record):
        self._record = record

    def __getattr__(self, name):
        return getattr(jadv, name)

    def depth_of(self, ctx, ct):
        self._record.setdefault("sine", []).append(ct)
        return jadv.depth_of(ctx, ct)


def _jax_bootstrap_stages(ctx, keys, pre, ct):
    """JAX eval_bootstrap, with every stage's ciphertext recorded through
    the module's own names."""
    rec = {}

    def keep(name, fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            rec.setdefault(name, []).append(out)
            return out
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jboot, "adv", _Recorder(rec))
        for name in ("mod_raise", "partial_sums_fold", "_linear_transform",
                     "_lt_factors"):
            mp.setattr(jboot, name, keep(name, getattr(jboot, name)))
        out = jboot.eval_bootstrap(ctx, keys, pre, ct)
    lts = rec.get("_linear_transform") or rec["_lt_factors"]
    assert len(lts) == 2 and lts[1] is out
    return dict(raised=rec["mod_raise"][0], folded=rec["partial_sums_fold"][0],
                cts=lts[0], sine_re=rec["sine"][0], sine_im=rec["sine"][1],
                stc=out)


def _both_bootstraps(params, slots, values, seed, iterative=False, **setup):
    jctx = jckks.gen_context(jckks.CKKSParams(**params))
    rng = np.random.default_rng(seed)
    jpk, jsk = jckks.keygen(jctx, rng)
    jpre = jboot.setup(jctx, slots=slots, K=16, r=5, cheb_deg=28, **setup)
    jkeys = jboot.keygen(jctx, jsk, jpre, rng)
    jct = jckks.encrypt(jctx, jpk, np.tile(
        values, jctx.params.num_slots // slots), rng)
    jlow = jckks.level_reduce(jct, len(jctx.q_moduli) - 1)
    j = dict(keys=jkeys, low=jlow, stages=_jax_bootstrap_stages(
        jctx, jkeys, jpre, jlow))
    j["slots"] = jckks.decrypt(jctx, jsk, j["stages"]["stc"],
                               num_slots=slots)
    if iterative:
        j["iter"] = jboot.eval_bootstrap_iterative(jctx, jkeys, jpre, jlow)
        j["iter_slots"] = jckks.decrypt(jctx, jsk, j["iter"],
                                        num_slots=slots)

    ctx, sk, keys, pre, low = _port_bootstrap(params, slots, values, seed,
                                              **setup)
    t = dict(keys=keys, low=low, stages={})
    boot.eval_bootstrap(ctx, keys, pre, low, t["stages"])
    t["slots"] = ckks.decrypt(ctx, sk, t["stages"]["stc"], num_slots=slots)
    if iterative:
        t["iter"] = boot.eval_bootstrap_iterative(ctx, keys, pre, low)
        t["iter_slots"] = ckks.decrypt(ctx, sk, t["iter"], num_slots=slots)
    return j, t


@pytest.fixture(scope="module")
def dense_both():
    return _both_bootstraps(DENSE, 4, VALUES4, 11, iterative=True)


@pytest.fixture(scope="module")
def staged_both():
    return _both_bootstraps(STAGED, 8, VALUES8, 23, level_budget=(2, 2))


BOOT_STAGES = ["raised", "folded", "cts", "sine_re", "sine_im", "stc"]


def _check_whole(j, t, values):
    assert sorted(j["keys"].rot) == sorted(t["keys"].rot)
    assert _same_key(j["keys"].evk, t["keys"].evk)
    assert _same_key(j["keys"].conj, t["keys"].conj)
    assert all(_same_key(j["keys"].rot[r], t["keys"].rot[r])
               for r in j["keys"].rot)
    assert _same_ct(j["low"], t["low"])
    assert list(t["stages"]) == BOOT_STAGES
    for name in BOOT_STAGES:
        assert _same_ct(j["stages"][name], t["stages"][name]), name
    assert np.array_equal(j["slots"], t["slots"])
    assert t["stages"]["stc"].towers > 3
    assert np.max(np.abs(t["slots"].real - values)) < 5e-2


@pytest.mark.slow
@pytest.mark.timeout(1200)
def test_dense_bootstrap_equals_jax(dense_both):
    _check_whole(*dense_both, VALUES4)


@pytest.mark.slow
@pytest.mark.timeout(1100)
def test_staged_bootstrap_equals_jax(staged_both):
    _check_whole(*staged_both, VALUES8)


@pytest.mark.slow
@pytest.mark.timeout(1200)
def test_iterative_bootstrap_equals_jax(dense_both):
    j, t = dense_both
    assert _same_ct(j["iter"], t["iter"])
    assert np.array_equal(j["iter_slots"], t["iter_slots"])
