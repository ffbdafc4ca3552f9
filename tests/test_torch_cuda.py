"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA GPU and skips without one; on a machine with a
card run ``python -m pytest tests/test_torch_cuda.py -q``. ``chip_smoke.py``
repeats these checks at the main path's shapes (n = 2^16) and at BGV's and
BFV's (n = 2^15).
"""

import numpy as np
import pytest
import torch

from openfhe_tpu_torch.ops import automorph, elementwise, modular, ntt
from openfhe_tpu_torch.utils import nbtheory

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _uniform(moduli, shape, seed):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, q, size=shape, dtype=np.uint64) for q in moduli]
    return torch.from_numpy(np.stack(cols, axis=-2).astype(np.int64))


# n = 2^12 .. 2^17 take the templated radix-16 kernels (sub-transforms of
# 64, 128, 256 and 512 points), n <= 2^11 the small-ring kernel
# (csrc/ntt_small.cu), n > 2^17 the generic radix-2 ones
NTT_SHAPES = [(n, (2,)) for n in (2, 16, 512, 2048, 4096, 8192, 16384, 32768,
                                   1 << 17)] + \
    [(n, lead) for n in (2048, 4096, 32768) for lead in ((1,), (3,), ())]


# 45 and 55 bits: the bootstrap chain's towers (e2e_scale.py phase B)
@pytest.mark.parametrize("n,lead", NTT_SHAPES)
@pytest.mark.parametrize("bits", [30, 45, 55, 61])
def test_ntt_kernel_matches_twin(cuda, n, bits, lead):
    moduli = tuple(nbtheory.generate_prime_chain(3, bits, n))
    x = _uniform(moduli, lead + (n,), seed=n + bits)      # [lead, 3, n]
    t_cpu = ntt.tables(n, moduli, "cpu")
    want = ntt.forward_plain(x, t_cpu)
    got = ntt.forward(x.to(cuda), moduli)
    assert torch.equal(got.cpu(), want)
    back = ntt.inverse(got, moduli)
    assert torch.equal(back.cpu(), x)
    assert torch.equal(back.cpu(), ntt.inverse_plain(want, t_cpu))


# rings above 2^17 take csrc/ntt.cu's generic radix-2 passes: one and
# three 60-bit towers at n = 2^18
@pytest.mark.parametrize("towers,lead", [(1, ()), (3, (2,))])
def test_ntt_kernel_at_ring_2_18(cuda, towers, lead):
    n = 1 << 18
    moduli = tuple(nbtheory.generate_prime_chain(towers, 60, n))
    x = _uniform(moduli, lead + (n,), seed=towers)
    t_cpu = ntt.tables(n, moduli, "cpu")
    got = ntt.forward(x.to(cuda), moduli)
    assert torch.equal(got.cpu(), ntt.forward_plain(x, t_cpu))
    back = ntt.inverse(got, moduli)
    assert torch.equal(back.cpu(), ntt.inverse_plain(got.cpu(), t_cpu))
    assert torch.equal(back.cpu(), x)


def _ntt_counts():
    return (ntt.forward.launches, ntt.inverse.launches,
            ntt.forward_small.launches, ntt.inverse_small.launches)


def _small_round_trip(x, moduli):
    """forward and inverse of x on the card: each one launch of the
    small-ring kernel and none of the four-step's, each torch.equal to its
    twin on the same tensors, and the round trip the identity."""
    n = x.shape[-1]
    t = ntt.small_tables(n, moduli, x.device)
    before = _ntt_counts()
    got = ntt.forward(x, moduli)
    back = ntt.inverse(got, moduli)
    after = _ntt_counts()
    assert tuple(a - b for a, b in zip(after, before)) == (0, 0, 1, 1)
    assert torch.equal(got, ntt.forward_small_plain(x, t))
    assert torch.equal(back, ntt.inverse_small_plain(got, t))
    assert torch.equal(back, x)


# every ring the small-ring kernel is built for, at 1, 7 and 96 rows of one
# and of three towers
@pytest.mark.parametrize("log_n", range(1, 12))
@pytest.mark.parametrize("rows", [1, 7, 96])
@pytest.mark.parametrize("towers", [1, 3])
def test_small_ntt_kernel_matches_twin(cuda, log_n, rows, towers):
    n = 1 << log_n
    bits = (27, 50, 61)[log_n % 3]
    moduli = tuple(nbtheory.generate_prime_chain(towers, bits, n))
    x = _uniform(moduli, (rows, n), seed=n + rows + towers)  # [rows, L, n]
    _small_round_trip(x.to(cuda), moduli)


@pytest.mark.parametrize("rows,towers,n", [(70001, 1, 1024),
                                           (23000, 3, 256)])
def test_small_ntt_kernel_beyond_65535_rows(cuda, rows, towers, n):
    """One launch takes any number of rows (they sit on blockIdx.x)."""
    moduli = tuple(nbtheory.generate_prime_chain(towers, 28, n))
    x = _uniform(moduli, (rows, n), seed=rows)
    _small_round_trip(x.to(cuda), moduli)


@pytest.mark.parametrize("bits", [45, 55, 60])
def test_ks_inner_product_kernel_matches_twin(cuda, bits):
    n = 1024
    moduli = tuple(nbtheory.generate_prime_chain(7, bits, n))
    rows = [0, 1, 2, 5, 6]                  # a level below full, then P
    act = tuple(moduli[r] for r in rows)
    mod_cpu = modular.make_mod_consts(act, "cpu")
    digits = _uniform(act, (2, n), seed=1)  # ndig = 2 of dnum = 3
    kb = _uniform(moduli, (3, n), seed=2)
    ka = _uniform(moduli, (3, n), seed=3)
    want = elementwise.ks_inner_product(digits, kb, ka, rows, mod_cpu)
    got = elementwise.ks_inner_product(
        digits.to(cuda), kb.to(cuda), ka.to(cuda), rows,
        modular.make_mod_consts(act, cuda))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_fused_mac_kernel_matches_twin(cuda):
    n = 2048
    moduli = tuple(nbtheory.generate_prime_chain(3, 61, n))
    x, y, acc = (_uniform(moduli, (n,), seed=s) for s in (4, 5, 6))
    want = elementwise.fused_mac_mod(x, y, acc,
                                     modular.make_mod_consts(moduli, "cpu"))
    got = elementwise.fused_mac_mod(x.to(cuda), y.to(cuda), acc.to(cuda),
                                    modular.make_mod_consts(moduli, cuda))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("k", ["conjugate", 5, 25])
@pytest.mark.parametrize("lead", [(3, 7), (2,)])
def test_apply_eval_on_the_card(cuda, k, lead):
    """The slot permutation of a digit stack on the card equals the CPU's,
    for the conjugation (k = 2n - 1) and rotations."""
    n = 4096
    k = 2 * n - 1 if k == "conjugate" else k
    moduli = tuple(nbtheory.generate_prime_chain(lead[-1], 55, n))
    x = _uniform(moduli, lead[:-1] + (n,), seed=k)
    want = automorph.apply_eval(x, n, k)
    assert torch.equal(automorph.apply_eval(x.to(cuda), n, k).cpu(), want)


def _fhe_contexts():
    """BGV's and BFV's contexts of chip_smoke.py phases 8 and 9 (n = 2^15;
    only their primes are used here)."""
    from openfhe_tpu_torch.models import bfv, bgv
    ctx_bgv = bgv.gen_context(bgv.BGVParams(
        ring_dim=1 << 15, mult_depth=9, plaintext_modulus=65537, mod_size=60,
        dnum=3, security_level="HEStd_128_classic"), "cpu")
    ctx_bfv = bfv.gen_context(bfv.BFVParams(
        ring_dim=1 << 15, plaintext_modulus=65537, num_towers=10,
        mod_size=60, dnum=3, security_level="HEStd_128_classic"), "cpu")
    return ctx_bgv, ctx_bfv


@pytest.mark.parametrize("lead", [(), (4,)])
def test_ntt_kernel_at_the_bfv_s_basis(cuda, lead):
    """The BFV lift and scale-back: 21 towers of S = Q∪R at n = 2^15."""
    _, ctx = _fhe_contexts()
    moduli = ctx.q_moduli + ctx.r_moduli
    x = _uniform(moduli, lead + (1 << 15,), seed=21)
    t_cpu = ntt.tables(1 << 15, moduli, "cpu")
    got = ntt.forward(x.to(cuda), moduli)
    assert torch.equal(got.cpu(), ntt.forward_plain(x, t_cpu))
    assert torch.equal(ntt.inverse(got, moduli).cpu(), x)


@pytest.mark.parametrize("which", ["bgv_qp", "bv_chunk"])
def test_ks_inner_product_at_bgv_and_bv_shapes(cuda, which):
    """[3, 14, 2^15] over BGV's Q∪P (primes ≡ 1 mod 2nt, P below Q) and a
    BV chunk of 15 digits [15, 10, 2^15] over BFV's Q."""
    ctx_bgv, ctx_bfv = _fhe_contexts()
    n = 1 << 15
    moduli, ndig = (ctx_bgv.q_moduli + ctx_bgv.p_moduli, 3) \
        if which == "bgv_qp" else (ctx_bfv.q_moduli, 15)
    rows = list(range(len(moduli)))
    digits, kb, ka = (_uniform(moduli, (ndig, n), seed=s) for s in (7, 8, 9))
    want = elementwise.ks_inner_product(
        digits, kb, ka, rows, modular.make_mod_consts(moduli, "cpu"))
    got = elementwise.ks_inner_product(
        digits.to(cuda), kb.to(cuda), ka.to(cuda), rows,
        modular.make_mod_consts(moduli, cuda))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("scheme", ["bgv", "bfv"])
def test_schemes_on_the_card_equal_the_cpu(cuda, scheme):
    """gen_context(params) lands on the current CUDA device; a product,
    its relinearization, a rotation and the decryption there equal the CPU
    run's."""
    from openfhe_tpu_torch.models import bfv, bgv
    mod = bgv if scheme == "bgv" else bfv
    params = bgv.BGVParams(ring_dim=1024, mult_depth=2, mod_size=60,
                           dnum=2, plaintext_modulus=12289) \
        if scheme == "bgv" else bfv.BFVParams(
            ring_dim=1024, plaintext_modulus=12289, num_towers=2,
            mod_size=60, dnum=2)
    assert mod.gen_context(params).device.type == "cuda"
    runs = []
    for device in (cuda, "cpu"):
        ctx = mod.gen_context(params, device)
        rng = np.random.default_rng(3)
        pk, sk = mod.keygen(ctx, rng)
        evk = mod.relin_keygen(ctx, sk, rng)
        k = mod.rotation_galois(ctx.n, 1)
        rk = mod.rot_keygen(ctx, sk, [k], rng)[k]
        v = rng.integers(0, 12289, size=ctx.n).tolist()
        ct = mod.encrypt(ctx, pk, v, rng)
        prod = mod.relinearize(mod.eval_mult(ct, ct) if scheme == "bgv"
                               else mod.eval_mult(ctx, ct, ct), evk)
        rot = mod.eval_rotate(prod, 1, rk)
        runs.append(([p.data.cpu() for c in (ct, prod, rot)
                      for p in c.polys], mod.decrypt(ctx, sk, rot)))
    (gpu, gpu_slots), (cpu, cpu_slots) = runs
    assert all(torch.equal(g, c) for g, c in zip(gpu, cpu))
    assert gpu_slots == cpu_slots


def _threshold_run(device):
    """Threshold CKKS at n = 1024 (3 parties: joint keys, the joint
    relinearization key, EvalMult+relinearize, the interactive bootstrap
    and a distributed decryption), a PRE re-encryption and an archive round
    trip on `device`."""
    import tempfile
    from openfhe_tpu_torch.models import ckks, multiparty as mp, pre
    from openfhe_tpu_torch.utils import serial
    ctx = ckks.gen_context(ckks.CKKSParams(
        ring_dim=1024, mult_depth=3, scaling_mod_size=59, first_mod_size=60,
        dnum=3), device)
    rng = np.random.default_rng(5)
    pk, sk = mp.keygen_lead(ctx, rng)
    sks = [sk]
    for _ in range(2):
        pk, sk = mp.keygen_join(ctx, pk, rng)
        sks.append(sk)
    r1 = [mp.evalmult_round1(ctx, sks[0], rng)]
    r1 += [mp.evalmult_round1(ctx, s, rng, prev_key=r1[0]) for s in sks[1:]]
    ab = mp.evalmult_accumulate_round1(r1)
    evk = mp.evalmult_finalize([mp.evalmult_round2(ctx, s, ab, rng)
                                for s in sks])
    v = rng.uniform(-1, 1, 512)
    ct = ckks.encrypt(ctx, pk, v, rng)
    prod = ckks.rescale(ckks.eval_mult_relin(ct, ct, evk))
    small = mp.int_mp_boot_adjust_scale(ctx, prod)
    a = mp.int_mp_boot_random_element_gen(ctx, rng)
    fresh = mp.int_mp_boot_encrypt(ctx, mp.int_mp_boot_add(
        [mp.int_mp_boot_decrypt(ctx, s, small, a, rng) for s in sks]),
        a, small)
    parts = [mp.decrypt_lead(ctx, sks[0], fresh, rng)] + [
        mp.decrypt_main(ctx, s, fresh, rng) for s in sks[1:]]
    _, sk_b = ckks.keygen(ctx, rng)
    moved = pre.re_encrypt(fresh, pre.rekey_gen(ctx, sks[0], sk_b, rng),
                           ctx=ctx, pk=pk, mode="FIXED_NOISE_HRA", rng=rng)
    with tempfile.TemporaryDirectory() as d:
        serial.save(evk, f"{d}/evk", "json")
        loaded = serial.load(f"{d}/evk", device)
    states = [evk.b, evk.a, loaded.b, loaded.a] + [
        p.data for c in (prod, small, fresh, moved) for p in c.polys] + [
        p.data for p in parts]
    return [t.cpu() for t in states], mp.combine(ctx, fresh, parts, 512), v


def test_threshold_pre_and_archives_on_the_card_equal_the_cpu(cuda):
    gpu, gpu_slots, v = _threshold_run(cuda)
    cpu, cpu_slots, _ = _threshold_run("cpu")
    assert len(gpu) == len(cpu)
    assert all(torch.equal(g, c) for g, c in zip(gpu, cpu))
    assert np.array_equal(gpu_slots, cpu_slots)
    assert np.max(np.abs(gpu_slots.real - v * v)) < 1e-4


def _binfhe_q(name):
    from openfhe_tpu_torch.models import binfhe
    return binfhe.reference_params(name).Q


# the NTT shapes of chip_smoke.py phase 17: a step's digits [2dg*B, 1, N]
# and halves [2*B, 1, N] at B = 1, 2, 4, 8, 16 (STD128; STD128_AP runs its
# B = 4 at the same Q and N) and B = 4 (STD128Q_3), the ring secret and the
# GINX key's errors
@pytest.mark.parametrize("name,rows,n", [
    *[("STD128", r, 1024) for r in (1, 2, 4, 6, 8, 12, 16, 24, 32, 48, 96,
                                    6036)],
    *[("STD128Q_3", r, 2048) for r in (1, 8, 16, 4600)]])
def test_ntt_kernel_at_binfhe_shapes(cuda, name, rows, n):
    """Blind rotation's and key generation's NTTs: one 27- or 50-bit
    modulus (the small-ring kernel)."""
    moduli = (_binfhe_q(name),)
    x = _uniform(moduli, (rows, n), seed=rows + n)
    t_cpu = ntt.tables(n, moduli, "cpu")
    got = ntt.forward(x.to(cuda), moduli)
    assert torch.equal(got.cpu(), ntt.forward_plain(x, t_cpu))
    back = ntt.inverse(got, moduli)
    assert torch.equal(back.cpu(), x)


@pytest.mark.parametrize(
    "name,ndig,n,batch,key_rows,rows,epilogue,device_rows", [
        *[("STD128", 6, 1024, b, 2, (sign,) * b, True, False)
          for b in (1, 2, 4, 8, 16) for sign in (0, 1)],
        *[("STD128Q_3", 4, 2048, 4, 2, (sign,) * 4, True, False)
          for sign in (0, 1)],
        ("STD128_AP", 6, 1024, 4, 32, (5, 12, 19, 26), False, True),
        # beyond elementwise.MAX_ROWS_BY_VALUE: the host rows go as a
        # device index
        ("STD128", 6, 1024, 130, 2, (1,) * 130, True, False)])
def test_ks_inner_product_at_binfhe_shapes(cuda, name, ndig, n, batch,
                                           key_rows, rows, epilogue,
                                           device_rows):
    """One external product: digits [2dg, B, N] against the GINX step's
    slab [2dg, 2 signs, N], every row reading one sign's row, times the
    (X^c - 1) row of each batch element in the epilogue; or against the AP
    step's slab [2dg, B_r, N], row i reading batch element i's key row
    from a device index."""
    moduli = (_binfhe_q(name),)
    digits = _uniform(moduli, (ndig, batch, n), seed=1)[..., 0, :]
    kb = _uniform(moduli, (ndig, key_rows, n), seed=2)[..., 0, :]
    ka = _uniform(moduli, (ndig, key_rows, n), seed=3)[..., 0, :]
    rows_t = torch.tensor(rows)
    extra = {}
    if epilogue:
        mono = _uniform(moduli, (2 * n, n), seed=4)[:, 0, :].contiguous()
        mono_rows = torch.from_numpy(
            np.random.default_rng(5).integers(0, 2 * n, batch))
        extra = {"mono": mono, "mono_rows": mono_rows}
    want = elementwise.ks_inner_product(
        digits, kb, ka, rows_t if device_rows else rows,
        modular.make_mod_consts(moduli * batch, "cpu"), **extra)
    before = elementwise.ks_inner_product.launches
    got = elementwise.ks_inner_product(
        digits.to(cuda), kb.to(cuda), ka.to(cuda),
        rows_t.to(cuda) if device_rows else rows,
        modular.make_mod_consts(moduli * batch, cuda),
        **{k: v.to(cuda) for k, v in extra.items()})
    assert elementwise.ks_inner_product.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("name", ["TOY", "TOY_AP"])
def test_binfhe_on_the_card_equals_the_cpu(cuda, name):
    """gen_context(name) lands on the current CUDA device; the bootstrap key,
    a batched gate, a refresh and the public-key path there equal the CPU
    run's."""
    from openfhe_tpu_torch.models import binfhe
    assert binfhe.gen_context(name).device.type == "cuda"
    runs = []
    for device in (cuda, "cpu"):
        ctx = binfhe.gen_context(name, device)
        rng = np.random.default_rng(7)
        sk = binfhe.keygen(ctx, rng)
        bk = binfhe.bootstrap_keygen(ctx, sk, rng)
        cts = [binfhe.encrypt(ctx, sk, x, rng) for x in (0, 1)]
        outs = binfhe.eval_gate_batch(ctx, "NAND", bk, cts * 2,
                                      cts[::-1] + cts)
        outs.append(binfhe.bootstrap(ctx, bk, outs[0]))
        pk = binfhe.pubkey_gen(ctx, sk, rng)
        outs.append(binfhe.switch_ct_to_qn(
            ctx, bk, binfhe.encrypt_pk(ctx, pk, 1, rng)))
        runs.append(([bk.ek.cpu(), bk.ks_a.cpu(), bk.ks_b.cpu()]
                     + [o.a.cpu() for o in outs],
                     [(o.b, binfhe.decrypt(ctx, sk, o)) for o in outs]))
    (gpu, gpu_out), (cpu, cpu_out) = runs
    assert all(torch.equal(g, c) for g, c in zip(gpu, cpu))
    assert gpu_out == cpu_out
    assert [bit for _, bit in cpu_out] == [1, 1, 1, 0, 1, 1]


def _switch_fhew_q():
    return nbtheory.first_prime(27, 2 * 256)


# the NTT shapes of chip_smoke.py phases 18-19: LMKCDEY's external digits
# [2dg, 1, N], automorphism digits [dg, 1, N], halves [2, 1, N] and key
# errors [n*2dg, 1, N] at STD128_LMKCDEY; scheme switching's FHEW set
# (N = 256): digits and halves of one LUT, the key's errors [n*2*2dg]
@pytest.mark.parametrize("which,rows,n", [
    *[("STD128_LMKCDEY", r, 1024) for r in (1, 2, 3, 6, 2676)],
    *[("switch", r, 256) for r in (1, 2, 6, 96)]])
def test_ntt_kernel_at_lmkcdey_and_switch_shapes(cuda, which, rows, n):
    moduli = ((_switch_fhew_q(),) if which == "switch"
              else (_binfhe_q(which),))
    x = _uniform(moduli, (rows, n), seed=rows + n + 1)
    t_cpu = ntt.tables(n, moduli, "cpu")
    got = ntt.forward(x.to(cuda), moduli)
    assert torch.equal(got.cpu(), ntt.forward_plain(x, t_cpu))
    back = ntt.inverse(got, moduli)
    assert torch.equal(back.cpu(), x)


@pytest.mark.parametrize("which,ndig,n,key_rows,rows", [
    ("STD128_LMKCDEY", 6, 1024, 1, (0,)),        # against ek[j]
    ("STD128_LMKCDEY", 3, 1024, 1, (0,)),        # against an automorphism key
    ("switch", 6, 256, 2, (0,)), ("switch", 6, 256, 2, (1,))])
def test_ks_inner_product_at_lmkcdey_and_switch_shapes(cuda, which, ndig, n,
                                                       key_rows, rows):
    moduli = ((_switch_fhew_q(),) if which == "switch"
              else (_binfhe_q(which),))
    digits = _uniform(moduli, (ndig, 1, n), seed=4)[..., 0, :]
    kb = _uniform(moduli, (ndig, key_rows, n), seed=5)[..., 0, :]
    ka = _uniform(moduli, (ndig, key_rows, n), seed=6)[..., 0, :]
    want = elementwise.ks_inner_product(
        digits, kb, ka, rows, modular.make_mod_consts(moduli, "cpu"))
    got = elementwise.ks_inner_product(
        digits.to(cuda), kb.to(cuda), ka.to(cuda), rows,
        modular.make_mod_consts(moduli, cuda))
    assert torch.equal(got.cpu(), want)


def test_scheme_switching_chain_on_the_card(cuda):
    """The NTT and ks_inner_product at scheme switching's CKKS chain at
    n = 2^16 (14 towers + 5 special primes, dnum 3)."""
    from openfhe_tpu_torch.models import ckks
    ctx = ckks.gen_context(ckks.CKKSParams(
        ring_dim=1 << 16, mult_depth=13, scaling_mod_size=35,
        first_mod_size=50, dnum=3, secret_hw=64), "cpu")
    moduli = ctx.q_moduli + ctx.p_moduli
    n = 1 << 16
    x = _uniform(moduli, (3, n), seed=9)
    t_cpu = ntt.tables(n, moduli, "cpu")
    got = ntt.forward(x.to(cuda), moduli)
    assert torch.equal(got.cpu(), ntt.forward_plain(x, t_cpu))
    rows = list(range(len(moduli)))
    kb, ka = _uniform(moduli, (3, n), seed=10), _uniform(moduli, (3, n), 11)
    want = elementwise.ks_inner_product(
        x, kb, ka, rows, modular.make_mod_consts(moduli, "cpu"))
    got = elementwise.ks_inner_product(
        x.to(cuda), kb.to(cuda), ka.to(cuda), rows,
        modular.make_mod_consts(moduli, cuda))
    assert torch.equal(got.cpu(), want)


def test_large_precision_and_lmkcdey_on_the_card_equal_the_cpu(cuda):
    """TOY_LP's floor, large sign and decomposition and TOY_LMKCDEY's key,
    an AND batch and a LUT on the card equal the CPU run's."""
    from openfhe_tpu_torch.models import binfhe
    assert binfhe.gen_context("TOY_LMKCDEY").device.type == "cuda"
    runs = []
    for device in (cuda, "cpu"):
        rng = np.random.default_rng(13)
        ctx = binfhe.gen_context("TOY_LP", device)
        sk = binfhe.keygen(ctx, rng)
        bk = binfhe.bootstrap_keygen(ctx, sk, rng)
        ct = binfhe.encrypt_phase(ctx, sk, 9000, ctx.params.q_ks, rng)
        outs = [binfhe.eval_floor(ctx, bk, ct, 64),
                binfhe.eval_sign_large(ctx, bk, ct, 64),
                *binfhe.eval_decomp(ctx, bk, ct, 64)]
        dec = [binfhe.decrypt_zp(ctx, sk, outs[1], 2)]
        ctx = binfhe.gen_context("TOY_LMKCDEY", device)
        sk = binfhe.keygen(ctx, rng)
        mk = binfhe.bootstrap_keygen(ctx, sk, rng)
        cts = [binfhe.encrypt(ctx, sk, x, rng) for x in (0, 1)]
        gates = binfhe.eval_gate_batch(ctx, "AND", mk, cts * 2,
                                       cts[::-1] + cts)
        lut = binfhe.eval_func(ctx, mk, binfhe.encrypt_zp(ctx, sk, 5, 8, rng),
                               [0, 1, 2, 3, 0, 7, 6, 5], 8)
        outs += gates + [lut]
        dec += [binfhe.decrypt(ctx, sk, g) for g in gates]
        dec.append(binfhe.decrypt_zp(ctx, sk, lut, 8))
        runs.append(([bk.ek.cpu(), mk.ek.cpu(), mk.ak.cpu(), mk.ks_a.cpu()]
                     + [o.a.cpu() for o in outs],
                     [(o.b, o.modulus) for o in outs], dec))
    (gpu, gpu_out, gpu_dec), (cpu, cpu_out, cpu_dec) = runs
    assert all(torch.equal(g, c) for g, c in zip(gpu, cpu))
    assert gpu_out == cpu_out and gpu_dec == cpu_dec
    assert cpu_dec == [1, 0, 0, 0, 1, 7]


def test_scheme_switching_on_the_card_equals_the_cpu(cuda):
    """Keys, CKKS -> FHEW and FHEW -> CKKS at ring 512 with the FHEW set of
    examples/scheme_switching.py on the card equal the CPU run's."""
    from openfhe_tpu_torch.models import binfhe, ckks
    from openfhe_tpu_torch.models import scheme_switch as ss
    runs = []
    for device in (cuda, "cpu"):
        rng = np.random.default_rng(17)
        ctx = ckks.gen_context(ckks.CKKSParams(
            ring_dim=512, mult_depth=13, scaling_mod_size=35,
            first_mod_size=50, dnum=3, secret_hw=64), device)
        pk, sk = ckks.keygen(ctx, rng)
        bctx = binfhe.gen_context(binfhe.BinFHEParams(
            n_lwe=8, N=256, Q=_switch_fhew_q(), q_ks=1 << 14, log_bg=10,
            log_bks=5), device)
        sk_f = binfhe.keygen(bctx, rng)
        pre = ss.setup(ctx, bctx, slots=8, cheb_deg=56)
        keys = ss.keygen(ctx, bctx, pre, sk, sk_f, pk, rng)
        ct = ckks.encrypt(ctx, pk, np.tile(np.arange(8.0), 32), rng)
        lwes = ss.eval_ckks_to_fhew(ctx, bctx, pre, keys, ct, 8, 8)
        back = ss.eval_fhew_to_ckks(ctx, bctx, pre, keys, lwes[:2])
        runs.append(([keys.evk.b.cpu(), keys.lwe_ks_a.cpu()]
                     + [c.a.cpu() for c in lwes]
                     + [p.data.cpu() for p in back.polys],
                     [binfhe.decrypt_zp(bctx, sk_f, c, 8) for c in lwes]))
    (gpu, gpu_dec), (cpu, cpu_dec) = runs
    assert all(torch.equal(g, c) for g, c in zip(gpu, cpu))
    assert gpu_dec == cpu_dec == list(range(8))


def _trapdoor_run(device, n=128, seed=97):
    """chip_smoke.py phase 21's flow at n = 128: trapdoor_gen, gauss_samp
    and gauss_samp_exact over one 50-bit tower, base 2."""
    from openfhe_tpu_torch import dcrt
    from openfhe_tpu_torch.models import trapdoor as td
    from openfhe_tpu_torch.utils import sampling

    rng = np.random.default_rng(seed)
    q = nbtheory.first_prime(50, 2 * n)
    A, T = td.trapdoor_gen(n, q, 2, td.SIGMA, rng, device)
    u = dcrt.from_int_rows(dcrt.RnsBasis(n, (q,)),
                           sampling.uniform_rns_rows(n, (q,), rng),
                           dcrt.Format.EVAL, device)
    x = td.gauss_samp(n, q, 2, A, T, u, td.SIGMA, rng)
    x_exact = td.gauss_samp_exact(n, q, 2, A, T, u, rng)
    assert torch.equal(td.apply_A(A, x_exact).data, u.data)
    return [p.data.cpu() for p in A + T.r + T.e + x + x_exact]


def test_trapdoor_on_the_card_equals_the_cpu(cuda):
    gpu, cpu = _trapdoor_run(cuda), _trapdoor_run("cpu")
    assert len(gpu) == len(cpu)
    assert all(torch.equal(g, c) for g, c in zip(gpu, cpu))


def test_four_step_on_a_one_rank_nccl_group(cuda, tmp_path):
    """chip_smoke.py phase 22: the distributed four-step on a one-rank NCCL
    group equals the NTT kernel, and its collectives their local results."""
    import torch.distributed as dist
    from openfhe_tpu_torch.parallel import collectives, dntt, mesh

    torch.cuda.set_device(cuda)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        m = mesh.make_mesh()
        for n, lead in ((4096, (2,)), (1 << 16, ())):
            moduli = tuple(nbtheory.generate_prime_chain(3, 60, n))
            x = _uniform(moduli, lead + (n,), seed=n).to(cuda)
            n1, n2 = dntt.split_factors(n)
            y = dntt.four_step_forward(x, n1, n2, moduli, mesh=m)
            assert torch.equal(y, ntt.forward(x, moduli))
            assert torch.equal(
                dntt.four_step_inverse(y, n1, n2, moduli, mesh=m), x)
            assert torch.equal(collectives.four_step_forward_shard_map(
                x.reshape(-1, n)[:3], moduli, m), ntt.forward(
                    x.reshape(-1, n)[:3].contiguous(), moduli))
        parts = _uniform((1 << 40,) * 4, (64,), seed=2).to(cuda)
        assert torch.equal(collectives.tower_psum(parts, m),
                           parts.sum(dim=0))
    finally:
        dist.destroy_process_group()
