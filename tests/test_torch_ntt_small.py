"""The port's small-ring NTT (n <= 2^11: ``ops.ntt.forward_small`` and
``inverse_small``, kernel ``csrc/ntt_small.cu``) against the JAX package's
NTT, against the four-step twin, and the kernel's schedule in Python ints.

On the CPU the wrappers run ``forward_small_plain``/``inverse_small_plain``,
the merged network stage by stage; ``tests/test_torch_cuda.py`` holds the
kernel to them on the card. The kernel's index arithmetic (the residues each
thread holds in each round, the twiddle of each butterfly, the lazy value
ranges, the folded 1/n) is replayed here in Python ints for every ring size
the kernel is built for. Every comparison is exact equality.
"""

import numpy as np
import pytest
import torch

from openfhe_tpu.ops import limb
from openfhe_tpu.ops import ntt as jntt
from openfhe_tpu.utils import nbtheory
from openfhe_tpu_torch import convert
from openfhe_tpu_torch.ops import ntt

SIZES = [2, 4, 16, 256, 1024, 2048]
KF = 3             # csrc/ntt_small.cu's kF: a thread holds 2^KF residues


def _inputs(moduli, lead, n, seed):
    """[*lead, L, n] reduced residues with the edge values q-1 and 0 in
    every tower."""
    rng = np.random.default_rng(seed)
    cols = []
    for q in moduli:
        c = rng.integers(0, q, size=lead + (n,), dtype=np.uint64)
        c[..., 0], c[..., -1] = q - 1, 0
        cols.append(c)
    return np.stack(cols, axis=-2).astype(np.int64)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bits", [27, 28, 50, 60])
@pytest.mark.parametrize("towers", [1, 3])
def test_small_plain_matches_jax(n, bits, towers):
    moduli = tuple(nbtheory.generate_prime_chain(towers, bits, n))
    x = _inputs(moduli, (2,), n, seed=n * bits + towers)  # [2, L, n]
    plan = jntt.make_plan(n, moduli)
    want = jntt.forward_jit(plan, limb.from_int_array(x))
    t = ntt.small_tables(n, moduli, "cpu")
    got = ntt.forward_small_plain(torch.from_numpy(x), t)
    assert torch.equal(got, convert.u64_to_tensor(want.lo, want.hi, "cpu"))
    back = ntt.inverse_small_plain(got, t)
    jback = jntt.inverse_jit(plan, want)
    assert torch.equal(back, convert.u64_to_tensor(jback.lo, jback.hi, "cpu"))
    assert torch.equal(back, torch.from_numpy(x))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bits", [27, 28, 50, 60])
def test_small_plain_matches_four_step_twin(n, bits):
    moduli = tuple(nbtheory.generate_prime_chain(3, bits, n))
    x = torch.from_numpy(_inputs(moduli, (2,), n, seed=n + bits))
    t, t4 = ntt.small_tables(n, moduli, "cpu"), ntt.tables(n, moduli, "cpu")
    y = ntt.forward_small_plain(x, t)
    assert torch.equal(y, ntt.forward_plain(x, t4))
    assert torch.equal(ntt.inverse_small_plain(y, t), ntt.inverse_plain(y, t4))


def test_small_tables_are_the_jax_plan():
    """The merged tables are the JAX package's psi^bitrev(j) and
    psi^-bitrev(j) with their precons; the 1/n pairs are n^-1 and
    psi^-bitrev(1) * n^-1."""
    n = 256
    moduli = tuple(nbtheory.generate_prime_chain(2, 59, n))
    plan = jntt.make_plan(n, moduli)
    t = ntt.small_tables(n, moduli, "cpu")

    def u64(table):
        return ((np.asarray(table.hi).astype(np.uint64) << np.uint64(32))
                | np.asarray(table.lo).astype(np.uint64)).view(np.int64)

    fwd, inv = t.fwd.numpy(), t.inv.numpy()
    assert np.array_equal(fwd[..., 0], u64(plan.psi_br))
    assert np.array_equal(fwd[..., 1], u64(plan.psi_br_pre))
    assert np.array_equal(inv[..., 0], u64(plan.psi_inv_br))
    assert np.array_equal(inv[..., 1], u64(plan.psi_inv_br_pre))
    assert np.array_equal(t.scale[:, 0].numpy(),
                          np.concatenate([u64(plan.n_inv),
                                          u64(plan.n_inv_pre)], axis=1))
    for l, q in enumerate(moduli):
        last = int(inv[l, 1, 0]) * pow(n, -1, q) % q
        assert t.scale[l, 1, 0] == last
        assert t.scale[l, 1, 1].numpy().view(np.uint64) == \
            np.uint64((last << 64) // q)


def _kernel_model(x, fwd_tab, sc, q, log_n, fwd):
    """One row through ``csrc/ntt_small.cu``'s schedule, in Python ints: a
    thread holds the E = 2^F residues whose index bits P..P+F-1 vary; round
    K runs the stages on bits BLO..BHI; the butterfly on bit b of element i
    reads twiddle (n + ibase) >> (b + 1) plus its group; the inverse's last
    stage folds 1/n in. Lazy ranges are asserted at every step, and the
    shared-memory slot of each element (one word of padding per 2^KF) is
    the sum of its thread's and its field's."""
    n, M = 1 << log_n, (1 << 64) - 1
    F = min(KF, log_n)
    E, tpr, nr = 1 << F, n >> F, (log_n + F - 1) // F
    w = [(int(a), int(b)) for a, b in fwd_tab.view(np.uint64)]
    s0, s1 = ((int(a), int(b)) for a, b in sc.view(np.uint64))
    bound = 4 * q if fwd else 2 * q

    def shoup(y, pair, eager):
        assert 0 <= y <= M
        r = (y * pair[0] - ((y * pair[1]) >> 64) * q) & M
        assert r < 2 * q
        return r - q if eager and r >= q else r

    def pad(i):
        return i + (i >> KF)

    v = [int(a) for a in x]
    for K in range(nr):
        if fwd:
            bhi = log_n - 1 - F * K
            blo = max(bhi - F + 1, 0)
            P, bits = blo, range(bhi, blo - 1, -1)
        else:
            blo, bhi = F * K, min(F * K + F - 1, log_n - 1)
            P, bits = bhi - (F - 1), range(blo, bhi + 1)
        assert 0 <= P <= blo <= bhi < P + F
        seen = []
        for u in range(tpr):
            ibase = ((u >> P) << (P + F)) | (u & ((1 << P) - 1))
            if K == 0 and fwd or K == nr - 1 and not fwd:
                assert ibase == u       # global access: neighbours coalesce
            idx = [ibase | (f << P) for f in range(E)]
            assert all(pad(ibase) + pad(f << P) == pad(i)
                       for f, i in enumerate(idx))  # the shared slots
            seen += idx
            loc = [v[i] for i in idx]
            for b in bits:
                lam = b - P
                if not fwd and b == log_n - 1:  # twiddle 1, 1/n folded in
                    assert lam == F - 1
                    for f in range(E // 2):
                        a, c = loc[f], loc[f + E // 2]
                        assert a < bound and c < bound
                        loc[f] = shoup(a + c, s0, True)
                        loc[f + E // 2] = shoup(a - c + 2 * q, s1, True)
                        assert loc[f] < q and loc[f + E // 2] < q
                    continue
                base = (n + ibase) >> (b + 1)
                for g in range((E // 2) >> lam):
                    for k in range(1 << lam):
                        f = (g << (lam + 1)) | k
                        h = f | (1 << lam)
                        assert (n + idx[f]) >> (b + 1) == base + g
                        assert idx[h] == idx[f] | (1 << b)
                        a, c = loc[f], loc[h]
                        assert a < bound and c < bound
                        if fwd:
                            a = a - 2 * q if a >= 2 * q else a
                            m = shoup(c, w[base + g], False)
                            a, c = a + m, a - m + 2 * q
                        else:
                            sm, d = a + c, a - c + 2 * q
                            a = sm - 2 * q if sm >= 2 * q else sm
                            c = shoup(d, w[base + g], False)
                        assert a < bound and c < bound
                        loc[f], loc[h] = a, c
            for i, a in zip(idx, loc):
                v[i] = a
        assert sorted(seen) == list(range(n))  # each element in one thread
    if fwd:
        assert all(a < 4 * q for a in v)
        return [a % q for a in v]
    assert all(a < q for a in v)
    return v


@pytest.mark.parametrize("log_n", range(1, 12))
@pytest.mark.parametrize("fwd", [True, False])
@pytest.mark.parametrize("bits", [30, 61])
def test_kernel_schedule_matches_plain(log_n, fwd, bits):
    n = 1 << log_n
    q = nbtheory.generate_prime_chain(1, bits, n)[0]
    x = _inputs((q,), (), n, seed=log_n + bits)[0]
    if n >= 4:
        x[:4] = [q - 1, 0, q - 1, 1]
    t = ntt.small_tables(n, (q,), "cpu")
    plain = ntt.forward_small_plain if fwd else ntt.inverse_small_plain
    want = plain(torch.from_numpy(x).reshape(1, n), t)
    tab = (t.fwd if fwd else t.inv)[0].numpy()
    got = _kernel_model(x, tab, t.scale[0].numpy(), q, log_n, fwd)
    assert got == want.reshape(n).tolist()


@pytest.mark.parametrize("log_n", range(1, 12))
def test_kernel_block_geometry(log_n):
    """A block's rows, threads and shared tile as ``csrc/ntt_small.cu``
    sizes them: whole rows, 128 threads (one row of 256 at n = 2^11), the
    static 48 KB of shared memory, and the linear tile words
    tid + k * threads covering the block's rows once, each in its own slot
    of its row's padded region."""
    n = 1 << log_n
    F = min(KF, log_n)
    rows = 1 if log_n >= 10 else ((128 << KF) >> log_n if log_n >= KF
                                  else 128)
    threads = rows * (n >> F)
    rs = n + (n >> KF)
    assert threads == (256 if log_n == 11 else 128)
    assert 8 * rows * rs <= 48 << 10
    words = [tid + k * threads for tid in range(threads)
             for k in range(1 << F)]
    assert sorted(words) == list(range(rows * n))
    slots = {(e >> log_n) * rs + (e & (n - 1)) + ((e & (n - 1)) >> KF)
             for e in words}
    assert len(slots) == rows * n and max(slots) < rows * rs


def test_routing_by_ring_size(monkeypatch):
    """On the CPU rings up to 2^11 take the merged network's twin and
    larger rings the four-step twin; each wrapper counts launches only on
    the card."""
    calls = []
    for name in ("forward_small_plain", "inverse_small_plain",
                 "forward_plain", "inverse_plain"):
        fn = getattr(ntt, name)
        monkeypatch.setattr(ntt, name, lambda *a, _f=fn, _n=name: (
            calls.append((_n, a[0].shape[-1])) or _f(*a)))
    before = (ntt.forward.launches, ntt.inverse.launches,
              ntt.forward_small.launches, ntt.inverse_small.launches)
    for n in (2048, 4096):
        moduli = tuple(nbtheory.generate_prime_chain(2, 50, n))
        x = torch.from_numpy(_inputs(moduli, (), n, seed=n))
        assert torch.equal(ntt.inverse(ntt.forward(x, moduli), moduli), x)
    assert calls == [("forward_small_plain", 2048),
                     ("inverse_small_plain", 2048),
                     ("forward_plain", 4096), ("inverse_plain", 4096)]
    assert before == (ntt.forward.launches, ntt.inverse.launches,
                      ntt.forward_small.launches, ntt.inverse_small.launches)


def test_small_path_refuses_bad_inputs():
    n = 64
    moduli = tuple(nbtheory.generate_prime_chain(2, 30, n))
    x = torch.from_numpy(_inputs(moduli, (), n, seed=1))
    with pytest.raises(ValueError):
        ntt.forward_small(x[:1], moduli)                 # towers != L
    with pytest.raises(ValueError):
        ntt.inverse_small(x.to(torch.int32), moduli)
    with pytest.raises(ValueError):
        ntt.small_tables(4096, (1 << 40 | 1,), "cpu")    # above 2^11
    with pytest.raises(ValueError, match="CUDA"):
        ntt._launch_small("ntt_small_forward", x,
                          ntt.small_tables(n, moduli, "cpu"), True)
