#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``openfhe_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from ``openfhe_tpu_torch/csrc``, holds each
kernel against its plain PyTorch twin (``torch.equal``) at the main path's
shapes, then drives the CKKS main path (keygen, relinearization and rotation
keys, encrypt, EvalMult+relinearize, rescale, EvalRotate(1), decrypt) at
n = 2^16 on the 60-bit chain (8 towers + 3 special primes) and on the
composite chain (16 towers of ~30 bits), checking the decrypted slots
against roll(v1*v2, -1) and that every kernel was launched, and finally
holds every key and ciphertext of a small (n = 1024) run on the card equal
to the same run on the CPU twins. Then it bootstraps at n = 2^16 on the
bootstrap chain of e2e_scale.py (21 towers of 55/45 bits + 7 special primes):
every kernel must launch during the bootstrap, more than 3 towers must come
back and the slots must decrypt within 5e-2; and a dense n = 512 bootstrap
on the card must equal the CPU run in every key, every stage's ciphertext
and the decrypted slots. The kernels are held against their twins at the
bootstrap chain's shapes too. Phase 8 runs BGV at n = 2^15 with 128-bit
classic security (10 towers, 4 special primes, t = 65537): keygen, the
relinearization key and eval_sum's 15 keys, a 9-level squaring chain with
mod_reduce down to one tower, rotation, row flip, eval_sum, plaintext
operands and compress, every decryption equal to the plaintext arithmetic
mod t. Phase 9 runs BFV at the same width (Q 10 towers, R 11, P 4): an
8-level HPS squaring chain, one product each by HPSPOVERQ,
HPSPOVERQLEVELED and BEHZ, rotation, eval_sum, the coefficient and string
encodings, compress and a BV relinearisation, each exact. Phase 10 holds
BGV and BFV at n = 2^12 on the card equal to the CPU run in every key,
every ciphertext and every decryption. The kernels are held against their
twins at the BGV and BFV shapes too. Phases 11 to 13 run threshold FHE on
the contexts of phases 3, 8 and 9: joint keys, the joint relinearization
and rotation keys, evaluation and distributed decryption (CKKS and BGV with
3 parties, BFV with 5), and the interactive bootstrap of CKKS at n = 2^16.
Phase 14 re-encrypts (PRE) in all three modes for each scheme, phase 15
saves and loads keys and ciphertexts in both archive flavours, and phase 16
holds the flows of phases 11-14 at small n on the card equal to the CPU
run. The kernels are held against their twins at the key shares' shapes
too. Phase 17 runs BINFHE: at STD128 (GINX, N = 1024, n = 503) the keys,
every 2-input gate over its truth table as one batch, NOT, MAJORITY, AND3,
OR3, AND4, OR4 and CMUX over every input, a chain of 10 refreshes and a
public-key encryption switched into a gate; AND and NAND at STD128Q_3 (a
50-bit Q, N = 2048); AND and OR at STD128_AP (the DM accumulator, its
4.7 GB key drawn on the host); every decryption exact, the NTT and
ks_inner_product launched; and TOY and TOY_AP on the card equal to the CPU
run in every key, output and archive. The kernels are held against their
twins at one blind-rotation step's shapes too, ks_inner_product in the
form each step calls it: GINX with the monomial product in its epilogue,
AP reading its key rows through a device index (as does a GINX batch of
130, beyond the rows a host list passes by value). Phase 18 runs the
large-precision functions at STD128 (eval_floor within 2 beta, eval_sign_large
exact, eval_decomp, eval_sign over Z_8; input modulus q_ks, beta = 64) and
LMKCDEY at STD128_LMKCDEY (keys, AND, OR, XOR and NAND over their truth
tables, a refresh of 0 and of 1, one eval_func), each op's host seconds and
launches logged. Phase 19 runs CKKS <-> FHEW scheme switching with the CKKS
side at n = 2^16 (examples/scheme_switching.py's parameters: setup, keys,
CKKS -> FHEW, FHEW -> CKKS, compare, min/max and their _alt forms), each
flow held to the JAX tests' bounds against what its LWE inputs encrypt (the
CKKS -> FHEW samples' noise at this ring is logged), and phase 20 holds
TOY_LP, TOY_LMKCDEY (with the LMKCDEY key's archives) and scheme switching
at n = 512 on the card equal to the CPU run, every flow at n = 512 within
the JAX tests' bounds against the plaintext. Phase 21 runs MP12 lattice
trapdoors at n = 8192 over one 50-bit tower, base 2: trapdoor_gen,
gauss_samp and the exact gauss_samp_exact, each preimage x with
apply_A(A, x) == u exactly and within the JAX tests' shortness bounds, the
G-lattice samplers' congruence, and the same flow at n = 128 on the card
equal to the CPU in every A, T and x. Phase 22 starts a one-rank NCCL group
(NCCL puts no two ranks on one GPU; several ranks are tested on the CPU
with gloo), holds the distributed four-step NTT equal to the NTT at
[3, 11, 2^16] and [11, 2^16], runs the main path (MultRelin -> rescale ->
Rotate) routed through it with dcrt.set_distributed_ntt, equal to the
unrouted run, with the key switch's four NTTs counted on the routed path,
checks tower_psum, and wraps one MultRelin in profiling.timed (at least
its CUDA-event time) and profiling.trace (the trace names the NTT and MAC
kernels). The kernels are held against their twins at both phases' shapes
too. Phase 23 runs the 38 example programs of openfhe_tpu_torch/examples on
the card, each transcript (what it prints, the mkdtemp directory masked)
equal to the JAX program's in tests/data/example_transcripts, and phase 24
holds entry()'s step on the card equal to the CPU and runs
dryrun_multichip(1) on one NCCL rank; phase 2 holds each kernel against
its twin at every call these two phases make, as a CPU rehearsal recorded
them (tests/data/example_kernel_calls.json), and phases 23-24 fail on a
call the rehearsal did not record. The NTT has two kernels: the four-step
of csrc/ntt.cu for n >= 2^12 and the one-launch merged network of
csrc/ntt_small.cu for n <= 2^11 (BINFHE, scheme switching's FHEW side, the
four-step's sub-transforms, the example programs), and csrc/ntt.cu's
generic radix-2 passes serve n > 2^17, held at n = 2^18 in phase 2; phase
2 holds every NTT shape against the twin of the kernel it routes to, fails unless each call
is exactly one launch of that kernel and none of the other's, and times a
replayed launch of an empty kernel (bench/launch_floor.cu) beside them.
Each phase fails if a kernel of its path never launched. The line before
the last is
a JSON object with each kernel's launches (on the main path, in one
bootstrap, in phase 8, in phase 9, in phases 11-13, in phase 14, in phase
17, in phase 18, in phase 19, in phase 21, on phase 22's routed path, in
phase 23 and in phase 24),
error against its twin, times (L2-warm
``ms``, cold-L2 ``cold_ms``, the twin's ``plain_ms``) and ``bound_ms``, the
least time the card could take for the call; the last line is the JSON
device summary. There is no CPU path:
without a CUDA device it exits non-zero.
"""

import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

RING_DIM = 1 << 16
TOWERS = 8
BOUND = 1e-4  # the JAX package's bound at this size (e2e_scale.py)

# Published peaks of one H100 SXM: 3.35 TB/s of HBM; 67 TFLOP/s of float32
# outside the tensor cores is 128 lanes x 2 on each of 132 SMs at 1.98 GHz,
# and 32-bit integer multiply-adds run on 64 lanes an SM: 16.75e12 a second.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
FLUSH_BYTES = 192 << 20  # several times the 50 MB L2

# Phase 6: the JAX package's bootstrap at n = 2^16 (e2e_scale.py:114-119,
# its phase B): 21 Q towers (55-bit q0, twenty ~45-bit) and 7 special
# primes of 60 bits, dnum 3, a sparse secret
BOOT_PARAMS = dict(ring_dim=RING_DIM, mult_depth=20, scaling_mod_size=45,
                   first_mod_size=55, dnum=3, secret_hw=64)
BOOT_SETUP = dict(slots=4, K=16, r=5, cheb_deg=28)
BOOT_VALUES = [0.25, -0.5, 0.75, 0.125]
BOOT_BOUND = 5e-2  # e2e_scale.py:147
# Phase 7: the dense n = 512 bootstrap of tests/test_bootstrap.py at depth
# 18: the pipeline spends 15 levels (CtS 1, sine 2 + 6 + 5, StC 1), so the
# test's depth 14 leaves none for SlotsToCoeffs; 18 regains 4 towers
SMALL_BOOT_PARAMS = dict(ring_dim=512, mult_depth=18, scaling_mod_size=35,
                         first_mod_size=50, dnum=3, secret_hw=64)

# Phases 8 and 9: BGV and BFV at n = 2^15, 128-bit classic security (log QP
# = 840 <= 880), t = 65537 (the library's default)
FHE_RING_DIM = 1 << 15
BGV_PARAMS = dict(ring_dim=FHE_RING_DIM, mult_depth=9,
                  plaintext_modulus=65537, mod_size=60, dnum=3,
                  security_level="HEStd_128_classic")
BFV_PARAMS = dict(ring_dim=FHE_RING_DIM, plaintext_modulus=65537,
                  num_towers=10, mod_size=60, dnum=3,
                  security_level="HEStd_128_classic")
BFV_LEVELS = 8
BV_LOG_BASE = 20
# Phase 10: both schemes at n = 2^12 (3 towers), card against CPU
SMALL_BGV_PARAMS = dict(ring_dim=1 << 12, mult_depth=2,
                        plaintext_modulus=65537, mod_size=60, dnum=3)
SMALL_BFV_PARAMS = dict(ring_dim=1 << 12, plaintext_modulus=65537,
                        num_towers=3, mod_size=60, dnum=3)
BFV_TEXT = "openfhe_tpu_torch: BFV on the H100"
BFV_COEFS = [7, -3, 0, 32768, -32768, 1, -2]

_NTT_PALLAS = "openfhe_tpu/ops/ntt_pallas.py"
_MAC_PALLAS = "openfhe_tpu/ops/elementwise_pallas.py:54"
# kernel -> (its source under openfhe_tpu_torch/, the TPU kernel it replaces)
SOURCES = {"ntt_forward": ("csrc/ntt.cu", f"{_NTT_PALLAS}:282"),
           "ntt_inverse": ("csrc/ntt.cu", f"{_NTT_PALLAS}:293"),
           "ntt_small_forward": ("csrc/ntt_small.cu", f"{_NTT_PALLAS}:282"),
           "ntt_small_inverse": ("csrc/ntt_small.cu", f"{_NTT_PALLAS}:293"),
           "ks_inner_product": ("csrc/mac.cu", _MAC_PALLAS),
           "fused_mac_mod": ("csrc/mac.cu", _MAC_PALLAS)}
# the NTT's two routes: the four-step (n >= 2^12) and the merged network of
# the small rings (n <= 2^11)
FOUR_STEP = ("ntt_forward", "ntt_inverse")
SMALL_NTT = ("ntt_small_forward", "ntt_small_inverse")
MACS = ("ks_inner_product", "fused_mac_mod")
# the shape whose numbers stand for the small-ring kernels in the kernels
# line: a STD128 gate's digits (B = 4)
SMALL_MAIN_SHAPE = "[24, 1, 1024] "


_START = time.perf_counter()


def log(*a):
    """Print at once; a phase header ("[N] ...") also gets the seconds since
    the script started."""
    if a and str(a[0]).startswith("["):
        a = a + (f"(at {time.perf_counter() - _START:.1f} s)",)
    print(*a, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps):
    """Mean device time of fn() (or of a tuple of functions called in turn)
    over `reps` calls, by replaying them as one CUDA graph
    (``utils.profiling.graph_ms``)."""
    from openfhe_tpu_torch.utils.profiling import graph_ms
    return graph_ms(fn, reps)


_flush_buf = {}


def flush_l2():
    """Rewrite a buffer several times the L2's size, so that what follows
    finds its operands in device memory."""
    if "buf" not in _flush_buf:
        _flush_buf["buf"] = torch.zeros(FLUSH_BYTES // 8, dtype=torch.int64,
                                        device="cuda")
    _flush_buf["buf"].add_(1)


def cold_ms(fn, reps):
    """Device time of fn() on a cold L2: (flush, fn) pairs minus the flushes
    alone, both as graph replays."""
    return max(cuda_ms((flush_l2, fn), reps) - cuda_ms((flush_l2,), reps),
               0.0)


def bound(nbytes, ops):
    """The least time the card could take: every input byte read once and
    every output byte written once at the HBM rate, or the 32-bit integer
    operations at the integer rate, whichever is longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": 1e3 * t_bytes, "operations_ms": 1e3 * t_ops}


def ntt_bound(rows, towers, n):
    """NTT of [rows, n] over `towers` moduli: the data read and written
    (16 bytes a coefficient) and the twist with its precon (16 bytes a tower
    coefficient); n/2 log2 n butterflies a row at 16 integer operations (a
    Shoup product is ten 32-bit multiply-adds, then three two-word
    additions) and n twists at 12."""
    butterflies = rows * (n // 2) * (n.bit_length() - 1)
    return bound(16 * rows * n + 16 * towers * n,
                 16 * butterflies + 12 * rows * n)


def ntt_small_bound(rows, towers, n):
    """The small-ring NTT of [rows, n] over `towers` moduli: the data read
    and written (16 bytes a coefficient) and the tower's twiddle pairs (16
    bytes a tower coefficient); n/2 log2 n butterflies a row at 16 integer
    operations. No twist: the merged network has none."""
    butterflies = rows * (n // 2) * (n.bit_length() - 1)
    return bound(16 * rows * n + 16 * towers * n, 16 * butterflies)


def ks_bound(ndig, rows, n, key_rows=None, rows_on_device=False,
             mono_rows=0):
    """ks_inner_product over [ndig, rows, n]: the digits, both key halves
    (`key_rows` distinct rows of them, default one per output row) and both
    outputs once; per output a 64x64->128 product a digit (four multiply-adds
    and four additions to accumulate) and a final reduction of some twenty
    operations. A rows tensor adds its 8 bytes a row; an epilogue over
    `mono_rows` distinct rows of the table adds those rows and its index,
    and per output a full product (eight operations) and a reduction."""
    key_rows = rows if key_rows is None else key_rows
    index = 8 * rows * (bool(rows_on_device) + bool(mono_rows))
    return bound(8 * n * (ndig * rows + 2 * ndig * key_rows + 2 * rows
                          + mono_rows) + index,
                 rows * n * 2 * (8 * ndig + 20 + (28 if mono_rows else 0)))


def epilogue_operands(mono_shape, q, rows, rng, device):
    """ks_inner_product's epilogue keywords for a table of `mono_shape`
    ([M, n], residues below q) and `rows` random row indices, or {} when
    `mono_shape` is None."""
    if mono_shape is None:
        return {}
    M, n = mono_shape
    mono = uniform((q,), (M, n), rng, device)[:, 0, :].contiguous()
    mono_rows = torch.from_numpy(rng.integers(0, M, rows)).to(device)
    return {"mono": mono, "mono_rows": mono_rows}


def fused_mac_bound(rows, n):
    """fused_mac_mod over [rows, n]: three operands and one result, one
    product and one reduction a coefficient."""
    return bound(8 * rows * n * 4, rows * n * 28)


def compare(name, kernel, plain, bound_, reps=20, cold_l2=True):
    """Kernel against twin on the same inputs: bit-equal, and both timed
    (the kernel on a cold L2 too unless cold_l2 is false)."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    if err or not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel differs from its twin "
                             f"(max abs err {err})")
    ms = cuda_ms(kernel, reps)
    cold = cold_ms(kernel, reps) if cold_l2 else None
    plain_ms = cuda_ms(plain, max(2, reps // 10))
    cold_text = f"{cold:.4f} ms cold L2" if cold_l2 else "cold L2 not timed"
    log(f"  {name}: torch.equal to twin; kernel {ms:.4f} ms warm, "
        f"{cold_text}, twin {plain_ms:.4f} ms, bound "
        f"{bound_['bound_ms']:.4f} ms ({bound_['bound_by']})")
    # no single PyTorch call computes a negacyclic NTT modulo q or a modular
    # multiply-accumulate on 60-bit residues: there is no library time
    return {"shape": name.split(" ", 1)[1], "max_abs_err": err, "ms": ms,
            "cold_ms": cold, "plain_ms": plain_ms, **bound_,
            "library_ms": None}


def ntt_case(label, moduli, x, reps=20, cold_l2=True):
    """Phase 2's check of one NTT shape: forward and inverse against the
    twins of the kernel the wrapper routes n to (the small-ring kernel for
    n <= 2^11, the four-step above), each call exactly one launch of that
    kernel and none of the other's, and inverse(forward(x)) == x. Returns
    the kernels' names and the two compare() results."""
    from openfhe_tpu_torch.ops import ntt

    n = x.shape[-1]
    rows = x.numel() // n
    if n <= ntt.SMALL_MAX_N:
        names, t = SMALL_NTT, ntt.small_tables(n, moduli, x.device)
        plains = (ntt.forward_small_plain, ntt.inverse_small_plain)
        bound_ = ntt_small_bound(rows, len(moduli), n)
    else:
        names, t = FOUR_STEP, ntt.tables(n, moduli, x.device)
        plains = (ntt.forward_plain, ntt.inverse_plain)
        bound_ = ntt_bound(rows, len(moduli), n)
    before = read_counters()
    y = ntt.forward(x, moduli)
    back = ntt.inverse(y, moduli)
    delta = {k: read_counters()[k] - before[k] for k in FOUR_STEP + SMALL_NTT}
    need(delta == {k: int(k in names) for k in delta},
         f"{label}: NTT launches {delta}, expected one each of {names}")
    need(torch.equal(back, x), f"inverse(forward(x)) != x at {label}")
    fwd = compare(f"{names[0]} {label}", lambda: ntt.forward(x, moduli),
                  lambda: plains[0](x, t), bound_, reps, cold_l2)
    inv = compare(f"{names[1]} {label}", lambda: ntt.inverse(y, moduli),
                  lambda: plains[1](y, t), bound_, reps, cold_l2)
    log(f"  inverse(forward(x)) == x at {label}, one launch each of "
        f"{names[0]} and {names[1]}")
    return names, fwd, inv


def launch_floor_ms():
    """Device time of one replayed launch of a kernel that does nothing
    (one block of 64 threads, bench/launch_floor.cu), by the replay that
    times every kernel here."""
    import ctypes

    from openfhe_tpu_torch import _build
    lib = _build.bench_library("launch_floor")
    lib.launch_empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.launch_empty.restype = ctypes.c_int

    def call():
        _build.check("launch_empty", lib.launch_empty(64, _build.stream()))

    return cuda_ms(call, 20)


def uniform(moduli, shape, rng, device):
    cols = [rng.integers(0, q, size=shape, dtype=np.uint64) for q in moduli]
    arr = np.stack(cols, axis=-2).astype(np.int64)
    return torch.from_numpy(arr).to(device)


# the batch sizes of the blind rotations of phases 17-19 per set: STD128's
# 2-input gates run 4 at once, MAJORITY/AND3/OR3 8, AND4/OR4 16, CMUX 16
# then 8, a refresh, a large-precision op and a LUT 1, the public-key AND
# 2; STD128Q_3 and STD128_AP run 2-input gates; LMKCDEY rotates one
# ciphertext at a time; scheme switching's FHEW set one LUT at a time
BINFHE_BATCHES = {"STD128": (1, 2, 4, 8, 16), "STD128Q_3": (4,),
                  "STD128_AP": (4,), "STD128_LMKCDEY": (1,),
                  "switch FHEW": (1,)}


def binfhe_sets(binfhe):
    return [(name, switch_fhew_params(binfhe) if name == "switch FHEW"
             else binfhe.reference_params(name), batches)
            for name, batches in BINFHE_BATCHES.items()]


def binfhe_ntt_cases(binfhe):
    """(label, moduli, lead, N) of every NTT phases 17-19 launch: a step's
    digits [2dg*B, 1, N] forward and halves [2*B, 1, N] back (LMKCDEY's
    automorphism step: digits [dg, 1, N]), and key generation's ring secret
    [1, 1, N] and errors, each in one launch: [n*2*2dg, 1, N] (GINX),
    [n*d_r*B_r*2dg, 1, N] (AP), [n*2dg] and [dg] (LMKCDEY)."""
    rows = {}
    for name, p, batches in binfhe_sets(binfhe):
        names, got = rows.setdefault((p.Q, p.N), ([], set()))
        names.append(name)
        got.update(r * b for b in batches for r in (2 * p.dg, 2))
        if p.method == "LMKCDEY":
            got.update({1, p.dg, 2 * p.dg * p.n_lwe})
            continue
        errs = 2 * p.dg * (p.n_lwe * p.d_r * p.B_r if p.method == "AP"
                           else 2 * p.n_lwe)
        got.update({1, errs})
    return [(f"[{r}, 1, {N}] {Q.bit_length()}-bit BINFHE {'/'.join(names)}",
             (Q,), (r,), N) for (Q, N), (names, got) in rows.items()
            for r in sorted(got)]


# a GINX batch beyond the rows a host list passes by value
# (elementwise.MAX_ROWS_BY_VALUE): its sign rows go to the kernel as a
# device index
WIDE_GINX_BATCH = 130


def binfhe_ks_cases(binfhe):
    """(label, (Q,), N, 2dg, B, key rows, rows, rows on the device?,
    epilogue?) of every ks_inner_product phases 17-19 launch: GINX digits
    [2dg, B, N] against the step's slab [2dg, 2, N], every row reading one
    sign's row, with the monomial product in the epilogue; AP against the
    step's slab [2dg, B_r, N], row i reading the key row of batch element
    i's digit, given as a device index; LMKCDEY digits [2dg, 1, N] against
    ek[j]'s [2dg, 1, N] and [dg, 1, N] against an automorphism key's. Then
    one STD128 GINX batch of WIDE_GINX_BATCH, whose rows go as a device
    index."""
    out = []
    for name, p, batches in binfhe_sets(binfhe):
        if p.method == "LMKCDEY":
            out += [(f"[{d}, 1, {p.N}] {p.Q.bit_length()}-bit BINFHE {name}, "
                     f"key [{d}, 1, {p.N}] ({what})", (p.Q,), p.N, d, 1, 1,
                     (0,), False, False)
                    for d, what in ((2 * p.dg, "ek row"),
                                    (p.dg, "automorphism key"))]
            continue
        if name == "STD128":
            batches = batches + (WIDE_GINX_BATCH,)
        for b in batches:
            shape = f"[{2 * p.dg}, {b}, {p.N}] {p.Q.bit_length()}-bit BINFHE"
            if p.method == "AP":
                rows = tuple(i % p.B_r for i in range(5, 5 + 7 * b, 7))
                out.append((f"{shape} {name}, key [{2 * p.dg}, {p.B_r}, "
                            f"{p.N}], rows {list(rows)} on the device",
                            (p.Q,), p.N, 2 * p.dg, b, p.B_r, rows, True,
                            False))
            else:
                out += [(f"{shape} {name}, key [{2 * p.dg}, 2, {p.N}] sign "
                         f"{sign}, monomial epilogue", (p.Q,), p.N,
                         2 * p.dg, b, 2, (sign,) * b, False, True)
                        for sign in (0, 1)]
    return out


def check_kernels(ctx60, ctx30, ctx_boot, ctx_bgv, ctx_bfv, ctx_sw, device):
    """Phase 2: each kernel against its twin at the main path's shapes, at
    the bootstrap chain's (45- and 55-bit towers, 60-bit special primes),
    at BGV's and BFV's (n = 2^15: the BFV S = Q∪R basis, BGV's Q∪P with
    primes ≡ 1 mod 2nt, a BV chunk of 15 digits), at n = 2^18 (the NTT's
    generic radix-2 passes, which no phase reaches), at the key shares of
    threshold FHE (both halves of every digit at once), at every BINFHE
    shape phases 17-19 give them (BINFHE_BATCHES; ks_inner_product in the
    form each blind rotation calls it: GINX with the monomial epilogue, AP
    with its rows on the device) and at scheme switching's CKKS chain
    (phase 19: 14 towers + 5 special primes, dnum 3). Each kernel's summary
    entry is its CKKS main-path keyswitch shape's and lists every shape
    under ``shapes``."""
    from openfhe_tpu_torch.models import binfhe
    from openfhe_tpu_torch.ops import elementwise, modular, ntt
    from openfhe_tpu_torch.utils import nbtheory

    rng = np.random.default_rng(3)
    n, nf = RING_DIM, FHE_RING_DIM
    # phase 21's tower; phase 22's four-step columns [n2, ..., L, n1] and
    # rows [n1, ..., L, n2] on one rank (n1 = n2 at n = 2^16)
    q_td = (nbtheory.first_prime(TRAPDOOR_BITS, 2 * TRAPDOOR_N),)
    # rings above 2^17 take csrc/ntt.cu's generic radix-2 passes
    q18 = tuple(nbtheory.generate_prime_chain(3, 60, 1 << 18))
    td_label = f"[1, {TRAPDOOR_N}] {TRAPDOOR_BITS}-bit trapdoor"
    n1, n2 = ntt.split_factors(n)
    qp = ctx60.q_moduli + ctx60.p_moduli
    bq = ctx_boot.q_moduli
    bqp = bq + ctx_boot.p_moduli
    s_basis = ctx_bfv.q_moduli + ctx_bfv.r_moduli
    bgv_qp = ctx_bgv.q_moduli + ctx_bgv.p_moduli
    swqp = ctx_sw.q_moduli + ctx_sw.p_moduli
    sw_label = f"[3, {len(swqp)}, 65536] 35/51/60-bit scheme-switching QP"
    cases = [("[8, 65536] 60-bit", ctx60.q_moduli, (), n),
             ("[16, 65536] 30-bit", ctx30.q_moduli, (), n),
             ("[1, 65536] 60-bit", ctx60.q_moduli[-1:], (), n),
             ("[2, 11, 65536] 60-bit QP", qp, (2,), n),
             ("[3, 8, 2048] 60-bit", ctx60.q_moduli, (3,), 2048),
             ("[1, 262144] 60-bit generic radix-2 path", q18[:1], (),
              1 << 18),
             ("[2, 3, 262144] 60-bit generic radix-2 path", q18, (2,),
              1 << 18),
             ("[1, 65536] 55-bit bootstrap q0", bq[:1], (), n),
             (f"[3, {len(bqp)}, 65536] 45/55-bit bootstrap QP", bqp, (3,), n),
             (f"[{len(s_basis)}, {nf}] 60-bit BFV S", s_basis, (), nf),
             (f"[4, {len(s_basis)}, {nf}] 60-bit BFV S", s_basis, (4,), nf),
             (f"[3, {len(bgv_qp)}, {nf}] 60-bit BGV QP", bgv_qp, (3,), nf),
             (f"[6, {len(bgv_qp)}, {nf}] 60-bit BGV QP (key share)", bgv_qp,
              (6,), nf),
             ("[6, 11, 65536] 60-bit QP (key share)", qp, (6,), n),
             *binfhe_ntt_cases(binfhe),
             (sw_label, swqp, (3,), n),
             (td_label, q_td, (), TRAPDOOR_N),
             (f"[{n2}, 3, 11, {n1}] 60-bit QP four-step columns and rows",
              qp, (n2, 3), n1),
             (f"[{n2}, 11, {n1}] 60-bit QP four-step columns and rows", qp,
              (n2,), n1),
             ("[3, 11, 65536] 60-bit QP", qp, (3,), n)]
    floor_ms = launch_floor_ms()
    log(f"  launch floor: {floor_ms:.6f} ms a replayed launch of an empty "
        f"one-block kernel (bench/launch_floor.cu)")
    shapes = {name: [] for name in SOURCES}
    for label, moduli, lead, dim in cases:
        x = uniform(moduli, lead + (dim,), rng, device)
        names, fwd, inv = ntt_case(label, moduli, x)
        shapes[names[0]].append(fwd)
        shapes[names[1]].append(inv)

    bfv_q = ctx_bfv.q_moduli
    # the key switches' shapes, rows by value; once with the rows as a
    # device index, the variant a wide BINFHE batch or AP takes
    for label, moduli, ndig, dim, on_device in (
            (f"[3, {len(bqp)}, 65536] 45/55-bit bootstrap QP", bqp, 3, n,
             False),
            (f"[3, {len(bgv_qp)}, {nf}] 60-bit BGV QP", bgv_qp, 3, nf, False),
            (f"[15, {len(bfv_q)}, {nf}] 60-bit BV chunk of 15 digits", bfv_q,
             15, nf, False),
            (sw_label, swqp, 3, n, False),
            ("[3, 11, 65536] 60-bit QP, rows on the device", qp, 3, n, True),
            ("[3, 11, 65536] 60-bit QP", qp, 3, n, False)):
        mod = modular.make_mod_consts(moduli, device)
        digits = uniform(moduli, (ndig, dim), rng, device)
        kb = uniform(moduli, (ndig, dim), rng, device)
        ka = uniform(moduli, (ndig, dim), rng, device)
        rows = list(range(len(moduli)))
        rows_t = torch.tensor(rows, dtype=torch.int64, device=device)
        shapes["ks_inner_product"].append(compare(
            f"ks_inner_product {label}",
            lambda: elementwise.ks_inner_product(
                digits, kb, ka, rows_t if on_device else rows, mod),
            lambda: elementwise.ks_inner_product_plain(
                digits, kb, ka, rows_t, mod),
            ks_bound(ndig, len(moduli), dim, None, on_device)))
    for (label, q, dim, ndig, batch, key_rows, rows, on_device,
         epilogue) in binfhe_ks_cases(binfhe):
        mod = modular.make_mod_consts(q * batch, device)
        digits = uniform(q, (ndig, batch, dim), rng, device)[..., 0, :]
        kb = uniform(q, (ndig, key_rows, dim), rng, device)[..., 0, :]
        ka = uniform(q, (ndig, key_rows, dim), rng, device)[..., 0, :]
        rows_t = torch.tensor(rows, dtype=torch.int64, device=device)
        # the blind rotation's table: (X^c - 1) for every c mod 2N
        extra = epilogue_operands((2 * dim, dim) if epilogue else None,
                                  q[0], batch, rng, device)
        wide = batch > elementwise.MAX_ROWS_BY_VALUE
        shapes["ks_inner_product"].insert(-1, compare(
            f"ks_inner_product {label}",
            lambda: elementwise.ks_inner_product(
                digits, kb, ka, rows_t if on_device else rows, mod, **extra),
            lambda: elementwise.ks_inner_product_plain(
                digits, kb, ka, rows_t, mod, **extra),
            ks_bound(ndig, batch, dim, len(set(rows)), on_device or wide,
                     len(set(extra["mono_rows"].tolist())) if extra
                     else 0)))
    # a key share scales both halves of every digit in one launch: the QP
    # moduli repeated 2 * dnum times
    for label, moduli, dim in (
            (f"[{len(bq)}, 65536] 45/55-bit bootstrap Q", bq, n),
            (f"[{len(s_basis)}, {nf}] 60-bit BFV S (tensor)", s_basis, nf),
            (f"[{6 * len(bgv_qp)}, {nf}] 60-bit BGV QP x 6 (key share)",
             bgv_qp * 6, nf),
            (f"[{6 * len(qp)}, 65536] 60-bit QP x 6 (key share)", qp * 6, n),
            (f"[{len(ctx_sw.q_moduli)}, 65536] 35/51-bit scheme-switching Q",
             ctx_sw.q_moduli, n),
            (td_label, q_td, TRAPDOOR_N),
            ("[11, 65536] 60-bit QP", qp, n)):
        mod = modular.make_mod_consts(moduli, device)
        x, y, acc = (uniform(moduli, (dim,), rng, device) for _ in range(3))
        shapes["fused_mac_mod"].append(compare(
            f"fused_mac_mod {label}",
            lambda: elementwise.fused_mac_mod(x, y, acc, mod),
            lambda: elementwise.fused_mac_plain(x, y, acc, mod),
            fused_mac_bound(len(moduli), dim)))
    def main_entry(name, per_shape):
        if name in SMALL_NTT:
            return {**next(r for r in per_shape
                           if r["shape"].startswith(SMALL_MAIN_SHAPE)),
                    "launch_floor_ms": floor_ms}
        return per_shape[-1]

    return {name: {**main_entry(name, per_shape), "shapes": per_shape}
            for name, per_shape in shapes.items()}


ROOT = os.path.dirname(os.path.abspath(__file__))
# every distinct kernel call of phases 23-24, as a CPU rehearsal of them
# recorded it (tests/make_example_kernel_calls.py)
EXAMPLE_CALLS = os.path.join(ROOT, "tests", "data", "example_kernel_calls.json")
EXAMPLE_REPS = 10


def example_calls():
    with open(EXAMPLE_CALLS) as f:
        return json.load(f)


def call_key(c):
    """The CallLog signature of one entry of EXAMPLE_CALLS."""
    if c["kernel"] == "ks_inner_product":
        on_device = c["rows"] == "device"
        return (c["kernel"], tuple(c["shape"]), tuple(c["key_shape"]),
                () if on_device else tuple(c["rows"]), on_device,
                tuple(c.get("mono_shape", ())), tuple(c["moduli"]))
    return (c["kernel"], tuple(c["shape"]), tuple(c["moduli"]))


def _bits(moduli):
    return "/".join(str(b) for b in sorted({q.bit_length() for q in moduli}))


def summarize_shapes(results):
    """Per ring dimension: the number of shapes, the largest error and the
    range of each time and of the share of the bound."""
    by_n = {}
    for r in results:
        by_n.setdefault(r["n"], []).append(r)
    out = []
    for n, rs in sorted(by_n.items()):
        def span(key):
            vals = [r[key] for r in rs]
            return [min(vals), max(vals)]
        out.append({"n": n, "cases": len(rs),
                    "max_abs_err": max(r["max_abs_err"] for r in rs),
                    "ms": span("ms"), "plain_ms": span("plain_ms"),
                    "bound_ms": span("bound_ms"),
                    "share_of_bound": [min(r["bound_ms"] / r["ms"]
                                           for r in rs),
                                       max(r["bound_ms"] / r["ms"]
                                           for r in rs)]})
    return out


def check_example_shapes(device):
    """Phase 2, continued: each kernel against its twin at every call the
    example programs and the entry points make (phases 23-24). An NTT
    shape holds the forward and the inverse, and inverse(forward(x)) == x;
    the keys of a ks_inner_product call are drawn below the smallest of
    its moduli, so that every row reads reduced residues. Returns, per
    kernel, each shape's result with its ring dimension under "n"."""
    from openfhe_tpu_torch.ops import elementwise, modular

    rng = np.random.default_rng(5)
    out = {name: [] for name in SOURCES}
    for c in example_calls():
        moduli = tuple(c["moduli"])
        shape = tuple(c["shape"])
        n = shape[-1]
        label = f"{list(shape)} {_bits(moduli)}-bit ({c['programs'][0]})"
        if c["kernel"] == "ntt":
            x = uniform(moduli, shape[:-2] + (n,), rng, device)
            names, fwd, inv = ntt_case(label, moduli, x, EXAMPLE_REPS,
                                       cold_l2=False)
            out[names[0]].append({**fwd, "n": n})
            out[names[1]].append({**inv, "n": n})
        elif c["kernel"] == "ks_inner_product":
            ndig, R = shape[0], shape[1]
            dnum, key_rows, _ = c["key_shape"]
            on_device = c["rows"] == "device"
            rows = (tuple(int(r) for r in rng.integers(0, key_rows, R))
                    if on_device else tuple(c["rows"]))
            mod = modular.make_mod_consts(moduli, device)
            digits = uniform(moduli, (ndig, n), rng, device)
            low = (min(moduli),) * key_rows
            kb = uniform(low, (dnum, n), rng, device)
            ka = uniform(low, (dnum, n), rng, device)
            rows_t = torch.tensor(rows, dtype=torch.int64, device=device)
            extra = epilogue_operands(c.get("mono_shape"), min(moduli), R,
                                      rng, device)
            what = (", rows on the device" if on_device else "") + \
                (", monomial epilogue" if extra else "")
            res = compare(
                f"ks_inner_product {label}, key {c['key_shape']}{what}",
                lambda: elementwise.ks_inner_product(
                    digits, kb, ka, rows_t if on_device else rows, mod,
                    **extra),
                lambda: elementwise.ks_inner_product_plain(
                    digits, kb, ka, rows_t, mod, **extra),
                ks_bound(ndig, R, n, len(set(rows)), on_device,
                         len(set(extra["mono_rows"].tolist()))
                         if extra else 0),
                EXAMPLE_REPS, cold_l2=False)
            out["ks_inner_product"].append({**res, "n": n})
        else:
            mod = modular.make_mod_consts(moduli, device)
            x, y, acc = (uniform(moduli, (n,), rng, device)
                         for _ in range(3))
            res = compare(
                f"fused_mac_mod {label}",
                lambda: elementwise.fused_mac_mod(x, y, acc, mod),
                lambda: elementwise.fused_mac_plain(x, y, acc, mod),
                fused_mac_bound(len(moduli), n), EXAMPLE_REPS, cold_l2=False)
            out["fused_mac_mod"].append({**res, "n": n})
    for name, results in out.items():
        need(results, f"phase 2: no example shape for {name}")
        log(f"  {name}: {len(results)} example shapes torch.equal to the "
            f"twin")
    return out


def counters():
    from openfhe_tpu_torch.ops import elementwise, ntt
    return {"ntt_forward": ntt.forward, "ntt_inverse": ntt.inverse,
            "ntt_small_forward": ntt.forward_small,
            "ntt_small_inverse": ntt.inverse_small,
            "ks_inner_product": elementwise.ks_inner_product,
            "fused_mac_mod": elementwise.fused_mac_mod}


def reset_counters():
    for wrapper in counters().values():
        wrapper.launches = 0


def read_counters():
    return {k: w.launches for k, w in counters().items()}


def _ntt_call(x, moduli):
    return ("ntt", tuple(x.shape), tuple(int(q) for q in moduli))


def _ks_call(digits, key_b, key_a, rows, mod, mono=None, mono_rows=None):
    # a rows tensor is recorded as such, not by its values (the AP blind
    # rotation's rows follow the data); an epilogue by its table's shape
    on_device = isinstance(rows, torch.Tensor)
    return ("ks_inner_product", tuple(digits.shape), tuple(key_b.shape),
            () if on_device else tuple(int(r) for r in rows), on_device,
            () if mono is None else tuple(mono.shape),
            tuple(mod.q.reshape(-1).tolist()))


def _mac_call(x, y, acc, mod):
    return ("fused_mac_mod", tuple(x.shape),
            tuple(mod.q.reshape(-1).tolist()))


class CallLog:
    """While entered, every call of the four kernel wrappers (on any device)
    adds its signature to ``calls``: ("ntt", shape, moduli),
    ("ks_inner_product", digits' shape, the keys' shape, the host rows (or
    () for a rows tensor), whether the rows are a tensor, the monomial
    table's shape (or ()), moduli) or ("fused_mac_mod", shape, moduli). The wrappers are swapped for shims on
    their modules; each shim carries the wrapper's launch count, which
    goes back to the wrapper on exit."""

    def __init__(self):
        self.calls = set()
        self._swapped = []

    def __enter__(self):
        from openfhe_tpu_torch.ops import elementwise, ntt
        for module, name, sig in ((ntt, "forward", _ntt_call),
                                  (ntt, "inverse", _ntt_call),
                                  (elementwise, "ks_inner_product", _ks_call),
                                  (elementwise, "fused_mac_mod", _mac_call)):
            wrapper = getattr(module, name)

            def shim(*a, _wrapper=wrapper, _sig=sig, **k):
                self.calls.add(_sig(*a, **k))
                return _wrapper(*a, **k)

            shim.launches = wrapper.launches
            setattr(module, name, shim)
            self._swapped.append((module, name, wrapper, shim))
        return self

    def __exit__(self, *exc):
        for module, name, wrapper, shim in self._swapped:
            wrapper.launches = shim.launches
            setattr(module, name, wrapper)
        self._swapped = []


def stage_timer(times):
    """timed(name, fn): fn() between two synchronises, its seconds kept in
    `times` under `name`."""

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    return timed


def main_path(ckks, ctx, label, seed):
    """Phases 3 and 4: the CKKS main path, timed stage by stage."""
    times = {}
    timed = stage_timer(times)
    n = ctx.n
    rng = np.random.default_rng(seed)
    reset_counters()
    pk, sk = timed("keygen", lambda: ckks.keygen(ctx, rng))
    evk = timed("relin_keygen", lambda: ckks.relin_keygen(ctx, sk, rng))
    rk = timed("rot_keygen", lambda: ckks.rot_keygen(ctx, sk, [1], rng)[1])
    v1 = rng.uniform(-1, 1, size=n // 2)
    v2 = rng.uniform(-1, 1, size=n // 2)
    ct1 = timed("encrypt", lambda: ckks.encrypt(ctx, pk, v1, rng))
    ct2 = timed("encrypt2", lambda: ckks.encrypt(ctx, pk, v2, rng))
    prod = timed("eval_mult_relin", lambda: ckks.eval_mult_relin(ct1, ct2,
                                                                 evk))
    res = timed("rescale", lambda: ckks.rescale_ctx(ctx, prod))
    rot = timed("eval_rotate", lambda: ckks.eval_rotate(res, 1, rk))
    out = timed("decrypt", lambda: ckks.decrypt(ctx, sk, rot,
                                                num_slots=n // 2))
    launches = read_counters()
    # the same evaluation again, with every table built and cached
    prod = timed("eval_mult_relin_warm",
                 lambda: ckks.eval_mult_relin(ct1, ct2, evk))
    res = timed("rescale_warm", lambda: ckks.rescale_ctx(ctx, prod))
    timed("eval_rotate_warm", lambda: ckks.eval_rotate(res, 1, rk))
    err = float(np.max(np.abs(out.real - np.roll(v1 * v2, -1))))
    if not np.all(np.isfinite(out)) or out.shape != (n // 2,):
        raise AssertionError(f"{label}: decrypted slots malformed")
    log(f"  {label}: towers {len(ctx.q_moduli)}+{len(ctx.p_moduli)}, "
        f"max |err| {err:.3e} (bound {BOUND})")
    log("  stage seconds: " + ", ".join(f"{k} {v:.4f}"
                                        for k, v in times.items()))
    log(f"  launches: {launches}")
    if not err < BOUND:
        raise AssertionError(f"{label}: error {err} above bound {BOUND}")
    missing = [k for k in FOUR_STEP + MACS if launches[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched: {missing}")
    return launches


def slice_states(ckks, device, seed, n=1024):
    """Every key and ciphertext of the slice at a small size on `device`."""
    params = ckks.CKKSParams(ring_dim=n, mult_depth=3, scaling_mod_size=59,
                             first_mod_size=60, dnum=3)
    ctx = ckks.gen_context(params, device)
    rng = np.random.default_rng(seed)
    pk, sk = ckks.keygen(ctx, rng)
    evk = ckks.relin_keygen(ctx, sk, rng)
    rk = ckks.rot_keygen(ctx, sk, [1], rng)[1]
    ct1 = ckks.encrypt(ctx, pk, rng.uniform(-1, 1, n // 2), rng)
    ct2 = ckks.encrypt(ctx, pk, rng.uniform(-1, 1, n // 2), rng)
    prod = ckks.eval_mult_relin(ct1, ct2, evk)
    res = ckks.rescale(prod)
    rot = ckks.eval_rotate(res, 1, rk)
    states = [pk.b.data, pk.a.data, evk.b, evk.a, rk.b, rk.a]
    for ct in (ct1, ct2, prod, res, rot):
        states += [p.data for p in ct.polys]
    return [t.cpu() for t in states], ckks.decrypt(ctx, sk, rot, n // 2)


def check_against_cpu(ckks):
    """Phase 5: the slice on the card equals the slice on the CPU twins
    (which the CPU tests hold bit-equal to the JAX package)."""
    gpu, gpu_slots = slice_states(ckks, torch.device("cuda", 0), seed=5)
    cpu, cpu_slots = slice_states(ckks, torch.device("cpu"), seed=5)
    if len(gpu) != len(cpu) or not all(torch.equal(g, c)
                                       for g, c in zip(gpu, cpu)):
        raise AssertionError("the slice on the card differs from the CPU")
    if not np.array_equal(gpu_slots, cpu_slots):
        raise AssertionError("decrypted slots differ from the CPU's")
    log(f"  n=1024: {len(gpu)} keys and ciphertext polys torch.equal to the "
        f"CPU run; slots equal")


def bootstrap_at_scale(ckks, boot, ctx):
    """Phase 6: phase B of e2e_scale.py on the card. An exhausted (1-tower)
    ciphertext is bootstrapped once cold and once warm; every kernel must
    launch during the cold bootstrap, which must regain more than 3 towers
    and decrypt within the bound."""
    times = {}
    timed = stage_timer(times)
    rng = np.random.default_rng(11)
    pk, sk, pre = timed("setup", lambda: (*ckks.keygen(ctx, rng),
                                          boot.setup(ctx, **BOOT_SETUP)))
    keys = timed("bootstrap_keygen", lambda: boot.keygen(ctx, sk, pre, rng))
    vals = np.array(BOOT_VALUES)
    ct = ckks.encrypt(ctx, pk, np.tile(vals, ctx.params.num_slots // 4), rng)
    low = ckks.level_reduce(ct, len(ctx.q_moduli) - 1)
    reset_counters()
    timed("bootstrap_cold", lambda: boot.eval_bootstrap(ctx, keys, pre, low))
    launches = read_counters()
    out = timed("bootstrap_warm",
                lambda: boot.eval_bootstrap(ctx, keys, pre, low))
    dec = timed("decrypt", lambda: ckks.decrypt(ctx, sk, out, num_slots=4))
    err = float(np.max(np.abs(dec.real - vals)))
    log(f"  n={ctx.n}: towers {len(ctx.q_moduli)}+{len(ctx.p_moduli)}, "
        f"{len(keys.rot)} rotation keys, regained {out.towers} towers, "
        f"max |err| {err:.3e} (bound {BOOT_BOUND})")
    log("  stage seconds: " + ", ".join(f"{k} {v:.4f}"
                                        for k, v in times.items()))
    log(f"  launches in the cold bootstrap: {launches}")
    if not np.all(np.isfinite(dec)) or dec.shape != (4,):
        raise AssertionError("bootstrap: decrypted slots malformed")
    if not err < BOOT_BOUND:
        raise AssertionError(f"bootstrap: error {err} above {BOOT_BOUND}")
    if not out.towers > 3:
        raise AssertionError(f"bootstrap regained only {out.towers} towers")
    missing = [k for k in FOUR_STEP + MACS if launches[k] == 0]
    if missing:
        raise AssertionError(f"bootstrap: kernels never launched: {missing}")
    return launches, times["bootstrap_warm"]


def small_bootstrap_states(ckks, boot, device):
    """Every key, the input, every stage of a dense n = 512 bootstrap and
    the decrypted slots on `device`."""
    ctx = ckks.gen_context(ckks.CKKSParams(**SMALL_BOOT_PARAMS), device)
    rng = np.random.default_rng(11)
    pk, sk = ckks.keygen(ctx, rng)
    pre = boot.setup(ctx, **BOOT_SETUP)
    keys = boot.keygen(ctx, sk, pre, rng)
    ct = ckks.encrypt(ctx, pk, np.tile(BOOT_VALUES, ctx.params.num_slots // 4),
                      rng)
    low = ckks.level_reduce(ct, len(ctx.q_moduli) - 1)
    stages = {}
    out = boot.eval_bootstrap(ctx, keys, pre, low, stages)
    states = [pk.b.data, pk.a.data]
    for key in [keys.evk, keys.conj] + [keys.rot[r] for r in sorted(keys.rot)]:
        states += [key.b, key.a]
    for c in [ct, low, *stages.values()]:
        states += [p.data for p in c.polys]
    return ([t.cpu() for t in states], list(stages),
            ckks.decrypt(ctx, sk, out, num_slots=4))


def bootstrap_against_cpu(ckks, boot):
    """Phase 7: the n = 512 bootstrap on the card equals the CPU run in
    every key, every stage's ciphertext and the decrypted slots."""
    t0 = time.perf_counter()
    gpu, names, gpu_slots = small_bootstrap_states(
        ckks, boot, torch.device("cuda", 0))
    t1 = time.perf_counter()
    cpu, _, cpu_slots = small_bootstrap_states(ckks, boot,
                                               torch.device("cpu"))
    t2 = time.perf_counter()
    if len(gpu) != len(cpu) or not all(torch.equal(g, c)
                                       for g, c in zip(gpu, cpu)):
        raise AssertionError("the n=512 bootstrap on the card differs from "
                             "the CPU's")
    if not np.array_equal(gpu_slots, cpu_slots):
        raise AssertionError("bootstrapped slots differ from the CPU's")
    err = float(np.max(np.abs(gpu_slots.real - np.array(BOOT_VALUES))))
    if not err < BOOT_BOUND:
        raise AssertionError(f"n=512 bootstrap: error {err}")
    log(f"  n=512: {len(gpu)} keys and polys (stages {names}) torch.equal "
        f"to the CPU run; slots equal, max |err| {err:.3e}; card "
        f"{t1 - t0:.1f} s, CPU {t2 - t1:.1f} s")


def stage_clock(times, launches=None):
    """timed(name, fn) as ``stage_timer``'s, but every call's seconds are
    kept, in order, in the list ``times[name]``; given a dict `launches`,
    the launches of each call too, in ``launches[name]``."""

    def timed(name, fn):
        before = read_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append(time.perf_counter() - t0)
        if launches is not None:
            launches.setdefault(name, []).append(
                {k: v - before[k] for k, v in read_counters().items()})
        return out

    return timed


def untimed(name, fn):
    return fn()


def poly_states(*cts):
    return [p.data.cpu() for ct in cts for p in ct.polys]


def key_states(*keys):
    return [t.cpu() for k in keys for t in (k.b, k.a)]


def exact(label, got, want):
    if list(got) != list(want):
        raise AssertionError(f"{label}: decryption differs from the "
                             f"plaintext arithmetic")


def rows_of(x, n):
    h = n // 2
    return x[:h], x[h:]


def bgv_run(bgv, ctx, seed, timed):
    """BGV through every entry point of the slice: keys, a squaring chain
    with mod_reduce down to one tower, rotation, row flip, eval_sum,
    plaintext operands and compress, each decryption held to the plaintext
    arithmetic mod t. Returns (every key and ciphertext, every decryption)."""
    n, t = ctx.n, ctx.t
    rng = np.random.default_rng(seed)
    pk, sk = timed("keygen", lambda: bgv.keygen(ctx, rng))
    evk = timed("relin_keygen", lambda: bgv.relin_keygen(ctx, sk, rng))
    gal = bgv.sum_galois_indices(n)
    rks = timed("rot_keygen", lambda: bgv.rot_keygen(ctx, sk, gal, rng))
    v1 = rng.integers(0, t, size=n)
    v2 = rng.integers(0, t, size=n)
    ct1 = timed("encrypt", lambda: bgv.encrypt(ctx, pk, v1.tolist(), rng))
    ct2 = timed("encrypt", lambda: bgv.encrypt(ctx, pk, v2.tolist(), rng))
    states = [pk.b.data.cpu(), pk.a.data.cpu()] + key_states(
        evk, *[rks[k] for k in gal]) + poly_states(ct1, ct2)
    outs = {}

    def check(name, ct, want):
        states.extend(poly_states(ct))
        outs[name] = timed("decrypt", lambda: bgv.decrypt(ctx, sk, ct))
        exact(f"BGV {name}", outs[name], want.tolist())

    ct, x = ct1, v1
    for level in range(len(ctx.q_moduli) - 1):
        ct = timed("mult_relin", lambda: bgv.eval_mult_relin(ct, ct, evk))
        ct = timed("mod_reduce", lambda: bgv.mod_reduce(ctx, ct))
        x = x * x % t
        check(f"square^{level + 1} ({ct.towers} towers)", ct, x)
    a, b = rows_of(v1, n)
    check("rotate 1", timed("rotate", lambda: bgv.eval_rotate(
        ct1, 1, rks[gal[0]])), np.concatenate([np.roll(a, -1),
                                               np.roll(b, -1)]))
    check("flip rows", timed("flip_rows", lambda: bgv.eval_flip_rows(
        ct1, rks[2 * n - 1])), np.concatenate([b, a]))
    check("eval_sum", timed("eval_sum", lambda: bgv.eval_sum(ct1, rks)),
          np.full(n, v1.sum() % t))
    check("add", bgv.eval_add(ct1, ct2), (v1 + v2) % t)
    check("add_plain", bgv.eval_add_plain(ctx, ct1, v2.tolist()),
          (v1 + v2) % t)
    check("mult_plain", bgv.eval_mult_plain(ctx, ct1, v2.tolist()),
          v1 * v2 % t)
    small = timed("compress", lambda: bgv.compress(ctx, ct1))
    if small.towers != 1:
        raise AssertionError("BGV compress left more than one tower")
    check("compress", small, v1)
    return states, outs


def bfv_run(bfv, keyswitch, ctx, seed, levels, timed):
    """BFV through every entry point of the slice: an HPS squaring chain,
    one product each by HPSPOVERQ, HPSPOVERQLEVELED and BEHZ, rotation,
    eval_sum, the coefficient and string encodings, compress and a BV
    relinearisation, each exact. Returns (keys and ciphertexts,
    decryptions)."""
    n, t = ctx.n, ctx.t
    rng = np.random.default_rng(seed)
    pk, sk = timed("keygen", lambda: bfv.keygen(ctx, rng))
    evk = timed("relin_keygen", lambda: bfv.relin_keygen(ctx, sk, rng))
    gal = bfv.sum_galois_indices(n)
    rks = timed("rot_keygen", lambda: bfv.rot_keygen(ctx, sk, gal, rng))
    v1 = rng.integers(0, t, size=n)
    v2 = rng.integers(0, t, size=n)
    ct1 = timed("encrypt", lambda: bfv.encrypt(ctx, pk, v1.tolist(), rng))
    ct2 = timed("encrypt", lambda: bfv.encrypt(ctx, pk, v2.tolist(), rng))
    states = [pk.b.data.cpu(), pk.a.data.cpu()] + key_states(
        evk, *[rks[k] for k in gal]) + poly_states(ct1, ct2)
    outs = {}

    def check(name, ct, want, decrypt=bfv.decrypt):
        states.extend(poly_states(ct))
        outs[name] = timed("decrypt", lambda: decrypt(ctx, sk, ct))
        exact(f"BFV {name}", [outs[name]] if isinstance(want, str)
              else outs[name], [want] if isinstance(want, str)
              else list(want))

    ct, x = ct1, v1
    chain = [(ct1, v1)]
    for level in range(levels):
        ct = timed("mult_hps", lambda: bfv.eval_mult(ctx, ct, ct))
        ct = timed("relinearize", lambda: bfv.relinearize(ct, evk))
        x = x * x % t
        check(f"HPS square^{level + 1}", ct, x.tolist())
        chain.append((ct, x))
    prod = v1 * v2 % t
    # the leveled variant squares the chain's third square (noise degree
    # 4), where the noise estimate lets it drop a tower at n = 2^15
    deep, x_deep = chain[min(3, levels)]
    drop = bfv.find_levels_to_drop(ctx, deep.noise_deg - 1)
    log(f"  HPSPOVERQLEVELED at noise degree {deep.noise_deg}: {drop} "
        f"tower(s) dropped")
    for name, mult, want in (
            ("HPSPOVERQ", lambda: bfv.eval_mult_povq(ctx, ct1, ct2), prod),
            ("HPSPOVERQLEVELED", lambda: bfv.eval_mult_povq(
                ctx, deep, deep, leveled=True), x_deep * x_deep % t),
            ("BEHZ", lambda: bfv.eval_mult_behz(ctx, ct1, ct2), prod)):
        m = timed(f"mult_{name}", mult)
        check(name, bfv.relinearize(m, evk), want.tolist())
    a, b = rows_of(v1, n)
    check("rotate 1", timed("rotate", lambda: bfv.eval_rotate(
        ct1, 1, rks[gal[0]])), np.concatenate([np.roll(a, -1),
                                               np.roll(b, -1)]).tolist())
    check("eval_sum", timed("eval_sum", lambda: bfv.eval_sum(ct1, rks)),
          [int(v1.sum() % t)] * n)
    check("coefficients", bfv.encrypt_poly(ctx, pk, bfv.encode_coef(
        ctx, BFV_COEFS), rng), BFV_COEFS,
        lambda c, s, ct: bfv.decrypt_coef(c, s, ct, len(BFV_COEFS)))
    check("string", bfv.encrypt_poly(ctx, pk, bfv.encode_string(
        ctx, BFV_TEXT), rng), BFV_TEXT, bfv.decrypt_string)
    small = timed("compress", lambda: bfv.compress(ctx, ct1))
    if small.basis.L != 1:
        raise AssertionError("BFV compress left more than one tower")
    check("compress", small, v1.tolist())
    # BV relinearisation of the HPS product
    bvp = keyswitch.BVKSParams(n, ctx.q_moduli, BV_LOG_BASE)
    s = sk.poly(ctx.basis(), ctx.device)
    bv_key = timed("bv_keygen", lambda: keyswitch.bv_keygen(
        bvp, s, bfv.dcrt.mul(s, s), rng))
    states.extend(key_states(bv_key))
    m = bfv.eval_mult(ctx, ct1, ct2)
    d0, d1 = timed("bv_apply", lambda: keyswitch.bv_apply(bv_key,
                                                          m.polys[2]))
    check("BV relinearised", bfv.Ciphertext(
        (bfv.dcrt.add(m.polys[0], d0), bfv.dcrt.add(m.polys[1], d1)),
        noise_deg=m.noise_deg), prod.tolist())
    return states, outs


def log_stages(times, launches=None):
    log("  stage seconds (calls: first, median): " + ", ".join(
        f"{k} x{len(v)}: {v[0]:.4f}, {float(np.median(v)):.4f}"
        for k, v in times.items()))
    if launches:
        log("  launches a call (median): " + "; ".join(
            f"{k} {({w: int(np.median([c[w] for c in v])) for w in v[0]})}"
            for k, v in launches.items()))


def host_codec_times(ctx, rng):
    """Host seconds of one packed encode, one decode and one centered CRT
    interpolation over all Q towers (BGV's decrypt) at the context's size."""
    from openfhe_tpu_torch import encoding
    from openfhe_tpu_torch.models import ckks
    n, t = ctx.n, ctx.t
    vals = rng.integers(0, t, size=n).tolist()
    t0 = time.perf_counter()
    coeffs = encoding.packed_encode(vals, n, t)
    t1 = time.perf_counter()
    if encoding.packed_decode(coeffs, n, t) != vals:
        raise AssertionError("packed encode/decode does not round-trip")
    t2 = time.perf_counter()
    rows = np.stack([rng.integers(0, q, size=n, dtype=np.uint64)
                     for q in ctx.q_moduli]).astype(np.int64)
    t3 = time.perf_counter()
    ckks.crt_interpolate_centered(rows, ctx.q_moduli)
    return t1 - t0, t2 - t1, time.perf_counter() - t3


def fhe_at_scale(label, run, ctx):
    """Phases 8 and 9: one scheme at n = 2^15 on the card, every kernel
    counted; returns the launches."""
    times = {}
    reset_counters()
    run(ctx, stage_clock(times))
    launches = read_counters()
    enc, dec, crt = host_codec_times(ctx, np.random.default_rng(1))
    log(f"  {label} n={ctx.n}: towers {len(ctx.q_moduli)}+"
        f"{len(ctx.p_moduli)}, every decryption exact")
    log_stages(times)
    log(f"  host: packed encode {enc:.4f} s, decode {dec:.4f} s, centered "
        f"CRT over {len(ctx.q_moduli)} towers {crt:.4f} s")
    log(f"  launches: {launches}")
    missing = [k for k in FOUR_STEP + MACS if launches[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched: {missing}")
    return launches


def fhe_against_cpu(label, run, make_ctx):
    """Phase 10: the scheme at n = 2^12 on the card equals the CPU run."""
    gpu, gpu_out = run(make_ctx(torch.device("cuda", 0)), untimed)
    cpu, cpu_out = run(make_ctx(torch.device("cpu")), untimed)
    if len(gpu) != len(cpu) or not all(torch.equal(g, c)
                                       for g, c in zip(gpu, cpu)):
        raise AssertionError(f"{label} on the card differs from the CPU")
    if gpu_out != cpu_out:
        raise AssertionError(f"{label}: decryptions differ from the CPU's")
    log(f"  {label} n=4096: {len(gpu)} keys and ciphertext polys torch.equal "
        f"to the CPU run; {len(gpu_out)} decryptions equal")


# ---------------------------------------------------------------------------
# Phases 11-16: threshold FHE, interactive bootstrapping, PRE, archives
# ---------------------------------------------------------------------------


def joint_keys(mp, ctx, rng, parties, timed):
    """The lead's key, then each other party's share folded in."""
    pk, sk = timed("keygen_lead", lambda: mp.keygen_lead(ctx, rng))
    sks = [sk]
    for _ in range(parties - 1):
        pk, sk = timed("keygen_join", lambda: mp.keygen_join(ctx, pk, rng))
        sks.append(sk)
    return pk, sks


def joint_eval_keys(mp, ctx, sks, rng, timed):
    """The two-round joint relinearization key and the one-round joint key
    of rotation 1; returns (every share, evk, rotation key)."""
    r1 = [timed("evalmult_round1", lambda: mp.evalmult_round1(ctx, sks[0],
                                                              rng))]
    for s in sks[1:]:
        r1.append(timed("evalmult_round1", lambda: mp.evalmult_round1(
            ctx, s, rng, prev_key=r1[0])))
    ab = mp.evalmult_accumulate_round1(r1)
    r2 = [timed("evalmult_round2", lambda: mp.evalmult_round2(ctx, s, ab,
                                                              rng))
          for s in sks]
    evk = timed("evalmult_finalize", lambda: mp.evalmult_finalize(r2))
    rsh = [timed("rot_keygen_share", lambda: mp.rot_keygen_share(
        ctx, sks[0], 1, rng))]
    for s in sks[1:]:
        rsh.append(timed("rot_keygen_share", lambda: mp.rot_keygen_share(
            ctx, s, 1, rng, prev_key=rsh[0])))
    rk = mp.rot_keygen_finalize(rsh)
    return r1 + r2 + rsh, evk, rk


def dist_decrypt(mp, ctx, sks, ct, rng, timed, slots=None):
    """Lead + main partial decryptions and their fusion: (partials, slots)."""
    parts = [timed("decrypt_lead", lambda: mp.decrypt_lead(ctx, sks[0], ct,
                                                           rng))]
    for s in sks[1:]:
        parts.append(timed("decrypt_main", lambda: mp.decrypt_main(
            ctx, s, ct, rng)))
    return parts, timed("combine", lambda: mp.combine(ctx, ct, parts, slots))


def close(label, got, want, bound):
    got = np.asarray(got)
    if not np.all(np.isfinite(got)) or got.shape != np.shape(want):
        raise AssertionError(f"{label}: decrypted slots malformed")
    err = float(np.max(np.abs(got.real - want)))
    if not err < bound:
        raise AssertionError(f"{label}: error {err} above bound {bound}")
    return err


def threshold_ckks_run(ckks, mp, ctx, seed, timed):
    """Phase 11's flow: 3 parties' joint keys, encrypt v1 and v2 under the
    joint key, EvalMult -> relinearize -> rescale -> EvalRotate(1), then
    distributed decryption. Returns (states, outputs, what the later phases
    reuse)."""
    n = ctx.n
    rng = np.random.default_rng(seed)
    pk, sks = joint_keys(mp, ctx, rng, 3, timed)
    shares, evk, rk = joint_eval_keys(mp, ctx, sks, rng, timed)
    v1 = rng.uniform(-1, 1, size=n // 2)
    v2 = rng.uniform(-1, 1, size=n // 2)
    ct1 = timed("encrypt", lambda: ckks.encrypt(ctx, pk, v1, rng))
    ct2 = timed("encrypt", lambda: ckks.encrypt(ctx, pk, v2, rng))
    prod = timed("eval_mult_relin", lambda: ckks.eval_mult_relin(ct1, ct2,
                                                                 evk))
    res = timed("rescale", lambda: ckks.rescale_ctx(ctx, prod))
    rot = timed("eval_rotate", lambda: ckks.eval_rotate(res, 1, rk))
    parts, out = dist_decrypt(mp, ctx, sks, rot, rng, timed, n // 2)
    single = ckks.decrypt(ctx, sks[0], rot, num_slots=n // 2)
    states = [pk.b.data.cpu(), pk.a.data.cpu()] + key_states(
        *shares, evk, rk) + poly_states(ct1, ct2, prod, res, rot) + [
        p.data.cpu() for p in parts]
    want = np.roll(v1 * v2, -1)
    return states, [out, single], dict(pk=pk, sks=sks, evk=evk, rot=rot,
                                       want=want, ct1=ct1, ct2=ct2)


def mp_boot_run(ckks, mp, ctx, pk, sks, seed, timed):
    """Phase 12's flow (examples/tckks_interactive_mp_bootstrapping.py):
    spend levels with plaintext products until the message and mask towers
    are left, the one-round interactive bootstrap, one more plaintext
    product at the regained level, each distributed-decrypted."""
    n = ctx.n
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1, 1, size=n // 2)
    ct = ckks.encrypt(ctx, pk, v, rng)
    keep = ctx.params.scaling_mod_size // ctx.params.first_mod_size + 2
    ones = np.ones(n // 2)
    while ct.towers - ctx.params.composite_degree >= keep:
        ct = ckks.rescale_ctx(ctx, ckks.eval_mult_plain(ctx, ct, ones))
    small = timed("int_mp_boot_adjust_scale",
                  lambda: mp.int_mp_boot_adjust_scale(ctx, ct))
    a = timed("int_mp_boot_random_element_gen",
              lambda: mp.int_mp_boot_random_element_gen(ctx, rng))
    pairs = [timed(f"int_mp_boot_decrypt party {i}",
                   lambda: mp.int_mp_boot_decrypt(ctx, s, small, a, rng))
             for i, s in enumerate(sks, 1)]
    agg = timed("int_mp_boot_add", lambda: mp.int_mp_boot_add(pairs))
    fresh = timed("int_mp_boot_encrypt",
                  lambda: mp.int_mp_boot_encrypt(ctx, agg, a, small))
    sq = ckks.rescale_ctx(ctx, ckks.eval_mult_plain(ctx, fresh, v))
    parts, out = dist_decrypt(mp, ctx, sks, sq, rng, timed, n // 2)
    states = poly_states(ct, small, fresh, sq) + [a.data.cpu()] + [
        h.data.cpu() for pair in pairs + [agg] for h in pair] + [
        p.data.cpu() for p in parts]
    return states, [out], dict(small=small, fresh=fresh, want=v * v)


def threshold_int_run(module, mp, ctx, parties, seed, timed):
    """Phase 13's flow for BGV or BFV: joint keys, the joint relinearization
    and rotation keys, EvalMult + relinearize (BGV also mod_reduce; BFV by
    HPS), a rotation, and a distributed decryption at each step, each
    held to the plaintext arithmetic mod t."""
    n, t = ctx.n, ctx.t
    bgv_like = hasattr(module, "mod_reduce")
    rng = np.random.default_rng(seed)
    pk, sks = joint_keys(mp, ctx, rng, parties, timed)
    shares, evk, rk = joint_eval_keys(mp, ctx, sks, rng, timed)
    v1 = rng.integers(0, t, size=n)
    v2 = rng.integers(0, t, size=n)
    ct1 = timed("encrypt", lambda: module.encrypt(ctx, pk, v1.tolist(), rng))
    ct2 = timed("encrypt", lambda: module.encrypt(ctx, pk, v2.tolist(), rng))
    if bgv_like:
        prod = timed("eval_mult_relin",
                     lambda: module.eval_mult_relin(ct1, ct2, evk))
    else:
        prod = timed("eval_mult_relin",
                     lambda: module.eval_mult_relin(ctx, ct1, ct2, evk))
    rot = timed("eval_rotate", lambda: module.eval_rotate(ct1, 1, rk))
    a, b = rows_of(v1, n)
    steps = [("fresh", ct1, v1), ("mult+relin", prod, v1 * v2 % t),
             ("rotate 1", rot, np.concatenate([np.roll(a, -1),
                                               np.roll(b, -1)]))]
    if bgv_like:
        red = timed("mod_reduce", lambda: module.mod_reduce(ctx, prod))
        steps.append(("mod_reduce", red, v1 * v2 % t))
    states = [pk.b.data.cpu(), pk.a.data.cpu()] + key_states(
        *shares, evk, rk)
    outs = []
    for name, ct, want in steps:
        parts, got = dist_decrypt(mp, ctx, sks, ct, rng, timed)
        states += poly_states(ct) + [p.data.cpu() for p in parts]
        outs.append(got)
        exact(f"threshold {name}", got, want.tolist())
    return states, outs


PRE_MODES = ("INDCPA", "FIXED_NOISE_HRA", "NOISE_FLOODING_HRA")


def pre_run(module, pre, ctx, seed, timed):
    """Phase 14's flow for one scheme: sender and receiver keys, rekey_gen,
    one ciphertext under the sender's key re-encrypted in each mode; the
    receiver must decrypt each, the sender must not. Returns (states,
    decryptions, {mode: re-encrypted ciphertext}, the receiver's key)."""
    n = ctx.n
    scheme = module.__name__.rsplit(".", 1)[1]
    scale = ctx.t if scheme == "bgv" else 1
    rng = np.random.default_rng(seed)
    pk_a, sk_a = module.keygen(ctx, rng)
    _, sk_b = module.keygen(ctx, rng)
    rk = timed("rekey_gen", lambda: pre.rekey_gen(ctx, sk_a, sk_b, rng,
                                                   error_scale=scale))
    if scheme == "ckks":
        v = rng.uniform(-1, 1, size=n // 2)
    else:
        v = rng.integers(0, ctx.t, size=n)
    ct = module.encrypt(ctx, pk_a, v.tolist() if scheme != "ckks" else v,
                        rng)
    states = key_states(rk) + poly_states(ct)
    outs, moved = [], {}
    for mode in PRE_MODES:
        c = timed(f"re_encrypt {mode}", lambda: pre.re_encrypt(
            ct, rk, ctx=ctx, pk=pk_a, mode=mode, rng=rng, noise_scale=scale))
        moved[mode] = c
        got = module.decrypt(ctx, sk_b, c)
        wrong = module.decrypt(ctx, sk_a, c)
        states += poly_states(c)
        outs += [got, wrong]
        label = f"PRE {scheme} {mode}"
        if scheme == "ckks":
            close(label, got, v, BOUND)
            if not np.max(np.abs(np.asarray(wrong).real - v)) > 1e-2:
                raise AssertionError(f"{label}: the sender's key decrypts")
        else:
            exact(label, got, v.tolist())
            if list(wrong) == v.tolist():
                raise AssertionError(f"{label}: the sender's key decrypts")
    return states, outs, moved, sk_b


def archive_round_trips(serial, objects, device):
    """Phase 15: each object saved and loaded back in both flavours; returns
    {(name, fmt): (loaded object, save s, load s, bytes)}."""
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for name, obj in objects.items():
            for fmt in ("binary", "json"):
                path = f"{d}/{name}.{fmt}"
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                serial.save(obj, path, fmt)
                t1 = time.perf_counter()
                loaded = serial.load(path, device)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                out[name, fmt] = (loaded, t1 - t0, t2 - t1,
                                  os.path.getsize(path))
    return out


def same_tensors(label, got, want):
    if len(got) != len(want) or not all(torch.equal(g, w)
                                        for g, w in zip(got, want)):
        raise AssertionError(f"{label}: differs from what was saved")


def small_threshold_states(device):
    """Phase 16: the flows of phases 11-14 at small n on `device`: threshold
    CKKS with the interactive bootstrap on the 60-bit and the composite
    chain at n = 4096 (the smallest ring the NTT's Hopper path takes),
    threshold BGV and BFV at n = 2^12, PRE on each."""
    from openfhe_tpu_torch.models import bfv, bgv, ckks
    from openfhe_tpu_torch.models import multiparty as mp
    from openfhe_tpu_torch.models import pre
    states, outs = [], []
    for degree, seed in ((1, 31), (2, 37)):
        ctx = ckks.gen_context(ckks.CKKSParams(
            ring_dim=4096, mult_depth=3, scaling_mod_size=59,
            first_mod_size=60, dnum=3, composite_degree=degree), device)
        st, out, keep = threshold_ckks_run(ckks, mp, ctx, seed, untimed)
        states += st
        outs += out
        st, out, _ = mp_boot_run(ckks, mp, ctx, keep["pk"], keep["sks"],
                                 seed + 1, untimed)
        states += st
        outs += out
        st, out, _, _ = pre_run(ckks, pre, ctx, seed + 2, untimed)
        states += st
        outs += out
    for module, params, parties, seed in (
            (bgv, bgv.BGVParams(**SMALL_BGV_PARAMS), 3, 41),
            (bfv, bfv.BFVParams(**SMALL_BFV_PARAMS), 5, 43)):
        ctx = module.gen_context(params, device)
        st, out = threshold_int_run(module, mp, ctx, parties, seed, untimed)
        states += st
        outs += out
        st, out, _, _ = pre_run(module, pre, ctx, seed + 2, untimed)
        states += st
        outs += out
    return states, outs


def threshold_and_pre(ctx60, ctx_bgv, ctx_bfv, device, boot_warm_s):
    """Phases 11-16 on the contexts of phases 3, 8 and 9; returns the
    launches of phases 11-13 and of phase 14."""
    from openfhe_tpu_torch.models import bfv, bgv, ckks

    from openfhe_tpu_torch.models import multiparty as mp
    from openfhe_tpu_torch.models import pre
    from openfhe_tpu_torch.utils import serial

    log("[11] threshold CKKS at n = 2^16 on the 60-bit chain, 3 parties")
    times = {}
    reset_counters()
    _, (out, single), keep = threshold_ckks_run(ckks, mp, ctx60, 13,
                                                stage_clock(times))
    phase11 = read_counters()
    err = close("threshold CKKS", out, keep["want"], BOUND)
    single_err = float(np.max(np.abs(np.asarray(single).real
                                     - keep["want"])))
    if not single_err > 1e-2:
        raise AssertionError("one share alone decrypts the joint ciphertext")
    log(f"  distributed decryption max |err| {err:.3e} (bound {BOUND}); one "
        f"share alone {single_err:.3e}")
    log_stages(times)
    log(f"  launches: {phase11}")
    missing = [k for k in FOUR_STEP + MACS if phase11[k] == 0]
    if missing:
        raise AssertionError(f"threshold CKKS: kernels never launched: "
                             f"{missing}")

    log("[12] interactive bootstrap at n = 2^16 on the joint key")
    times = {}
    _, (out,), boot_out = mp_boot_run(ckks, mp, ctx60, keep["pk"],
                                      keep["sks"], 17, stage_clock(times))
    towers = (boot_out["small"].towers, boot_out["fresh"].towers)
    if towers != (2, len(ctx60.q_moduli)):
        raise AssertionError(f"interactive bootstrap: towers {towers}")
    err = close("interactive bootstrap", out, boot_out["want"], BOUND)
    log(f"  towers {boot_out['small'].towers} -> "
        f"{boot_out['fresh'].towers}; v^2 after one more product max |err| "
        f"{err:.3e} (bound {BOUND})")
    log_stages(times)
    shares_s = ", ".join(f"{times[f'int_mp_boot_decrypt party {i}'][0]:.4f}"
                         for i in (1, 2, 3))
    log(f"  host seconds: the parties' shares {shares_s}, "
        f"the lead's final step {times['int_mp_boot_encrypt'][0]:.4f}; the "
        f"single-key bootstrap of phase 6 (warm) {boot_warm_s:.4f}")

    log("[13] threshold BGV (3 parties) and BFV (5 parties) at n = 2^15")
    for label, module, ctx, parties, seed in (
            ("BGV", bgv, ctx_bgv, 3, 19), ("BFV", bfv, ctx_bfv, 5, 29)):
        times = {}
        threshold_int_run(module, mp, ctx, parties, seed, stage_clock(times))
        log(f"  {label} n={ctx.n}, {parties} parties: every distributed "
            f"decryption exact")
        log_stages(times)
    threshold_launches = read_counters()
    log(f"  launches in phases 11-13: {threshold_launches}")

    log("[14] PRE at full width, three modes each")
    reset_counters()
    moved = {}
    for label, module, ctx, seed in (("CKKS", ckks, ctx60, 47),
                                     ("BGV", bgv, ctx_bgv, 53),
                                     ("BFV", bfv, ctx_bfv, 59)):
        times = {}
        _, _, moved[label], receiver = pre_run(module, pre, ctx, seed,
                                               stage_clock(times))
        moved[label + " key"] = receiver
        log(f"  {label} n={ctx.n}: the receiver decrypts all three modes, "
            f"the sender none")
        log_stages(times)
    pre_launches = read_counters()
    log(f"  launches: {pre_launches}")
    missing = [k for k in FOUR_STEP + MACS if pre_launches[k] == 0]
    if missing:
        raise AssertionError(f"PRE: kernels never launched: {missing}")

    log("[15] archives on the card, both flavours")
    bgv_ct = moved["BGV"]["INDCPA"]
    saved = {"bgv_ciphertext": bgv_ct, "joint_public_key": keep["pk"],
             "joint_relin_key": keep["evk"], "ckks_ciphertext": keep["rot"]}
    for (name, fmt), (obj, save_s, load_s, size) in archive_round_trips(
            serial, saved, device).items():
        orig = saved[name]
        if name.endswith("ciphertext"):
            same_tensors(f"{name} {fmt}", poly_states(obj), poly_states(orig))
            if name == "bgv_ciphertext":
                sk = moved["BGV key"]
                same = bgv.decrypt(ctx_bgv, sk, obj) == \
                    bgv.decrypt(ctx_bgv, sk, orig)
            else:
                sks = keep["sks"]
                same = np.array_equal(*(dist_decrypt(
                    mp, ctx60, sks, c, np.random.default_rng(3), untimed)[1]
                    for c in (obj, orig)))
        elif name == "joint_public_key":
            same_tensors(f"{name} {fmt}", [obj.b.data, obj.a.data],
                         [orig.b.data, orig.a.data])
            same = all(torch.equal(x, y) for x, y in zip(*(poly_states(
                ckks.encrypt(ctx60, key, [0.5], np.random.default_rng(5)))
                for key in (obj, orig))))
        else:
            same_tensors(f"{name} {fmt}", [obj.b, obj.a], [orig.b, orig.a])
            prod = ckks.eval_mult(keep["ct1"], keep["ct2"])
            same = all(torch.equal(x, y) for x, y in zip(*(poly_states(
                ckks.relinearize(prod, key)) for key in (obj, orig))))
        if not same:
            raise AssertionError(f"{name} {fmt}: the loaded object does not "
                                 f"decrypt the same")
        log(f"  {name} {fmt}: torch.equal and decrypts the same; save "
            f"{save_s:.4f} s, load {load_s:.4f} s, {size} bytes")

    log("[16] threshold, interactive bootstrap and PRE at small n on the "
        "card against the CPU")
    gpu, gpu_out = small_threshold_states(device)
    cpu, cpu_out = small_threshold_states(torch.device("cpu"))
    if len(gpu) != len(cpu) or not all(torch.equal(g, c)
                                       for g, c in zip(gpu, cpu)):
        raise AssertionError("threshold/PRE on the card differs from the CPU")
    if len(gpu_out) != len(cpu_out) or not all(
            np.array_equal(np.asarray(g), np.asarray(c))
            for g, c in zip(gpu_out, cpu_out)):
        raise AssertionError("threshold/PRE decryptions differ from the CPU's")
    log(f"  {len(gpu)} shares, joint keys, partial decryptions and "
        f"ciphertext polys torch.equal to the CPU run; {len(gpu_out)} "
        f"decryptions equal")
    return threshold_launches, pre_launches


# ---------------------------------------------------------------------------
# Phase 17: BINFHE gates
# ---------------------------------------------------------------------------

PAIRS = ((0, 0), (0, 1), (1, 0), (1, 1))
BOOL_GATES = {"AND": lambda x, y: x & y, "OR": lambda x, y: x | y,
              "NAND": lambda x, y: 1 - (x & y),
              "NOR": lambda x, y: 1 - (x | y), "XOR": lambda x, y: x ^ y,
              "XNOR": lambda x, y: 1 - (x ^ y)}
MULTI_GATES = {"MAJORITY": lambda v: int(sum(v) >= 2), "AND3": min,
               "OR3": max, "AND4": min, "OR4": max,
               "CMUX": lambda v: v[1] if v[2] else v[0]}
REFRESHES = 10
# (set, seed, what runs): STD128 runs everything; the wide-Q GINX set and
# the AP set run two gates each
BINFHE_RUNS = (("STD128", 61, dict()),
               ("STD128Q_3", 67, dict(gates=("AND", "NAND"), multi=(),
                                      refreshes=0, public_key=False)),
               ("STD128_AP", 71, dict(gates=("AND", "OR"), multi=(),
                                      refreshes=0, public_key=False)))
# card against CPU: the same flow, fewer gates
BINFHE_SMALL = dict(gates=tuple(BOOL_GATES), multi=("MAJORITY", "CMUX"),
                    refreshes=1)


def binfhe_flow(binfhe, ctx, seed, timed, gates=tuple(BOOL_GATES),
                multi=tuple(MULTI_GATES), refreshes=REFRESHES,
                public_key=True):
    """BINFHE through its entry points: keys, each 2-input gate over its
    truth table as one batch, NOT, the multi-input gates and CMUX over every
    input, a chain of refreshes and a public-key encryption switched into a
    gate. Every decryption is held to the plaintext truth. Returns (the
    secret, the bootstrap key, every tensor, every (b, modulus, bit))."""
    rng = np.random.default_rng(seed)
    sk = timed("keygen", lambda: binfhe.keygen(ctx, rng))
    bk = timed("bootstrap_keygen",
               lambda: binfhe.bootstrap_keygen(ctx, sk, rng))
    states = [bk.ek.cpu(), bk.ks_a.cpu(), bk.ks_b.cpu()]
    outs = []

    def check(label, cts, want):
        got = [binfhe.decrypt(ctx, sk, c) for c in cts]
        states.extend(c.a.cpu() for c in cts)
        outs.extend((c.b, c.modulus, g) for c, g in zip(cts, got))
        if got != list(want):
            raise AssertionError(f"BINFHE {label}: decrypted {got}, want "
                                 f"{list(want)}")

    for gate in gates:
        c1 = [binfhe.encrypt(ctx, sk, x, rng) for x, _ in PAIRS]
        c2 = [binfhe.encrypt(ctx, sk, y, rng) for _, y in PAIRS]
        check(gate, timed(gate, lambda: binfhe.eval_gate_batch(
            ctx, gate, bk, c1, c2)), [BOOL_GATES[gate](x, y)
                                      for x, y in PAIRS])
    if gates:
        check("NOT", [binfhe.eval_not(ctx, binfhe.encrypt(ctx, sk, x, rng))
                      for x in (0, 1)], [1, 0])
    for gate in multi:
        arity, p = (3, 4) if gate == "CMUX" else \
            binfhe.MULTI_GATES[gate][:2]
        combos = list(itertools.product((0, 1), repeat=arity))
        batches = [[binfhe.encrypt_zp(ctx, sk, v, p, rng) for v in c]
                   for c in combos]
        check(gate, timed(gate, lambda: binfhe.eval_gate_vec_batch(
            ctx, gate, bk, batches)), [MULTI_GATES[gate](c) for c in combos])
    ct = binfhe.encrypt(ctx, sk, 1, rng)
    for k in range(refreshes):
        ct = timed("bootstrap", lambda: binfhe.bootstrap(ctx, bk, ct))
        check(f"refresh {k + 1}", [ct], [1])
    if public_key:
        pk = timed("pubkey_gen", lambda: binfhe.pubkey_gen(ctx, sk, rng))
        states += [pk.A.cpu(), pk.v.cpu()]
        big = [timed("encrypt_pk", lambda: binfhe.encrypt_pk(ctx, pk, m, rng))
               for m in (0, 1)]
        moved = [timed("switch_ct_to_qn", lambda: binfhe.switch_ct_to_qn(
            ctx, bk, c)) for c in big]
        check("switch_ct_to_qn", moved, [0, 1])
        one = [binfhe.encrypt(ctx, sk, 1, rng) for _ in moved]
        check("public key -> AND", binfhe.eval_gate_batch(
            ctx, "AND", bk, moved, one), [0, 1])
    return sk, bk, states, outs


def binfhe_small_states(binfhe, serial, name, device):
    """Phase 17's card-against-CPU run at a TOY set on `device`: the flow's
    keys and outputs, then the context, secret, a ciphertext and the
    bootstrap key saved in both flavours and loaded to the CPU."""
    ctx = binfhe.gen_context(name, device)
    sk, bk, states, outs = binfhe_flow(binfhe, ctx, 73, untimed,
                                       **BINFHE_SMALL)
    ct = binfhe.encrypt(ctx, sk, 1, np.random.default_rng(5))
    docs = []
    with tempfile.TemporaryDirectory() as d:
        for fmt in ("binary", "json"):
            for i, obj in enumerate((ctx, sk, ct, bk)):
                path = f"{d}/{i}.{fmt}"
                serial.save(obj, path, fmt)
                if fmt == "json":
                    with open(path, "rb") as f:
                        docs.append(f.read())
                back = serial.load(path, "cpu")
                if obj is ct:
                    states.append(back.a)
                    outs.append((back.b, back.modulus))
                elif obj is bk:
                    states += [back.ek, back.ks_a, back.ks_b]
                elif obj is sk:
                    states += [torch.from_numpy(back.s_lwe),
                               torch.from_numpy(back.z_ring)]
                else:
                    outs.append(back.params)
    return states, outs, docs


def binfhe_phase(device):
    """Phase 17: BINFHE at STD128 (GINX, N = 1024, n = 503) with every gate,
    STD128Q_3 (50-bit Q, N = 2048) and STD128_AP (DM) with two gates each,
    every decryption exact and every kernel of the path launched; then TOY
    and TOY_AP on the card equal to the CPU. Returns the launches."""
    from openfhe_tpu_torch.models import binfhe
    from openfhe_tpu_torch.utils import serial

    reset_counters()
    per_gate = {}
    for name, seed, kw in BINFHE_RUNS:
        ctx = binfhe.gen_context(name, device)
        p = ctx.params
        times = {}
        timed = stage_clock(times)
        sk, bk, _, outs = binfhe_flow(binfhe, ctx, seed, timed, **kw)
        log(f"  {name} ({p.method}): N={p.N}, n={p.n_lwe}, "
            f"{p.Q.bit_length()}-bit Q, q={p.q}, q_ks={p.q_ks}, "
            f"B_g=2^{p.log_bg} (dg={p.dg}), B_ks={p.B_ks} (d_ks={p.d_ks})"
            + (f", B_r={p.B_r} (d_r={p.d_r})" if p.method == "AP" else "")
            + f"; bootstrap key {tuple(bk.ek.shape)} "
            f"{bk.ek.numel() * 8 / 1e6:.1f} MB, key-switch key "
            f"{tuple(bk.ks_a.shape)} {bk.ks_a.numel() * 8 / 1e6:.1f} MB; "
            f"{len(outs)} decryptions exact")
        log_stages(times)
        # one batched gate (B = 4) alone: its launches and host seconds
        rng = np.random.default_rng(seed + 1)
        cts = [binfhe.encrypt(ctx, sk, x, rng) for x in (0, 1)]
        before = read_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        binfhe.eval_gate_batch(ctx, "AND", bk, cts * 2, cts[::-1] * 2)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        per_gate[name] = {k: v - before[k] for k, v in read_counters().items()}
        log(f"  one batched AND (B = 4): {secs:.4f} s, launches "
            f"{per_gate[name]}")
        del bk
    launches = read_counters()
    log(f"  launches in phase 17: {launches}")
    missing = [k for k in SMALL_NTT + ("ks_inner_product",)
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"BINFHE: kernels never launched: {missing}")

    for name in ("TOY", "TOY_AP"):
        t0 = time.perf_counter()
        gpu, gpu_out, gpu_docs = binfhe_small_states(binfhe, serial, name,
                                                     device)
        t1 = time.perf_counter()
        cpu, cpu_out, cpu_docs = binfhe_small_states(binfhe, serial, name,
                                                     torch.device("cpu"))
        t2 = time.perf_counter()
        if len(gpu) != len(cpu) or not all(torch.equal(g.cpu(), c)
                                           for g, c in zip(gpu, cpu)):
            raise AssertionError(f"BINFHE {name} on the card differs from "
                                 f"the CPU")
        if gpu_out != cpu_out or gpu_docs != cpu_docs:
            raise AssertionError(f"BINFHE {name}: outputs or JSON archives "
                                 f"differ from the CPU's")
        log(f"  {name}: {len(gpu)} keys, ciphertexts and loaded archives "
            f"torch.equal to the CPU run, {len(gpu_out)} outputs and "
            f"{len(gpu_docs)} JSON archives equal; card {t1 - t0:.1f} s, "
            f"CPU {t2 - t1:.1f} s")
    return launches, per_gate


# ---------------------------------------------------------------------------
# Phases 18-20: the rest of BINFHE (large precision, LMKCDEY) and CKKS <->
# FHEW scheme switching
# ---------------------------------------------------------------------------

LP_BETA = 64                       # tests/test_binfhe.py:136-176
LP_FLOORS = (1000, 5000, 12345)
LP_SIGNS = (100, 7000, 9000, 16000)
LP_DECOMP = 12345
P_MSG = 8
LUT = (0, 1, 2, 3, 0, 7, 6, 5)     # negacyclic over Z_8
SIGN_LUT = (0, 1, 1, 1, 0, 7, 7, 7)  # eval_sign's table at p = 8
LMK_GATES = ("AND", "OR", "XOR", "NAND")
LP_SET, LMK_SET = "STD128", "STD128_LMKCDEY"   # phase 18
LP_SEED = 81
# The JAX package's decryptions of lp_flow at STD128 for LP_SEED (jitted on
# the CPU by tests/test_torch_binfhe_lp.py, which holds them to these):
# eval_floor(5000) and eval_sign_large(7000) miss the JAX test's bounds in
# the JAX package too (ROADMAP Queue 3), so phase 18 holds the port to them
LP_REFERENCE = {"STD128": {
    "eval_floor": [100, 6473, 12316], "eval_sign_large": [0, 1, 1, 1],
    "eval_decomp": [60, 764], "eval_sign": [0, 1, 1, 1, 0, 7, 7, 7]}}
# Phase 19: the CKKS parameters of examples/scheme_switching.py:22-23 at
# ring 2^16 and its FHEW set (:15-17), the only FHEW width the JAX
# package's scheme switching runs
SWITCH_CKKS = dict(mult_depth=13, scaling_mod_size=35, first_mod_size=50,
                   dnum=3, secret_hw=64)
SWITCH_SETUP = dict(slots=8, cheb_deg=56)
SWITCH_SMALL_RING = 512            # phase 20, tests/test_scheme_switch.py's
SWITCH_BITS = (0, 1, 1, 0, 1, 0, 0, 1)
SWITCH_V1 = (3, 1, 2, 0, 3, 2, 1, 1)
SWITCH_V2 = (1, 3, 0, 2, 1, 3, 3, 2)
# the JAX tests' decode bounds (tests/test_scheme_switch.py)
F2C_BOUND, COMPARE_BOUND, MINMAX_BOUND, ALT_BOUND = 0.12, 0.12, 0.15, 0.2


def need(ok, what):
    if not ok:
        raise AssertionError(what)


def lp_flow(binfhe, ctx, seed, timed, floors=LP_FLOORS, signs=LP_SIGNS,
            sign_msgs=tuple(range(P_MSG))):
    """The large-precision functions at a GINX set, input modulus q_ks,
    beta = 64: eval_floor, eval_sign_large, eval_decomp and eval_sign over
    Z_8, through either package's module (the port's here; the JAX
    package's in tests/test_torch_binfhe_lp.py, untimed). Returns (the
    bootstrap key, the output ciphertexts, the decryptions by op, the
    decryptions that miss the JAX test's bound: eval_floor within 2 beta,
    eval_sign_large exact, eval_decomp at least 2 digits, the first within 16
    of v mod 2N, eval_sign exact)."""
    rng = np.random.default_rng(seed)
    p = ctx.params
    q, mod = 2 * p.N, p.q_ks
    sk = binfhe.keygen(ctx, rng)
    bk = timed("bootstrap_keygen", lambda: binfhe.bootstrap_keygen(ctx, sk,
                                                                   rng))
    outs, misses = [], []
    dec = {k: [] for k in ("eval_floor", "eval_sign_large", "eval_decomp",
                           "eval_sign")}

    def run(name, fn, read, *args):
        res = timed(name, lambda: fn(ctx, bk, *args))
        res = res if isinstance(res, list) else [res]
        outs.extend(res)
        dec[name].extend(read(c) for c in res)
        return dec[name][-len(res):]

    for v in floors:
        ct = binfhe.encrypt_phase(ctx, sk, v, mod, rng)
        got, = run("eval_floor", binfhe.eval_floor,
                   lambda c: binfhe.decrypt_phase(ctx, sk, c), ct, LP_BETA)
        want = (v + LP_BETA) // q * q
        if not min((got - want) % mod, (want - got) % mod) < 2 * LP_BETA:
            misses.append(f"eval_floor({v}) = {got}, want {want} within "
                          f"{2 * LP_BETA}")
    for v in signs:
        ct = binfhe.encrypt_phase(ctx, sk, v, mod, rng)
        got, = run("eval_sign_large", binfhe.eval_sign_large,
                   lambda c: binfhe.decrypt_zp(ctx, sk, c, 2), ct, LP_BETA)
        if got != int(v >= mod // 2):
            misses.append(f"eval_sign_large({v}) = {got}")
    ct = binfhe.encrypt_phase(ctx, sk, LP_DECOMP, mod, rng)
    digs = run("eval_decomp", binfhe.eval_decomp,
               lambda c: binfhe.decrypt_phase(ctx, sk, c), ct, LP_BETA)
    d0, v0 = digs[0], LP_DECOMP % q
    if not (len(digs) >= 2 and min((d0 - v0) % q, (v0 - d0) % q) < 16):
        misses.append(f"eval_decomp({LP_DECOMP}) = {digs}")
    for m in sign_msgs:
        ct = binfhe.encrypt_zp(ctx, sk, m, P_MSG, rng)
        got, = run("eval_sign", binfhe.eval_sign,
                   lambda c: binfhe.decrypt_zp(ctx, sk, c, P_MSG), ct, P_MSG)
        if got != SIGN_LUT[m]:
            misses.append(f"eval_sign({m}) = {got}")
    return bk, outs, dec, misses


def lmk_flow(binfhe, ctx, seed, timed, gates=LMK_GATES, refresh=True,
             lut=True):
    """LMKCDEY: the keys, each gate over its truth table as one batch, a
    refresh of 0 and of 1 and one eval_func, every decryption exact.
    Returns (the secret, the key, every tensor, every (b, modulus) and
    decryption)."""
    rng = np.random.default_rng(seed)
    sk = binfhe.keygen(ctx, rng)
    bk = timed("bootstrap_keygen", lambda: binfhe.bootstrap_keygen(ctx, sk,
                                                                   rng))
    states = [bk.ek.cpu(), bk.ak.cpu(), bk.ks_a.cpu(), bk.ks_b.cpu()]
    outs = []

    def check(label, cts, got, want):
        states.extend(c.a.cpu() for c in cts)
        outs.extend((c.b, c.modulus, g) for c, g in zip(cts, got))
        need(list(got) == list(want), f"LMKCDEY {label}: decrypted {got}, "
             f"want {list(want)}")

    for gate in gates:
        c1 = [binfhe.encrypt(ctx, sk, x, rng) for x, _ in PAIRS]
        c2 = [binfhe.encrypt(ctx, sk, y, rng) for _, y in PAIRS]
        res = timed(gate, lambda: binfhe.eval_gate_batch(ctx, gate, bk, c1,
                                                         c2))
        check(gate, res, [binfhe.decrypt(ctx, sk, c) for c in res],
              [BOOL_GATES[gate](x, y) for x, y in PAIRS])
    for x in (0, 1) if refresh else ():
        ct = binfhe.encrypt(ctx, sk, x, rng)
        res = timed("bootstrap", lambda: binfhe.bootstrap(ctx, bk, ct))
        check(f"refresh of {x}", [res], [binfhe.decrypt(ctx, sk, res)], [x])
    if lut:
        ct = binfhe.encrypt_zp(ctx, sk, 3, P_MSG, rng)
        res = timed("eval_func", lambda: binfhe.eval_func(ctx, bk, ct,
                                                          list(LUT), P_MSG))
        check("eval_func", [res], [binfhe.decrypt_zp(ctx, sk, res, P_MSG)],
              [LUT[3]])
    return sk, bk, states, outs


def binfhe_lp_phase(device):
    """Phase 18: the large-precision functions at STD128 and LMKCDEY at
    STD128_LMKCDEY on the card, each op's host seconds and launches logged.
    Returns the launches."""
    from openfhe_tpu_torch.models import binfhe

    reset_counters()
    times, calls = {}, {}
    ctx = binfhe.gen_context(LP_SET, device)
    p = ctx.params
    _, _, dec, misses = lp_flow(binfhe, ctx, LP_SEED,
                                stage_clock(times, calls))
    log(f"  {LP_SET} ({p.method}, N={p.N}, n={p.n_lwe}), input modulus q_ks="
        f"{p.q_ks}, beta={LP_BETA}: decryptions {dec}")
    if LP_SET in LP_REFERENCE:
        need(dec == LP_REFERENCE[LP_SET], f"{LP_SET}: the large-precision "
             f"decryptions differ from the JAX package's "
             f"{LP_REFERENCE[LP_SET]}")
        log(f"  equal to the JAX package's for the same seed; beyond the "
            f"JAX test's bounds, in both packages: {misses}")
    else:
        need(not misses, f"{LP_SET}: beyond the JAX test's bounds: {misses}")
    log_stages(times, calls)
    times, calls = {}, {}
    ctx = binfhe.gen_context(LMK_SET, device)
    p = ctx.params
    _, bk, _, outs = lmk_flow(binfhe, ctx, 83, stage_clock(times, calls))
    log(f"  {LMK_SET}: N={p.N}, n={p.n_lwe}, {p.Q.bit_length()}-bit Q, "
        f"dg={p.dg}; keys ek {tuple(bk.ek.shape)}, ak {tuple(bk.ak.shape)}; "
        f"{', '.join(LMK_GATES)} over their truth tables, refreshes of 0 "
        f"and 1 and eval_func exact ({len(outs)} decryptions)")
    log_stages(times, calls)
    launches = read_counters()
    log(f"  launches in phase 18: {launches}")
    missing = [k for k in SMALL_NTT + ("ks_inner_product",)
               if launches[k] == 0]
    need(not missing, f"phase 18: kernels never launched: {missing}")
    return launches


def switch_fhew_params(binfhe):
    from openfhe_tpu_torch.utils import nbtheory
    return binfhe.BinFHEParams(n_lwe=8, N=256,
                               Q=nbtheory.first_prime(27, 2 * 256),
                               q_ks=1 << 14, log_bg=10, log_bks=5, sigma=3.19)


def switch_flow(ring_dim, device, seed, timed):
    """Scheme switching through its entry points: setup and keys,
    CKKS -> FHEW of 0..7, FHEW -> CKKS of 8 bits, a comparison of 8 pairs,
    the minimum and maximum of 2 values and the _alt forms over 4. Returns
    (every tensor, every LWE's (b, modulus), a dict of decrypted results
    and what each should be, and what the checks at this ring need)."""
    from openfhe_tpu_torch.models import binfhe, ckks
    from openfhe_tpu_torch.models import ckks_advanced as adv
    from openfhe_tpu_torch.models import scheme_switch as ss

    rng = np.random.default_rng(seed)
    bctx = binfhe.gen_context(switch_fhew_params(binfhe), device)
    sk_f = binfhe.keygen(bctx, rng)
    bk = timed("bootstrap_keygen", lambda: binfhe.bootstrap_keygen(bctx, sk_f,
                                                                   rng))
    ctx = ckks.gen_context(ckks.CKKSParams(ring_dim=ring_dim, **SWITCH_CKKS),
                           device)
    pk, sk = ckks.keygen(ctx, rng)
    pre = timed("setup", lambda: ss.setup(ctx, bctx, **SWITCH_SETUP))
    keys = timed("keygen", lambda: ss.keygen(ctx, bctx, pre, sk, sk_f, pk,
                                             rng))
    rot_keys = ckks.rot_keygen(ctx, sk, ss.extremum_rotation_indices(ctx, 4),
                               rng)
    ks = [keys.conj, keys.evk, *keys.rot_stc.values(), *keys.rot_f2c.values(),
          *rot_keys.values()]
    states = [t.cpu() for k in ks for t in (k.b, k.a)]
    states += [keys.lwe_ks_a.cpu(), keys.lwe_ks_b.cpu(), bk.ek.cpu()]
    lwe_outs = []
    res = {}

    def tile(v):
        return np.tile(np.array(v, dtype=float),
                       ctx.params.num_slots // len(v))

    def dec(ct, k):
        states.extend(p.data.cpu() for p in ct.polys)
        return ckks.decrypt(ctx, sk, ct, num_slots=k).real

    ct = ckks.encrypt(ctx, pk, tile(range(8)), rng)
    lwes = timed("eval_ckks_to_fhew", lambda: ss.eval_ckks_to_fhew(
        ctx, bctx, pre, keys, ct, 8, P_MSG))
    states.extend(c.a.cpu() for c in lwes)
    lwe_outs.extend((c.b, c.modulus) for c in lwes)
    q = lwes[0].modulus
    res["ckks_to_fhew"] = ([binfhe.decrypt_zp(bctx, sk_f, c, P_MSG)
                            for c in lwes], list(range(8)))
    # the phase error of each sample: the N -> n_lwe key switch adds one
    # Gaussian error for each of the N * d_ks key rows it sums
    res["ckks_to_fhew_error"] = [
        (binfhe.decrypt_phase(bctx, sk_f, c) - m * q // P_MSG + q // 2) % q
        - q // 2 for m, c in enumerate(lwes)]
    lwe_in = [binfhe.encrypt(bctx, sk_f, b, rng) for b in SWITCH_BITS]
    out = timed("eval_fhew_to_ckks", lambda: ss.eval_fhew_to_ckks(
        ctx, bctx, pre, keys, lwe_in))
    # what FHEW -> CKKS decodes is sin(2 pi t), t each input's phase / q
    res["fhew_to_ckks"] = (dec(out, 8), list(SWITCH_BITS), [
        np.sin(2 * np.pi * binfhe.decrypt_phase(bctx, sk_f, c) / q)
        for c in lwe_in])
    ct1 = ckks.encrypt(ctx, pk, tile(SWITCH_V1), rng)
    ct2 = ckks.encrypt(ctx, pk, tile(SWITCH_V2), rng)
    out = timed("eval_compare_scheme_switching",
                lambda: ss.eval_compare_scheme_switching(
                    ctx, bctx, pre, keys, bk, ct1, ct2, 8, P_MSG))
    # the signs FHEW sees (the same deterministic switch and LUTs, run
    # again outside): sin(2 pi phase/q) is what FHEW -> CKKS decodes
    diff = ss.eval_ckks_to_fhew(ctx, bctx, pre, keys,
                                ckks.eval_sub(ct1, ct2), 8, P_MSG)
    seen = [np.sin(2 * np.pi * binfhe.decrypt_phase(bctx, sk_f, c) / q)
            for c in ss._signs(bctx, bk, diff, P_MSG)]
    res["compare"] = (dec(out, 8), [1.0 if a < b else 0.0
                                    for a, b in zip(SWITCH_V1, SWITCH_V2)],
                      [(1 - s) / 2 for s in seen])
    evk = keys.evk
    ct = ckks.encrypt(ctx, pk, tile([3, 1] + [0] * 6), rng)
    mn, ind = timed("eval_min_scheme_switching",
                    lambda: ss.eval_min_scheme_switching(
                        ctx, bctx, pre, keys, bk, evk, rot_keys, ct, 2, P_MSG))
    mx, ind2 = timed("eval_max_scheme_switching",
                     lambda: ss.eval_max_scheme_switching(
                         ctx, bctx, pre, keys, bk, evk, rot_keys, ct, 2,
                         P_MSG))
    diff = ss.eval_ckks_to_fhew(ctx, bctx, pre, keys, adv.sub_auto(
        ctx, ct, ckks.eval_rotate(ct, 1, rot_keys[1])), 1, P_MSG)
    s = np.sin(2 * np.pi * binfhe.decrypt_phase(
        bctx, sk_f, ss._signs(bctx, bk, diff, P_MSG)[0]) / q)
    res["min"] = (np.concatenate([dec(mn, 1), dec(ind, 2)]), [1, 0, 1],
                  [3 * (1 - s) / 2 + (1 + s) / 2, (1 - s) / 2, (1 + s) / 2])
    res["max"] = (np.concatenate([dec(mx, 1), dec(ind2, 2)]), [3, 1, 0],
                  [3 * (1 + s) / 2 + (1 - s) / 2, (1 + s) / 2, (1 - s) / 2])
    ct = ckks.encrypt(ctx, pk, tile([3, 1, 2, 3] + [0] * 4), rng)
    mn, ind = timed("eval_min_scheme_switching_alt",
                    lambda: ss.eval_min_scheme_switching_alt(
                        ctx, bctx, pre, keys, bk, evk, rot_keys, ct, 4,
                        P_MSG))
    mx, _ = timed("eval_max_scheme_switching_alt",
                  lambda: ss.eval_max_scheme_switching_alt(
                      ctx, bctx, pre, keys, bk, evk, rot_keys, ct, 4, P_MSG))
    res["min_alt"] = (np.concatenate([dec(mn, 1), dec(ind, 4)]),
                      [1, 0, 1, 0, 0], None)
    res["max_alt"] = (dec(mx, 1), [3], None)
    return states, lwe_outs, res


def check_switch(res, label, exact_lwe):
    """Each flow against the plaintext truth within the JAX tests' bounds
    where the CKKS -> FHEW samples are exact (`exact_lwe`), and always
    within the same bounds against what its LWE inputs encrypt: FHEW -> CKKS
    against sin(2 pi t) of each input's phase, compare, min and max against
    the signs FHEW produced (the two-round _alt forms have no such model and
    are held only where the samples are exact)."""
    got, want = res["ckks_to_fhew"]
    err = np.asarray(res["ckks_to_fhew_error"])
    log(f"  {label}: CKKS -> FHEW decrypts {got} (want {want}); phase "
        f"errors {err.tolist()} (std {float(np.std(err)):.1f}; the messages "
        f"are {2 * 256 // P_MSG} apart)")
    if exact_lwe:
        need(got == want, f"{label}: CKKS -> FHEW decrypted {got}")
    for name, bound in (("fhew_to_ckks", F2C_BOUND),
                        ("compare", COMPARE_BOUND), ("min", MINMAX_BOUND),
                        ("max", MINMAX_BOUND), ("min_alt", ALT_BOUND),
                        ("max_alt", ALT_BOUND)):
        got, want, model = res[name]
        need(np.all(np.isfinite(got)), f"{label}: {name} not finite")
        e = float(np.max(np.abs(np.asarray(got) - want)))
        text = (f"  {label}: {name} {np.round(got, 4).tolist()}: against the "
                f"plaintext {e:.4f}")
        if model is not None:
            em = float(np.max(np.abs(np.asarray(got) - model)))
            text += f", against what its inputs encrypt {em:.4f}"
            need(em < bound, f"{label}: {name} error {em} against its inputs")
        log(f"{text} (bound {bound})")
        if exact_lwe and name != "fhew_to_ckks":
            need(e < bound, f"{label}: {name} error {e} above {bound}")


def switch_phase(device):
    """Phase 19: scheme switching with the CKKS side at n = 2^16. Returns
    the launches."""
    reset_counters()
    times, calls = {}, {}
    _, _, res = switch_flow(RING_DIM, device, 91, stage_clock(times, calls))
    launches = read_counters()
    log_stages(times, calls)
    check_switch(res, f"n={RING_DIM}", exact_lwe=False)
    log(f"  launches in phase 19: {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    need(not missing, f"phase 19: kernels never launched: {missing}")
    return launches


def lp_small_states(device):
    """Phase 20's runs on `device`: TOY_LP (floor, sign, decomp), TOY_LMKCDEY
    (keys, a gate batch, the key's archives in both flavours) and scheme
    switching at ring 512 with phase 19's FHEW set."""
    from openfhe_tpu_torch.models import binfhe
    from openfhe_tpu_torch.utils import serial

    bk, cts, dec, misses = lp_flow(
        binfhe, binfhe.gen_context("TOY_LP", device), 85, untimed,
        floors=LP_FLOORS[:1], signs=LP_SIGNS[2:3], sign_msgs=(5,))
    need(not misses, f"TOY_LP: beyond the JAX test's bounds: {misses}")
    states = [bk.ek.cpu(), bk.ks_a.cpu(), bk.ks_b.cpu()]
    states += [c.a.cpu() for c in cts]
    outs = [(c.b, c.modulus) for c in cts] + [dec]
    ctx = binfhe.gen_context("TOY_LMKCDEY", device)
    _, bk, more, lmk_outs = lmk_flow(binfhe, ctx, 87, untimed,
                                     gates=("AND",), refresh=False, lut=False)
    states += more
    outs += lmk_outs
    docs = []
    with tempfile.TemporaryDirectory() as d:
        for fmt in ("binary", "json"):
            path = f"{d}/lmk.{fmt}"
            serial.save(bk, path, fmt)
            if fmt == "json":
                with open(path, "rb") as f:
                    docs.append(f.read())
            back = serial.load(path, "cpu")
            states += [back.ek, back.ak, back.ks_a, back.ks_b]
    more, lwe_outs, res = switch_flow(SWITCH_SMALL_RING, device, 93, untimed)
    return states + more, outs + lwe_outs, docs, res


def lp_against_cpu(device):
    """Phase 20: phase 18's and 19's flows at small sizes on the card equal
    to the CPU run; at ring 512 every scheme-switching flow meets the JAX
    tests' bounds."""
    t0 = time.perf_counter()
    gpu, gpu_out, gpu_docs, gpu_res = lp_small_states(device)
    t1 = time.perf_counter()
    cpu, cpu_out, cpu_docs, cpu_res = lp_small_states(torch.device("cpu"))
    t2 = time.perf_counter()
    need(len(gpu) == len(cpu) and all(torch.equal(g.cpu(), c)
                                      for g, c in zip(gpu, cpu)),
         "phase 20: a key, ciphertext or archive differs from the CPU's")
    need(gpu_out == cpu_out and gpu_docs == cpu_docs,
         "phase 20: outputs or JSON archives differ from the CPU's")
    need(all(np.array_equal(np.asarray(gpu_res[k][0]),
                            np.asarray(cpu_res[k][0])) for k in gpu_res),
         "phase 20: decrypted scheme-switching results differ from the CPU's")
    check_switch(gpu_res, f"n={SWITCH_SMALL_RING}", exact_lwe=True)
    log(f"  {len(gpu)} keys, ciphertexts and loaded archives torch.equal to "
        f"the CPU run, {len(gpu_out)} outputs and {len(gpu_docs)} JSON "
        f"archives equal; card {t1 - t0:.1f} s, CPU {t2 - t1:.1f} s")


# Phase 21: MP12 trapdoors at n = 8192 (below the exact sampler's N_MAX =
# 16384) over one 50-bit tower, base 2 (k = 50), the exact sampler's SIGMA;
# then the same flow at n = 128 on the card and on the CPU
TRAPDOOR_N = 8192
TRAPDOOR_BITS = 50
TRAPDOOR_BASE = 2
TRAPDOOR_SMALL_N = 128
TRAPDOOR_SEED = 97
# Phase 22: the distributed four-step at the main path's shapes, and the
# main path routed through it
DNTT_MIN_N = 4096
DNTT_SEED = 7
DNTT_WARM = 4          # warm repetitions of the main path, unrouted and routed
# the kernels' names in csrc/ntt.cu and csrc/mac.cu, looked for in the trace
TRACE_KERNELS = ("col_pass", "row_pass", "ntt_small_kernel",
                 "ks_inner_product_kernel", "fused_mac_kernel")


def trapdoor_flow(td, n, device, seed, timed):
    """trapdoor_gen, a uniform u, gauss_samp and gauss_samp_exact at ring n
    over one TRAPDOOR_BITS-bit tower on `device`, from `seed`."""
    from openfhe_tpu_torch import dcrt
    from openfhe_tpu_torch.utils import nbtheory, sampling

    rng = np.random.default_rng(seed)
    q = nbtheory.first_prime(TRAPDOOR_BITS, 2 * n)
    base = TRAPDOOR_BASE
    A, T = timed("trapdoor_gen", lambda: td.trapdoor_gen(
        n, q, base, td.SIGMA, rng, device))
    basis = dcrt.RnsBasis(n, (q,))
    u = dcrt.from_int_rows(basis, sampling.uniform_rns_rows(n, (q,), rng),
                           dcrt.Format.EVAL, device)
    x = timed("gauss_samp", lambda: td.gauss_samp(n, q, base, A, T, u,
                                                  td.SIGMA, rng))
    x_exact = timed("gauss_samp_exact", lambda: td.gauss_samp_exact(
        n, q, base, A, T, u, rng))
    return dict(q=q, A=A, T=T, u=u, x=x, x_exact=x_exact)


def trapdoor_states(run):
    polys = run["A"] + run["T"].r + run["T"].e + run["x"] + run["x_exact"]
    return [p.data.cpu() for p in polys]


def trapdoor_phase(device):
    """Phase 21: trapdoors at n = TRAPDOOR_N on the card, A.x == u exactly
    for both samplers within the JAX tests' shortness bounds, the G-lattice
    samplers' congruence; then n = TRAPDOOR_SMALL_N on the card equal to the
    CPU. Returns the launches of the n = TRAPDOOR_N run."""
    from openfhe_tpu_torch.models import trapdoor as td

    n, base = TRAPDOOR_N, TRAPDOOR_BASE
    reset_counters()
    times = {}
    run = trapdoor_flow(td, n, device, TRAPDOOR_SEED, stage_timer(times))
    launches = read_counters()
    q, A, T = run["q"], run["A"], run["T"]
    k = len(T.r)
    log(f"  n = {n}, q = {q} ({q.bit_length()} bits), base {base}, k = {k}")
    log("  stage seconds: " + ", ".join(f"{k_} {v:.4f}"
                                        for k_, v in times.items()))
    log(f"  launches: {launches}")
    s = td.spectral_bound(n, k, base)
    for name, bound_ in (("x", q / 1000.0), ("x_exact", 6 * s)):
        x = run[name]
        need(len(x) == k + 2, f"phase 21: {name} has {len(x)} elements")
        need(torch.equal(td.apply_A(A, x).data, run["u"].data),
             f"phase 21: apply_A(A, {name}) != u")
        worst = max(float(np.abs(td._poly_to_reals(xi, q)).max())
                    for xi in x)
        log(f"  {name}: apply_A(A, x) == u; max |coefficient| {worst:.0f} "
            f"(bound {bound_:.0f})")
        need(worst < bound_, f"phase 21: {name} is not short")
    rng = np.random.default_rng(TRAPDOOR_SEED + 1)
    v = rng.integers(0, q, size=n, dtype=np.int64)
    z = td._g_preimage(v, q, base, k, td.SIGMA, rng)
    zq = td.gauss_samp_gq(v, (base + 1) * td.SIGMA, k, q, base, rng)
    need(td._g_congruent(z, v, q, base, k)
         and td._g_congruent(zq, v, q, base, k),
         "phase 21: a G-lattice sample misses its coset")
    log(f"  G-lattice congruence holds: _g_preimage max |z| "
        f"{int(np.abs(z).max())}, gauss_samp_gq {int(np.abs(zq).max())}")
    missing = [k_ for k_ in ("ntt_forward", "ntt_inverse", "fused_mac_mod")
               if launches[k_] == 0]
    need(not missing, f"phase 21: kernels never launched: {missing}")

    small = {}
    for where in (device, torch.device("cpu")):
        t0 = time.perf_counter()
        small[where.type] = trapdoor_states(trapdoor_flow(
            td, TRAPDOOR_SMALL_N, where, TRAPDOOR_SEED, untimed))
        log(f"  n = {TRAPDOOR_SMALL_N} on {where.type}: "
            f"{time.perf_counter() - t0:.2f} s")
    same_tensors(f"phase 21: n = {TRAPDOOR_SMALL_N} on the card against "
                 "the CPU", small[device.type], small["cpu"])
    log(f"  n = {TRAPDOOR_SMALL_N}: every A, T and x on the card equals "
        "the CPU's")
    return launches


def event_ms(fn, reps=5):
    """Mean device time of fn() between CUDA events over `reps` calls
    after a warm-up (no graph: the four-step's collectives run in it)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def distributed_phase(ctx, device, trace_dir):
    """Phase 22: on a one-rank process group (NCCL on the card; NCCL puts
    no two ranks on one GPU), the four-step NTT against the NTT at the main
    path's shapes, the main path (MultRelin -> rescale -> Rotate) routed
    through it against the unrouted run, the explicit collectives, and one
    MultRelin under profiling.timed and profiling.trace. Returns the routed
    path's launches."""
    import torch.distributed as dist
    from openfhe_tpu_torch import dcrt
    from openfhe_tpu_torch.models import ckks
    from openfhe_tpu_torch.ops import ntt
    from openfhe_tpu_torch.parallel import collectives, dntt
    from openfhe_tpu_torch.parallel import mesh as mesh_mod
    from openfhe_tpu_torch.utils import profiling

    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, rank=0, world_size=1,
                            init_method=f"file://{trace_dir}/pg")
    try:
        mesh = mesh_mod.make_mesh()
        log(f"  {backend} group of 1 rank, mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        n = ctx.n
        n1, n2 = dntt.split_factors(n)
        qp = ctx.q_moduli + ctx.p_moduli
        rng = np.random.default_rng(DNTT_SEED)
        for lead in ((3,), ()):
            x = uniform(qp, lead + (n,), rng, device)
            label = f"{list(lead + (len(qp), n))}"
            y = dntt.four_step_forward(x, n1, n2, qp, mesh=mesh)
            need(torch.equal(y, ntt.forward(x, qp)),
                 f"phase 22: four_step_forward {label} != ntt.forward")
            need(torch.equal(dntt.four_step_inverse(y, n1, n2, qp, mesh=mesh),
                             ntt.inverse(y, qp)),
                 f"phase 22: four_step_inverse {label} != ntt.inverse")
            fwd = event_ms(lambda: dntt.four_step_forward(x, n1, n2, qp,
                                                          mesh=mesh))
            inv = event_ms(lambda: dntt.four_step_inverse(y, n1, n2, qp,
                                                          mesh=mesh))
            one = event_ms(lambda: ntt.forward(x, qp))
            log(f"  four-step {label} torch.equal to ntt.forward/inverse; "
                f"device ms forward {fwd:.4f}, inverse {inv:.4f}, "
                f"one-launch NTT {one:.4f}")
        x = uniform(qp, (n,), rng, device)
        need(torch.equal(collectives.four_step_forward_shard_map(x, qp, mesh),
                         ntt.forward(x, qp)),
             "phase 22: four_step_forward_shard_map != ntt.forward")
        parts = uniform((1 << 40,) * len(qp), (n,), rng, device)
        need(torch.equal(collectives.tower_psum(parts, mesh),
                         parts.sum(dim=0)),
             "phase 22: tower_psum != the local sum")
        log("  four_step_forward_shard_map and tower_psum equal their "
            "local results")

        rng = np.random.default_rng(DNTT_SEED)
        pk, sk = ckks.keygen(ctx, rng)
        evk = ckks.relin_keygen(ctx, sk, rng)
        rk = ckks.rot_keygen(ctx, sk, [1], rng)[1]
        v1, v2 = rng.uniform(-1, 1, (2, n // 2))
        ct1 = ckks.encrypt(ctx, pk, v1, rng)
        ct2 = ckks.encrypt(ctx, pk, v2, rng)

        def step(timed):
            prod = timed("eval_mult_relin",
                         lambda: ckks.eval_mult_relin(ct1, ct2, evk))
            res = timed("rescale", lambda: ckks.rescale_ctx(ctx, prod))
            rot = timed("eval_rotate", lambda: ckks.eval_rotate(res, 1, rk))
            return poly_states(prod, res, rot), rot

        plain_times, plain_calls = {}, {}
        want, _ = step(stage_clock(plain_times, plain_calls))
        for _ in range(DNTT_WARM):
            step(stage_clock(plain_times, plain_calls))
        dcrt.set_distributed_ntt(mesh, min_n=DNTT_MIN_N)
        try:
            before = (dntt.four_step_forward.distributed_calls,
                      dntt.four_step_inverse.distributed_calls)
            reset_counters()
            times, calls = {}, {}
            got, rot = step(stage_clock(times, calls))
            launches = read_counters()
            routed = (dntt.four_step_forward.distributed_calls - before[0],
                      dntt.four_step_inverse.distributed_calls - before[1])
            for _ in range(DNTT_WARM):
                step(stage_clock(times, calls))
            ks = (dntt.four_step_forward.distributed_calls,
                  dntt.four_step_inverse.distributed_calls)
            ckks.eval_mult_relin(ct1, ct2, evk)
            ks = (dntt.four_step_forward.distributed_calls - ks[0],
                  dntt.four_step_inverse.distributed_calls - ks[1])
        finally:
            dcrt.set_distributed_ntt(None)
        same_tensors("phase 22: the routed main path against the unrouted",
                     got, want)
        out = ckks.decrypt(ctx, sk, rot, num_slots=n // 2)
        err = float(np.max(np.abs(out.real - np.roll(v1 * v2, -1))))
        log(f"  routed MultRelin -> rescale -> Rotate torch.equal to the "
            f"unrouted run; max |err| {err:.3e} (bound {BOUND})")
        need(err < BOUND, f"phase 22: error {err} above bound {BOUND}")
        log("  unrouted:")
        log_stages(plain_times, plain_calls)
        log("  routed:")
        log_stages(times, calls)
        log(f"  four-step calls on the routed path (forward, inverse): "
            f"{routed}; in one MultRelin's key switch: {ks}")
        log(f"  launches on the routed path: {launches}")
        need(ks == (2, 2), "phase 22: the key switch's four NTTs did not "
             "take the distributed four-step")
        missing = [k for k in SMALL_NTT + MACS if launches[k] == 0]
        need(not missing, f"phase 22: kernels never launched: {missing}")

        with profiling.timed("eval_mult_relin") as r:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            prod = ckks.eval_mult_relin(ct1, ct2, evk)
            end.record()
            r.block_on(prod)
        torch.cuda.synchronize()
        ev_ms = start.elapsed_time(end)
        log(f"  profiling.timed MultRelin {r.seconds * 1e3:.4f} ms, CUDA "
            f"events {ev_ms:.4f} ms")
        need(r.seconds * 1e3 >= ev_ms,
             "phase 22: timed() returned before the card finished")
        with profiling.trace(trace_dir):
            ckks.eval_mult_relin(ct1, ct2, evk)
            torch.cuda.synchronize()
        path = os.path.join(trace_dir, profiling.TRACE_FILE)
        with open(path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        seen = sorted(k for k in TRACE_KERNELS
                      if any(k in name for name in names))
        log(f"  trace {os.path.getsize(path)} bytes, {len(names)} names; "
            f"kernels named: {seen}")
        need({"row_pass", "col_pass"} & set(seen)
             and {"ks_inner_product_kernel", "fused_mac_kernel"} & set(seen),
             "phase 22: the trace names no NTT or no MAC kernel")
        return launches
    finally:
        dist.destroy_process_group()



# the 38 example programs (examples/*.py), in the order of their schemes:
# CKKS, bootstrapping, BGV, BFV, protocols, BINFHE, scheme switching
EXAMPLES = (
    "simple_real_numbers", "rotation", "polynomial_evaluation",
    "function_evaluation", "linearwsum_evaluation", "inner_product",
    "advanced_real_numbers", "advanced_real_numbers_128",
    "ckks_noise_flooding", "simple_real_numbers_serial",
    "simple_ckks_bootstrapping", "advanced_ckks_bootstrapping",
    "iterative_ckks_bootstrapping",
    "simple_integers_bgvrns", "depth_bgvrns", "simple_integers_serial_bgvrns",
    "simple_integers", "depth_bfvrns", "depth_bfvrns_behz",
    "simple_integers_serial", "string_encoding",
    "threshold_fhe", "threshold_fhe_5p", "tckks_interactive_mp_bootstrapping",
    "tckks_interactive_mp_bootstrapping_chebyshev", "pre_buffer",
    "boolean", "boolean_methods", "boolean_multi_input",
    "boolean_truth_tables", "boolean_serial_binary", "boolean_serial_json",
    "eval_sign", "eval_flooring", "eval_decomp",
    "boolean_serial_binary_dynamic_large_precision",
    "boolean_serial_json_dynamic_large_precision",
    "scheme_switching")
TRANSCRIPTS = os.path.join(ROOT, "tests", "data", "example_transcripts")


def examples_phase(device):
    """Phase 23: every example program on the card through
    ``examples._common.run``, its masked transcript equal to the JAX
    program's (tests/data/example_transcripts). Logs each program's host
    seconds and launches; returns the launches of the whole phase and each
    program's (seconds, launches)."""
    import difflib

    from openfhe_tpu_torch.examples._common import mask_tmp, run

    total = dict.fromkeys(SOURCES, 0)
    per_program = {}
    t_phase = time.perf_counter()
    for name in EXAMPLES:
        with open(os.path.join(TRANSCRIPTS, name + ".txt")) as f:
            want = f.read()
        reset_counters()
        t0 = time.perf_counter()
        got = mask_tmp(run(name, device))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = read_counters()
        for k, v in launches.items():
            total[k] += v
        per_program[name] = (sec, launches)
        log(f"  {name}: {sec:.3f} s, launches ({' / '.join(launches)}) "
            f"{' / '.join(str(v) for v in launches.values())}")
        if got != want:
            log("".join(difflib.unified_diff(
                want.splitlines(True), got.splitlines(True), "JAX", "card")))
        need(got == want, f"phase 23: {name} printed other than the JAX "
             "program")
    log(f"  {len(EXAMPLES)} transcripts equal to the JAX programs' in "
        f"{time.perf_counter() - t_phase:.1f} s; launches {total}")
    missing = [k for k in SMALL_NTT + MACS if total[k] == 0]
    need(not missing, f"phase 23: kernels never launched: {missing}")
    return total, per_program


def entry_phase(device, tmp_dir):
    """Phase 24: entry()'s step on the card, equal in its inputs and output
    to the same step on the CPU; dryrun_multichip(1) on one NCCL rank (a
    process of its own), and that rank's work once more in this process so
    that its launches count. Returns the launches of both."""
    from openfhe_tpu_torch import entry

    reset_counters()
    t0 = time.perf_counter()
    fn, args = entry.entry()
    t1 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    fn_cpu, args_cpu = entry.entry("cpu")
    want = fn_cpu(*args_cpu)
    ct1, ct2, evk = args
    c1, c2, k = args_cpu
    same_tensors("phase 24: entry()'s inputs on the card against the CPU",
                 poly_states(ct1, ct2) + key_states(evk),
                 poly_states(c1, c2) + key_states(k))
    same_tensors("phase 24: entry()'s step on the card against the CPU",
                 poly_states(out), poly_states(want))
    need(out.scale == want.scale, "phase 24: the step's scale differs")
    log(f"  entry(): inputs {t1 - t0:.3f} s, step {t2 - t1:.4f} s, "
        f"{out.towers} towers; torch.equal to the CPU run")
    t0 = time.perf_counter()
    entry.dryrun_multichip(1)
    log(f"  dryrun_multichip(1) on NCCL: {time.perf_counter() - t0:.1f} s")
    line = entry.dryrun_rank(0, 1, os.path.join(tmp_dir, "dryrun"), "nccl")
    log(f"  the same rank in this process: {line}")
    launches = read_counters()
    log(f"  launches in phase 24: {launches}")
    missing = [k for k in FOUR_STEP + SMALL_NTT + ("ks_inner_product",)
               if launches[k] == 0]
    need(not missing, f"phase 24: kernels never launched: {missing}")
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's kernels need one")
    from openfhe_tpu_torch import _build, keyswitch
    from openfhe_tpu_torch.models import bfv, bgv, ckks
    from openfhe_tpu_torch.models import ckks_bootstrap as boot

    device = torch.device("cuda", 0)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(gpu_line())  # card name and power limit, as nvidia-smi prints them

    log("[1] build")
    t0 = time.perf_counter()
    _build.library()
    log(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds} s) -> {_build.library_path().name}")

    params60 = ckks.CKKSParams(ring_dim=RING_DIM, mult_depth=TOWERS - 1,
                               scaling_mod_size=59, first_mod_size=60,
                               dnum=3)
    params30 = ckks.CKKSParams(ring_dim=RING_DIM, mult_depth=TOWERS - 1,
                               scaling_mod_size=59, first_mod_size=60,
                               dnum=3, composite_degree=2)
    ctx60 = ckks.gen_context(params60, device)
    ctx30 = ckks.gen_context(params30, device)
    ctx_boot = ckks.gen_context(ckks.CKKSParams(**BOOT_PARAMS), device)
    ctx_bgv = bgv.gen_context(bgv.BGVParams(**BGV_PARAMS), device)
    ctx_bfv = bfv.gen_context(bfv.BFVParams(**BFV_PARAMS), device)
    ctx_sw = ckks.gen_context(ckks.CKKSParams(ring_dim=RING_DIM,
                                              **SWITCH_CKKS), device)

    log("[2] kernels against their twins")
    checks = check_kernels(ctx60, ctx30, ctx_boot, ctx_bgv, ctx_bfv, ctx_sw,
                           device)
    example_checks = check_example_shapes(device)

    log("[3] main path, 60-bit chain")
    launches = main_path(ckks, ctx60, "60-bit chain", seed=7)
    log("[4] main path, composite chain")
    main_path(ckks, ctx30, "composite chain", seed=11)
    log("[5] the slice on the card against the CPU twins")
    check_against_cpu(ckks)
    log("[6] bootstrap at n = 2^16 (e2e_scale.py phase B)")
    boot_launches, boot_warm_s = bootstrap_at_scale(ckks, boot, ctx_boot)
    log("[7] the n = 512 bootstrap on the card against the CPU")
    bootstrap_against_cpu(ckks, boot)

    def run_bgv(ctx, timed):
        return bgv_run(bgv, ctx, 21, timed)

    def run_bfv(ctx, timed):
        levels = BFV_LEVELS if ctx.n == FHE_RING_DIM else 2
        return bfv_run(bfv, keyswitch, ctx, 23, levels, timed)

    log("[8] BGV at n = 2^15, 128-bit classic")
    bgv_launches = fhe_at_scale("BGV", run_bgv, ctx_bgv)
    log("[9] BFV at n = 2^15, 128-bit classic")
    bfv_launches = fhe_at_scale("BFV", run_bfv, ctx_bfv)
    log("[10] BGV and BFV at n = 2^12 on the card against the CPU")
    fhe_against_cpu("BGV", run_bgv, lambda d: bgv.gen_context(
        bgv.BGVParams(**SMALL_BGV_PARAMS), d))
    fhe_against_cpu("BFV", run_bfv, lambda d: bfv.gen_context(
        bfv.BFVParams(**SMALL_BFV_PARAMS), d))

    threshold_launches, pre_launches = threshold_and_pre(
        ctx60, ctx_bgv, ctx_bfv, device, boot_warm_s)

    log("[17] BINFHE: STD128 gates, STD128Q_3, STD128_AP; TOY on the card "
        "against the CPU")
    binfhe_launches, _ = binfhe_phase(device)
    log("[18] BINFHE large precision at STD128, LMKCDEY at STD128_LMKCDEY")
    lp_launches = binfhe_lp_phase(device)
    log(f"[19] scheme switching, CKKS at n = 2^{RING_DIM.bit_length() - 1}")
    switch_launches = switch_phase(device)
    log("[20] TOY_LP, TOY_LMKCDEY and scheme switching at n = "
        f"{SWITCH_SMALL_RING} on the card against the CPU")
    lp_against_cpu(device)
    log(f"[21] trapdoors at n = {TRAPDOOR_N}; n = {TRAPDOOR_SMALL_N} on the "
        "card against the CPU")
    trapdoor_launches = trapdoor_phase(device)
    log("[22] the distributed four-step NTT on a one-rank NCCL group, the "
        "main path routed through it, profiling")
    with tempfile.TemporaryDirectory() as trace_dir:
        dntt_launches = distributed_phase(ctx60, device, trace_dir)
    with CallLog() as calls:
        log("[23] the example programs on the card, each transcript against "
            "the JAX program's")
        examples_launches, _ = examples_phase(device)
        log("[24] the entry points: entry() against the CPU, "
            "dryrun_multichip(1) on NCCL")
        with tempfile.TemporaryDirectory() as tmp_dir:
            entry_launches = entry_phase(device, tmp_dir)
    checked = {call_key(c) for c in example_calls()}
    unchecked = sorted(calls.calls - checked)
    need(not unchecked, f"phases 23-24 made kernel calls phase 2 did not "
         f"check: {unchecked[:5]}")
    log(f"  phases 23-24 made {len(calls.calls)} distinct kernel calls, "
        f"each checked in phase 2")

    kernels = [{"name": name, "route": "cuda",
                "source": f"openfhe_tpu_torch/{src}", "replaces": rep,
                "launches": launches[name],
                "bootstrap_launches": boot_launches[name],
                "bgv_launches": bgv_launches[name],
                "bfv_launches": bfv_launches[name],
                "threshold_launches": threshold_launches[name],
                "pre_launches": pre_launches[name],
                "binfhe_launches": binfhe_launches[name],
                "binfhe_lp_launches": lp_launches[name],
                "scheme_switch_launches": switch_launches[name],
                "trapdoor_launches": trapdoor_launches[name],
                "dntt_launches": dntt_launches[name],
                "examples_launches": examples_launches[name],
                "entry_launches": entry_launches[name],
                **checks[name],
                "example_shapes": summarize_shapes(example_checks[name])}
               for name, (src, rep) in SOURCES.items()]
    log("[end]")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
