"""Where the time of the CKKS main path's evaluated ops and of the
bootstrap goes, on one GPU.

    python3 -m openfhe_tpu_torch.profile_ops [ops] [passes] [butterfly]
                                             [bootstrap] [bgv] [bfv]
                                             [threshold] [binfhe]
                                             [--method GINX|LMKCDEY]

(no argument: all eight sections; ``--method`` picks the blind rotation the
binfhe section profiles, GINX by default).

For EvalMult+relinearize, rescale and EvalRotate at n = 2^16 on the 60-bit
chain (8 towers + 3 special primes) and on the composite chain (16 towers of
~30 bits), warm (every table built): the host-clock latency of 30 runs, each
ending in a synchronise (median and quartiles), then a ``torch.profiler``
trace of 10 more runs for the device time a run keeps the card busy, the
kernels it launches, and the share of the hand-written kernels by name.
Then the two passes of the NTT kernel on their own, on a cold L2 (a buffer
several times its size is rewritten before every call): device time of the
column and the row kernel in each direction, and the share of the card's
memory rate each reaches on the bytes it has to move (its tile read and
written once, the twist and its precon read by the pass that applies them).
Last, ``bench/butterfly.cu`` is built and run: the clocks an SM
partition takes to run one warp-wide lazy butterfly with everything in
registers, the integer pipe's real floor for the NTT.
Then the bootstrap at n = 2^16 on the chain of e2e_scale.py's phase B
(21 towers, 7 special primes, slots 4, Chebyshev degree 28, 5 double
angles), warm: the host-clock time of 3 runs, a ``torch.profiler`` trace of
one more (device busy, kernels, NTT and MAC time), and the host time that
plaintext encoding takes inside one run (``encoding.ckks_encode`` and
``sampling.signed_to_rns_rows``, and the whole ``ckks.encode`` with its
copy to the card and its NTT), beside what the exact Python-int path of
the JAX package's encoder would take for the same plaintexts.
Then BGV and BFV at n = 2^15 (chip_smoke.py phases 8 and 9), warm, as the
CKKS ops above: BGV's EvalMult+relinearize, mod_reduce, EvalRotate and
decrypt; BFV's HPS EvalMult with and without relinearization, its
scale-back (the plain-torch scale_and_round and exact_switch_basis over the
three products, together and each alone), relinearize, EvalRotate and
decrypt.
Then threshold CKKS at n = 2^16 (chip_smoke.py phase 11, 3 parties), warm,
as the ops above: one party's shares of the joint relinearization and
rotation keys, the partial decryptions and their fusion, one party's
interactive-bootstrap share and the lead's final step; and BGV's
re-encryption in each PRE mode at n = 2^15.
Then BINFHE at STD128 (GINX, N = 1024, n = 503; chip_smoke.py phase 17):
the bootstrap key's generation, then one batched AND gate (B = 4) and one
refresh (B = 1), warm: host latency of 30 runs, a ``torch.profiler`` trace of
2 more for the device-busy share and the kernels a gate launches, the
device time of the NTT forward and inverse kernels and of
``ks_inner_product`` by name, their launch counts from the wrappers, and
the plain-torch kernels that take the most device time; then one external
product (B = 4) taken apart into its pieces, each with its kernels, device
time and host time a call (the digit inner product with the monomial
product in its epilogue as one piece, beside the three pieces it replaced,
timed off the path); and eval_sign_large at STD128 (input modulus
q_ks = 2^14, beta = 64: one eval_floor and a sign bootstrap, three blind
rotations), as the gates. With ``--method LMKCDEY``, BINFHE at
STD128_LMKCDEY instead (N = 1024, n = 446): key generation, one AND gate
(one ciphertext, whose schedule is 446 external products and 1023
automorphisms) as above, then one external step and one automorphism step
taken apart, each with its kernels, device and host time a call, and the
split of a gate's host time between the two step kinds.
Prints one line per op, per pass, per butterfly and per bootstrap figure
and a last line of JSON with every number. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from . import _build, encoding
from .models import bfv, bgv, ckks
from .models import ckks_bootstrap as boot
from .ops import ntt, rns
from .utils import sampling
from .utils.profiling import graph_ms

RING_DIM = 1 << 16
TOWERS = 8
TIMED_RUNS = 30
PROFILED_RUNS = 10
HBM_BYTES_PER_S = 3.35e12   # published peak of one H100 SXM
FLUSH_BYTES = 192 << 20     # several times the 50 MB L2
# device kernels of csrc/ by the name the profiler shows; the NTT kernels
# carry their direction as the last template argument
OURS = {"ntt_forward": r"(col|row)_pass\w*<[^>]*true>",
        "ntt_inverse": r"(col|row)_pass\w*<[^>]*false>",
        "ntt_small_forward": r"ntt_small_kernel<[^>]*true>",
        "ntt_small_inverse": r"ntt_small_kernel<[^>]*false>",
        "ks_inner_product": r"ks_inner_product_kernel",
        "fused_mac": r"fused_mac_kernel"}


def _host_times(fn) -> list:
    out = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def _profile(fn, runs: int = PROFILED_RUNS, top: int = 0) -> dict:
    """Device time a run keeps the card busy, its kernels, and the time of
    each of OURS by kernel name, from one ``torch.profiler`` trace of
    `runs` runs; with `top`, also the `top` other (plain torch) kernels by
    device time, with their launches a run."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    busy_us, launches = 0.0, 0
    ours = dict.fromkeys(OURS, 0.0)
    plain = []
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0))
        if not dev or ev.device_type.name != "CUDA":
            continue
        busy_us += dev
        launches += ev.count
        group = next((k for k, pat in OURS.items()
                      if re.search(pat, ev.key)), None)
        if group:
            ours[group] += dev
        else:
            plain.append({"kernel": ev.key, "launches": ev.count / runs,
                          "us": dev / runs})
    if busy_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    row = {"device_busy_us": busy_us / runs,
           "kernels_per_op": launches / runs,
           **{f"{k}_us": v / runs for k, v in ours.items()}}
    if top:
        row["plain_top"] = sorted(plain, key=lambda k: -k["us"])[:top]
    return row


def _ours_text(row: dict) -> str:
    ntt_us = sum(row[f"{k}_us"] for k in OURS if k.startswith("ntt"))
    return (f"NTT {ntt_us:.1f} us, "
            f"MAC {row['ks_inner_product_us'] + row['fused_mac_us']:.1f} us")


def profile_chain(label: str, composite_degree: int, seed: int) -> list:
    params = ckks.CKKSParams(ring_dim=RING_DIM, mult_depth=TOWERS - 1,
                             scaling_mod_size=59, first_mod_size=60, dnum=3,
                             composite_degree=composite_degree)
    ctx = ckks.gen_context(params)
    rng = np.random.default_rng(seed)
    pk, sk = ckks.keygen(ctx, rng)
    evk = ckks.relin_keygen(ctx, sk, rng)
    rk = ckks.rot_keygen(ctx, sk, [1], rng)[1]
    n = ctx.n
    ct1 = ckks.encrypt(ctx, pk, rng.uniform(-1, 1, n // 2), rng)
    ct2 = ckks.encrypt(ctx, pk, rng.uniform(-1, 1, n // 2), rng)
    prod = ckks.eval_mult_relin(ct1, ct2, evk)
    res = ckks.rescale_ctx(ctx, prod)
    ops = {"MultRelin": lambda: ckks.eval_mult_relin(ct1, ct2, evk),
           "rescale": lambda: ckks.rescale_ctx(ctx, prod),
           "Rotate": lambda: ckks.eval_rotate(res, 1, rk)}
    return profile_op_set(label, ops)


def profile_op_set(label: str, ops: dict) -> list:
    """Host-clock latency of each warm op (median and quartiles of
    TIMED_RUNS) and its profiled device time, kernels and kernel shares."""
    rows = []
    for name, fn in ops.items():
        fn()                                   # tables built, caches filled
        ms = _host_times(fn)
        q1, med, q3 = np.percentile(ms, [25, 50, 75])
        row = {"chain": label, "op": name, "host_ms_median": float(med),
               "host_ms_q1": float(q1), "host_ms_q3": float(q3),
               **_profile(fn)}
        row["device_busy_share"] = row["device_busy_us"] / (1e3 * med)
        print(f"{label} {name}: host {med:.3f} ms ({q1:.3f}-{q3:.3f}), "
              f"device busy {row['device_busy_us']:.1f} us "
              f"({100 * row['device_busy_share']:.1f}%), "
              f"{row['kernels_per_op']:.0f} kernels, {_ours_text(row)}",
              flush=True)
        rows.append(row)
    return rows


FHE_RING_DIM = 1 << 15


def profile_bgv() -> list:
    """BGV at chip_smoke.py phase 8's parameters (n = 2^15, 10 towers + 4
    special primes, t = 65537): EvalMult+relinearize, mod_reduce and
    EvalRotate at the full level, and decrypt (host CRT and slot NTT)."""
    ctx = bgv.gen_context(bgv.BGVParams(
        ring_dim=FHE_RING_DIM, mult_depth=9, plaintext_modulus=65537,
        mod_size=60, dnum=3, security_level="HEStd_128_classic"))
    rng = np.random.default_rng(21)
    pk, sk = bgv.keygen(ctx, rng)
    evk = bgv.relin_keygen(ctx, sk, rng)
    k = bgv.rotation_galois(ctx.n, 1)
    rk = bgv.rot_keygen(ctx, sk, [k], rng)[k]
    v = rng.integers(0, ctx.t, size=ctx.n).tolist()
    ct1, ct2 = (bgv.encrypt(ctx, pk, v, rng) for _ in range(2))
    prod = bgv.eval_mult_relin(ct1, ct2, evk)
    return profile_op_set("BGV", {
        "MultRelin": lambda: bgv.eval_mult_relin(ct1, ct2, evk),
        "mod_reduce": lambda: bgv.mod_reduce(ctx, prod),
        "Rotate": lambda: bgv.eval_rotate(ct1, 1, rk),
        "decrypt": lambda: bgv.decrypt(ctx, sk, prod)})


def profile_bfv() -> list:
    """BFV at chip_smoke.py phase 9's parameters (n = 2^15, Q 10 towers,
    R 11, P 4): the HPS EvalMult and its relinearization, the plain-torch
    scale-back of its three products alone (scale_and_round S -> R, then
    the centered exact switch R -> Q, each also on its own), EvalRotate and
    decrypt."""
    ctx = bfv.gen_context(bfv.BFVParams(
        ring_dim=FHE_RING_DIM, plaintext_modulus=65537, num_towers=10,
        mod_size=60, dnum=3, security_level="HEStd_128_classic"))
    rng = np.random.default_rng(23)
    pk, sk = bfv.keygen(ctx, rng)
    evk = bfv.relin_keygen(ctx, sk, rng)
    k = bfv.rotation_galois(ctx.n, 1)
    rk = bfv.rot_keygen(ctx, sk, [k], rng)[k]
    v = rng.integers(0, ctx.t, size=ctx.n).tolist()
    ct1, ct2 = (bfv.encrypt(ctx, pk, v, rng) for _ in range(2))
    prod = bfv.eval_mult(ctx, ct1, ct2)
    qm, rm = ctx.q_moduli, ctx.r_moduli
    sm = qm + rm
    cols = [rng.integers(0, q, size=(3, ctx.n), dtype=np.uint64) for q in sm]
    y = torch.from_numpy(np.stack(cols, axis=-2).astype(np.int64)).cuda()
    y_r = rns.scale_and_round(y, sm, rm, ctx.t, qm)
    return profile_op_set("BFV", {
        "Mult (HPS)": lambda: bfv.eval_mult(ctx, ct1, ct2),
        "MultRelin (HPS)": lambda: bfv.eval_mult_relin(ctx, ct1, ct2, evk),
        "scale-back [3, 21] -> [3, 10]": lambda: rns.exact_switch_basis(
            rns.scale_and_round(y, sm, rm, ctx.t, qm), rm, qm,
            centered=True),
        "scale_and_round [3, 21] -> [3, 11]": lambda: rns.scale_and_round(
            y, sm, rm, ctx.t, qm),
        "exact_switch_basis [3, 11] -> [3, 10]":
            lambda: rns.exact_switch_basis(y_r, rm, qm, centered=True),
        "relinearize": lambda: bfv.relinearize(prod, evk),
        "Rotate": lambda: bfv.eval_rotate(ct1, 1, rk),
        "decrypt": lambda: bfv.decrypt(ctx, sk, ct1)})


def profile_threshold() -> list:
    """Threshold CKKS at n = 2^16 on the 60-bit chain (chip_smoke.py phase
    11, 3 parties): one non-lead party's round-1 and round-2 shares of the
    joint relinearization key and its rotation-key share, the lead's and a
    main party's partial decryption and their fusion, one party's
    interactive-bootstrap share and the lead's final step (from 2 towers);
    then BGV's re_encrypt in each mode at n = 2^15 (phase 14)."""
    from .models import multiparty as mp
    from .models import pre
    params = ckks.CKKSParams(ring_dim=RING_DIM, mult_depth=TOWERS - 1,
                             scaling_mod_size=59, first_mod_size=60, dnum=3)
    ctx = ckks.gen_context(params)
    rng = np.random.default_rng(13)
    pk, sk1 = mp.keygen_lead(ctx, rng)
    pk, sk2 = mp.keygen_join(ctx, pk, rng)
    pk, sk3 = mp.keygen_join(ctx, pk, rng)
    sks = [sk1, sk2, sk3]
    r1 = [mp.evalmult_round1(ctx, sk1, rng)]
    r1 += [mp.evalmult_round1(ctx, s, rng, prev_key=r1[0]) for s in sks[1:]]
    ab = mp.evalmult_accumulate_round1(r1)
    rot1 = mp.rot_keygen_share(ctx, sk1, 1, rng)
    n = ctx.n
    ct = ckks.encrypt(ctx, pk, rng.uniform(-1, 1, n // 2), rng)
    parts = [mp.decrypt_lead(ctx, sk1, ct, rng)] + [
        mp.decrypt_main(ctx, s, ct, rng) for s in sks[1:]]
    small = ckks.level_reduce(ct, ct.towers - 2)
    a = mp.int_mp_boot_random_element_gen(ctx, rng)
    agg = mp.int_mp_boot_add([mp.int_mp_boot_decrypt(ctx, s, small, a, rng)
                              for s in sks])
    rows = profile_op_set("threshold CKKS", {
        "evalmult_round1 (party 2)": lambda: mp.evalmult_round1(
            ctx, sk2, rng, prev_key=r1[0]),
        "evalmult_round2": lambda: mp.evalmult_round2(ctx, sk2, ab, rng),
        "rot_keygen_share (party 2)": lambda: mp.rot_keygen_share(
            ctx, sk2, 1, rng, prev_key=rot1),
        "decrypt_lead": lambda: mp.decrypt_lead(ctx, sk1, ct, rng),
        "decrypt_main": lambda: mp.decrypt_main(ctx, sk2, ct, rng),
        "combine (3 partials)": lambda: mp.combine(ctx, ct, parts),
        "int_mp_boot_decrypt": lambda: mp.int_mp_boot_decrypt(
            ctx, sk2, small, a, rng),
        "int_mp_boot_encrypt": lambda: mp.int_mp_boot_encrypt(
            ctx, agg, a, small)})
    bctx = bgv.gen_context(bgv.BGVParams(
        ring_dim=FHE_RING_DIM, mult_depth=9, plaintext_modulus=65537,
        mod_size=60, dnum=3, security_level="HEStd_128_classic"))
    pk_a, sk_a = bgv.keygen(bctx, rng)
    _, sk_b = bgv.keygen(bctx, rng)
    rk = pre.rekey_gen(bctx, sk_a, sk_b, rng, error_scale=bctx.t)
    bct = bgv.encrypt(bctx, pk_a, rng.integers(0, bctx.t, bctx.n).tolist(),
                      rng)
    return rows + profile_op_set("BGV PRE", {
        f"re_encrypt {mode}": (lambda mode=mode: pre.re_encrypt(
            bct, rk, ctx=bctx, pk=pk_a, mode=mode, rng=rng,
            noise_scale=bctx.t))
        for mode in ("INDCPA", "FIXED_NOISE_HRA", "NOISE_FLOODING_HRA")})


STEP_RUNS = 1000      # calls of one piece of an external product


def _binfhe_step_pieces(binfhe, ctx, bk, B: int = 4) -> list:
    """One CGGI external product at batch B taken apart, each piece on the
    step's shapes: the host time of a call (STEP_RUNS calls
    back to back, one synchronise), its device time (CUDA-graph replay)
    and, for the plain-torch pieces, its kernels (a ``torch.profiler``
    trace of STEP_RUNS calls). On the card a trace of a few dozen
    launches of the ported kernels alone came back short or empty, so
    their launches are the gate trace's. The step runs the digit inner
    product and the monomial product as one ``ks_inner_product`` call;
    the pieces it replaced (the inner product alone, the gather of the
    monomial rows and the plain ``mul_mod``) are timed beside it, marked
    off the path."""
    from .ops import elementwise
    from .ops.modular import add_mod, mul_mod
    p = ctx.params
    rng = np.random.default_rng(5)
    acc = torch.from_numpy(rng.integers(0, p.Q, size=(2, B, p.N))).to(
        ctx.device)
    exps = torch.from_numpy(rng.integers(0, 2 * p.N, size=B)).to(ctx.device)
    decompose = binfhe._make_signed_decompose(p)
    mono, mod = binfhe._monomial_table(ctx), binfhe._mod(ctx)
    row_mod = binfhe._row_mod(ctx, B)
    dec = decompose(acc)
    digits = binfhe._ntt_nd(dec, p.Q)
    ext = elementwise.ks_inner_product(digits, bk.ek[0, 0], bk.ek[0, 1],
                                       (0,) * B, row_mod)
    mono_rows = mono[exps]
    rotated = mul_mod(ext, mono_rows, mod)
    back = binfhe._ntt_nd(rotated, p.Q, inverse=True)
    # (piece, call, plain torch?, on the step's path?)
    pieces = (
        ("signed decomposition", lambda: decompose(acc), True, True),
        ("NTT forward", lambda: binfhe._ntt_nd(dec, p.Q), False, True),
        ("ks_inner_product with the monomial epilogue",
         lambda: elementwise.ks_inner_product(
             digits, bk.ek[0, 0], bk.ek[0, 1], (0,) * B, row_mod,
             mono=mono, mono_rows=exps), False, True),
        ("NTT inverse", lambda: binfhe._ntt_nd(rotated, p.Q, inverse=True),
         False, True),
        ("add_mod", lambda: add_mod(acc, back, p.Q), True, True),
        ("ks_inner_product alone", lambda: elementwise.ks_inner_product(
            digits, bk.ek[0, 0], bk.ek[0, 1], (0,) * B, row_mod), False,
         False),
        ("monomial row gather", lambda: mono[exps], True, False),
        ("monomial mul_mod", lambda: mul_mod(ext, mono_rows, mod), True,
         False))
    rows = []
    for name, fn, plain, on_path in pieces:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEP_RUNS):
            fn()
        torch.cuda.synchronize()
        row = {"piece": name, "on_path": on_path,
               "host_us": 1e6 * (time.perf_counter() - t0) / STEP_RUNS,
               "device_us": 1e3 * graph_ms(fn, 100)}
        if plain:
            row["kernels"] = _profile(fn, runs=STEP_RUNS)["kernels_per_op"]
        rows.append(row)
        print(f"BINFHE STD128 external product (B = {B}), {name}"
              + ("" if on_path else " (off the path)") + ": "
              + (f"{row['kernels']:.1f} kernels, " if plain else "")
              + f"device {row['device_us']:.1f} us, host "
              f"{row['host_us']:.1f} us a call", flush=True)
    return rows


def _binfhe_row(label: str, fn, wrappers, runs: int, **extra) -> dict:
    """Host latency of `runs` runs after a warm one, the launches of each
    wrapper in one run and a profiler trace of two more."""
    fn()
    before = {k: w.launches for k, w in wrappers.items()}
    fn()
    launches = {f"{k}_launches": w.launches - before[k]
                for k, w in wrappers.items()}
    ms = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    row = {"op": label, "host_ms_median": float(med), "host_ms_q1": float(q1),
           "host_ms_q3": float(q3), "runs": runs, **extra, **launches,
           **_profile(fn, runs=2, top=12)}
    row["device_busy_share"] = row["device_busy_us"] / (1e3 * med)
    print(f"{label}: host {med:.3f} ms ({q1:.3f}-{q3:.3f}, {runs} runs), "
          f"device busy {row['device_busy_us']:.1f} us "
          f"({100 * row['device_busy_share']:.1f}%), "
          f"{row['kernels_per_op']:.0f} kernels; "
          + ", ".join(f"{k} {launches[k + '_launches']} launches "
                      f"{row[k + '_us']:.1f} us" for k in wrappers),
          flush=True)
    for k in row["plain_top"]:
        print(f"  plain kernel {k['launches']:.0f} launches "
              f"{k['us']:.1f} us: {k['kernel'][:150]}", flush=True)
    return row


def _lmk_step_pieces(binfhe, ctx, bk) -> list:
    """One LMKCDEY external step and one automorphism step (by 5) on
    [2, 1, N], as _binfhe_step_pieces takes its pieces: host time a call
    over STEP_RUNS calls, device time by CUDA-graph replay, kernels from a
    profiler trace."""
    p = ctx.params
    rng = np.random.default_rng(9)
    acc = torch.from_numpy(rng.integers(0, p.Q, size=(2, 1, p.N))).to(
        ctx.device)
    zero = np.zeros(1, np.int32)
    rows = []
    for name, op, count in (("external product", 0, p.n_lwe),
                            ("automorphism", 1, p.N - 1)):
        ops = np.full(1, op, np.int32)

        def fn():
            return binfhe._blind_rotate_lmk(ctx, bk, acc, ops, zero)

        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEP_RUNS):
            fn()
        torch.cuda.synchronize()
        row = {"step": name, "steps_a_gate": count,
               "host_us": 1e6 * (time.perf_counter() - t0) / STEP_RUNS,
               "device_us": 1e3 * graph_ms(fn, 100),
               "kernels": _profile(fn, runs=STEP_RUNS)["kernels_per_op"]}
        rows.append(row)
        print(f"BINFHE {ctx.params.method} {name} step: {row['kernels']:.1f} "
              f"kernels, device {row['device_us']:.1f} us, host "
              f"{row['host_us']:.1f} us a call; {count} a gate: "
              f"{count * row['host_us'] / 1e3:.1f} ms of host", flush=True)
    return rows


def _binfhe_keys(name: str, seed: int):
    """A context of the named set, its secret and bootstrap key (timed), two
    encryptions of 0 and 1, and the ported kernels' wrappers."""
    from .models import binfhe
    from .ops import elementwise
    ctx = binfhe.gen_context(name)
    rng = np.random.default_rng(seed)
    sk = binfhe.keygen(ctx, rng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bk = binfhe.bootstrap_keygen(ctx, sk, rng)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    print(f"BINFHE {name} bootstrap_keygen: {keygen_s:.3f} s (key "
          f"{tuple(bk.ek.shape)}, key switch {tuple(bk.ks_a.shape)})",
          flush=True)
    cts = [binfhe.encrypt(ctx, sk, x, rng) for x in (0, 1)]
    wrappers = {"ntt_small_forward": ntt.forward_small,
                "ntt_small_inverse": ntt.inverse_small,
                "ks_inner_product": elementwise.ks_inner_product}
    return binfhe, ctx, sk, bk, keygen_s, rng, cts, wrappers


def profile_binfhe_lmkcdey() -> dict:
    """BINFHE at STD128_LMKCDEY: key generation, one AND (one ciphertext)
    warm with its launches and busy share, then one step of each kind."""
    binfhe, ctx, _, bk, keygen_s, _, cts, wrappers = _binfhe_keys(
        "STD128_LMKCDEY", 83)
    row = _binfhe_row("BINFHE STD128_LMKCDEY AND, one ciphertext",
                      lambda: binfhe.eval_gate(ctx, "AND", bk, *cts),
                      wrappers, 10, bootstrap_keygen_s=keygen_s)
    return {"gates": [row], "steps": _lmk_step_pieces(binfhe, ctx, bk)}


def profile_binfhe() -> dict:
    """BINFHE at STD128 (chip_smoke.py phase 17): bootstrap-key generation
    once, then a batched AND (B = 4) and a refresh (B = 1), warm, with the
    launches of each wrapper, the device time of each kernel and the plain
    kernels that take the most device time; then one external product taken
    apart."""
    binfhe, ctx, sk, bk, keygen_s, rng, cts, wrappers = _binfhe_keys(
        "STD128", 61)
    rows = [_binfhe_row(f"BINFHE STD128 {name}", fn, wrappers, TIMED_RUNS,
                        bootstrap_keygen_s=keygen_s) for name, fn in (
        ("AND, B = 4", lambda: binfhe.eval_gate_batch(
            ctx, "AND", bk, cts * 2, cts[::-1] + cts)),
        ("refresh, B = 1", lambda: binfhe.bootstrap(ctx, bk, cts[1])))]
    ct = binfhe.encrypt_phase(ctx, sk, 9000, ctx.params.q_ks, rng)
    large = _binfhe_row(
        "BINFHE STD128 eval_sign_large (q_ks = 2^14, beta = 64)",
        lambda: binfhe.eval_sign_large(ctx, bk, ct, 64), wrappers, 5)
    return {"gates": rows, "eval_sign_large": large,
            "step_pieces": _binfhe_step_pieces(binfhe, ctx, bk)}


def profile_ntt_passes(label: str, moduli: tuple, lead: tuple) -> list:
    """Device time of each pass of forward and inverse at [*lead, L, n] on a
    cold L2, by the kernels' names."""
    from torch.profiler import ProfilerActivity, profile
    n, L = RING_DIM, len(moduli)
    rng = np.random.default_rng(3)
    cols = [rng.integers(0, q, size=lead + (n,), dtype=np.uint64)
            for q in moduli]
    x = torch.from_numpy(np.stack(cols, axis=-2).astype(np.int64)).cuda()
    y = ntt.forward(x, moduli)
    flush = torch.zeros(FLUSH_BYTES // 8, dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_RUNS):
            flush.add_(1)
            ntt.forward(x, moduli)
            flush.add_(1)
            ntt.inverse(y, moduli)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        m = re.search(r"(col|row)_pass_fast<[^>]*(true|false)>", ev.key)
        if not m:
            continue
        us = ev.self_device_time_total / ev.count
        twisted = (m.group(1) == "row") == (m.group(2) == "true")
        nbytes = 16 * x.numel() + (16 * L * n if twisted else 0)
        row = {"shape": label, "pass": m.group(1),
               "direction": "forward" if m.group(2) == "true" else "inverse",
               "cold_us": us, "bytes": nbytes,
               "hbm_share": nbytes / (us * 1e-6) / HBM_BYTES_PER_S}
        print(f"NTT {label} {row['direction']} {row['pass']} pass, cold L2: "
              f"{us:.1f} us for {nbytes / 1e6:.1f} MB, "
              f"{100 * row['hbm_share']:.0f}% of the memory rate", flush=True)
        rows.append(row)
    if len(rows) != 4:
        raise RuntimeError(f"expected 4 NTT pass kernels, found {len(rows)}")
    return rows


def butterfly_clocks() -> dict:
    """Build and run bench/butterfly.cu; clocks per warp-wide butterfly
    on one SM partition, by variant."""
    src = _build.SRC_DIR.parent / "bench" / "butterfly.cu"
    exe = _build.BUILD_DIR / "butterfly"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.nvcc(), *flags, "-o", str(exe), str(src)],
                   check=True, capture_output=True, text=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True).stdout
    clocks = {}
    for line in out.splitlines():
        name, _ms, _, clk, _ = line.split()
        clocks[name] = float(clk)
        print(f"butterfly {name}: {clk} clocks per warp on an SM partition",
              flush=True)
    return clocks


class _HostTimer:
    """Wraps module functions for the duration of a `with` block and adds
    up their calls and host seconds by name."""

    def __init__(self, targets):
        self.targets = targets            # name -> (module, attribute)
        self.seconds = {name: 0.0 for name in targets}
        self.calls = {name: 0 for name in targets}

    def __enter__(self):
        self.saved = {}
        for name, (mod, attr) in self.targets.items():
            fn = getattr(mod, attr)
            self.saved[name] = fn
            setattr(mod, attr, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds[name] += time.perf_counter() - t0
                self.calls[name] += 1
        return timed

    def __exit__(self, *exc):
        for name, (mod, attr) in self.targets.items():
            setattr(mod, attr, self.saved[name])


def profile_bootstrap() -> dict:
    """One warm bootstrap at n = 2^16 (e2e_scale.py phase B)."""
    ctx = ckks.gen_context(ckks.CKKSParams(
        ring_dim=RING_DIM, mult_depth=20, scaling_mod_size=45,
        first_mod_size=55, dnum=3, secret_hw=64))
    rng = np.random.default_rng(11)
    pk, sk = ckks.keygen(ctx, rng)
    pre = boot.setup(ctx, slots=4, K=16, r=5, cheb_deg=28)
    keys = boot.keygen(ctx, sk, pre, rng)
    vals = np.array([0.25, -0.5, 0.75, 0.125])
    ct = ckks.encrypt(ctx, pk, np.tile(vals, ctx.params.num_slots // 4), rng)
    low = ckks.level_reduce(ct, len(ctx.q_moduli) - 1)

    def run():
        return boot.eval_bootstrap(ctx, keys, pre, low)

    out = run()                                # tables built, caches filled
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    row = _profile(run, runs=1)
    targets = {"ckks_encode": (encoding, "ckks_encode"),
               "signed_to_rns_rows": (sampling, "signed_to_rns_rows"),
               "encode_to_card": (ckks, "encode")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _HostTimer(targets) as timer:
        run()
        torch.cuda.synchronize()
    timed_ms = 1e3 * (time.perf_counter() - t0)
    # the JAX package's encoder for one full-chain plaintext: Python ints,
    # then a Python remainder per tower and coefficient
    slots = np.zeros(ctx.n // 2, dtype=np.complex128)
    slots[:] = np.tile(vals, ctx.params.num_slots // 4)
    t0 = time.perf_counter()
    coeffs = encoding.ckks_embed_inv(slots, ctx.n) * ctx.scale
    exact = np.asarray([int(v) for v in np.rint(coeffs)], dtype=object)
    sampling.signed_to_rns_rows(exact, ctx.q_moduli)
    exact_ms = 1e3 * (time.perf_counter() - t0)
    encodes = timer.calls["encode_to_card"]
    row.update({
        "host_ms": ms, "host_ms_median": float(np.median(ms)),
        "towers_regained": out.towers,
        "instrumented_run_ms": timed_ms, "encodes": encodes,
        **{f"{k}_ms": 1e3 * v for k, v in timer.seconds.items()},
        "exact_path_encode_ms_each": exact_ms,
        "exact_path_encode_ms_estimate": exact_ms * encodes})
    row["device_busy_share"] = row["device_busy_us"] / (
        1e3 * row["host_ms_median"])
    print(f"bootstrap n=65536: host {row['host_ms_median']:.1f} ms "
          f"(runs {', '.join(f'{m:.1f}' for m in ms)}), device busy "
          f"{row['device_busy_us'] / 1e3:.1f} ms "
          f"({100 * row['device_busy_share']:.1f}%), "
          f"{row['kernels_per_op']:.0f} kernels, {_ours_text(row)}",
          flush=True)
    print(f"bootstrap encoding: {encodes} plaintexts; in a run of "
          f"{timed_ms:.1f} ms, ckks_encode {row['ckks_encode_ms']:.1f} ms + "
          f"signed_to_rns_rows {row['signed_to_rns_rows_ms']:.1f} ms on the "
          f"host, ckks.encode in all {row['encode_to_card_ms']:.1f} ms; the "
          f"exact Python-int path {exact_ms:.1f} ms each, "
          f"{row['exact_path_encode_ms_estimate']:.0f} ms for all",
          flush=True)
    return row


SECTIONS = ("ops", "passes", "butterfly", "bootstrap", "bgv", "bfv",
            "threshold", "binfhe")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("profile_ops: no CUDA device")
    args = sys.argv[1:]
    method = "GINX"
    if "--method" in args:
        i = args.index("--method")
        method = args[i + 1] if i + 1 < len(args) else ""
        del args[i:i + 2]
        if method not in ("GINX", "LMKCDEY"):
            sys.exit("profile_ops: --method takes GINX or LMKCDEY")
    wanted = args or list(SECTIONS)
    unknown = set(wanted) - set(SECTIONS)
    if unknown:
        sys.exit(f"profile_ops: unknown sections {sorted(unknown)}; "
                 f"choose from {SECTIONS}")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(gpu, flush=True)
    out = {"gpu": gpu}
    if "ops" in wanted:
        out["ops"] = profile_chain("60-bit", 1, seed=7) + \
            profile_chain("composite", 2, seed=11)
    if "passes" in wanted:
        ctx = ckks.gen_context(ckks.CKKSParams(
            ring_dim=RING_DIM, mult_depth=TOWERS - 1, scaling_mod_size=59,
            first_mod_size=60, dnum=3))
        qp = ctx.q_moduli + ctx.p_moduli
        out["ntt_passes"] = profile_ntt_passes("[8, 65536]", ctx.q_moduli,
                                               ()) + \
            profile_ntt_passes("[3, 11, 65536]", qp, (3,))
    if "butterfly" in wanted:
        out["butterfly_clocks"] = butterfly_clocks()
    if "bootstrap" in wanted:
        out["bootstrap"] = profile_bootstrap()
    if "bgv" in wanted:
        out["bgv"] = profile_bgv()
    if "bfv" in wanted:
        out["bfv"] = profile_bfv()
    if "threshold" in wanted:
        out["threshold"] = profile_threshold()
    if "binfhe" in wanted:
        out["binfhe"] = profile_binfhe() if method == "GINX" else \
            profile_binfhe_lmkcdey()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
