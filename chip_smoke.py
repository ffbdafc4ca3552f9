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
to the same run on the CPU twins. The line before the last is a JSON
object with each kernel's launches, error against its twin, times (L2-warm
``ms``, cold-L2 ``cold_ms``, the twin's ``plain_ms``) and ``bound_ms``, the
least time the card could take for the call; the last line is the JSON
device summary. There is no CPU path:
without a CUDA device it exits non-zero.
"""

import json
import subprocess
import sys
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


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps):
    """Mean device time of fn() (or of a tuple of functions called in turn)
    over `reps` calls. The calls are captured in one CUDA graph and the
    replay is timed with CUDA events, so the host's cost of each call
    (Python, ctypes) is not counted: for the short kernels it exceeds the
    kernel's own time. A warm-up call first builds every
    table and cache outside the capture."""
    calls = fn if isinstance(fn, tuple) else (fn,)
    for f in calls:
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            for f in calls:
                f()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    assert ms > 0, f"non-positive kernel time {ms}"
    return ms


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


def ks_bound(ndig, rows, n):
    """ks_inner_product over [ndig, rows, n]: the digits, both key halves and
    both outputs once; per output a 64x64->128 product a digit (four
    multiply-adds and four additions to accumulate) and a final reduction of
    some twenty operations."""
    return bound(8 * rows * n * (3 * ndig + 2), rows * n * 2 * (8 * ndig + 20))


def fused_mac_bound(rows, n):
    """fused_mac_mod over [rows, n]: three operands and one result, one
    product and one reduction a coefficient."""
    return bound(8 * rows * n * 4, rows * n * 28)


def compare(name, kernel, plain, bound_, reps=20):
    """Kernel against twin on the same inputs: bit-equal, and both timed."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    if err or not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel differs from its twin "
                             f"(max abs err {err})")
    ms = cuda_ms(kernel, reps)
    cold = cold_ms(kernel, reps)
    plain_ms = cuda_ms(plain, max(2, reps // 10))
    log(f"  {name}: torch.equal to twin; kernel {ms:.4f} ms warm, "
        f"{cold:.4f} ms cold L2, twin {plain_ms:.4f} ms, bound "
        f"{bound_['bound_ms']:.4f} ms ({bound_['bound_by']})")
    # no single PyTorch call computes a negacyclic NTT modulo q or a modular
    # multiply-accumulate on 60-bit residues: there is no library time
    return {"shape": name.split(" ", 1)[1], "max_abs_err": err, "ms": ms,
            "cold_ms": cold, "plain_ms": plain_ms, **bound_,
            "library_ms": None}


def uniform(moduli, shape, rng, device):
    cols = [rng.integers(0, q, size=shape, dtype=np.uint64) for q in moduli]
    arr = np.stack(cols, axis=-2).astype(np.int64)
    return torch.from_numpy(arr).to(device)


def check_kernels(ctx60, ctx30, device):
    """Phase 2: each kernel against its twin at the main path's shapes (and
    one ring dimension that takes the NTT's generic path). The NTT entries of
    the summary are the keyswitch mod-up shape's and list every shape under
    ``shapes``."""
    from openfhe_tpu_torch.ops import elementwise, modular, ntt

    rng = np.random.default_rng(3)
    n = RING_DIM
    results = {}
    qp = ctx60.q_moduli + ctx60.p_moduli
    cases = [("[8, 65536] 60-bit", ctx60.q_moduli, (), n),
             ("[16, 65536] 30-bit", ctx30.q_moduli, (), n),
             ("[1, 65536] 60-bit", ctx60.q_moduli[-1:], (), n),
             ("[2, 11, 65536] 60-bit QP", qp, (2,), n),
             ("[3, 8, 2048] 60-bit generic path", ctx60.q_moduli, (3,), 2048),
             ("[3, 11, 65536] 60-bit QP", qp, (3,), n)]
    shapes = {"ntt_forward": [], "ntt_inverse": []}
    for label, moduli, lead, dim in cases:
        x = uniform(moduli, lead + (dim,), rng, device)
        t = ntt.tables(dim, moduli, device)
        bound_ = ntt_bound(x.numel() // dim, len(moduli), dim)
        fwd = compare(f"ntt_forward {label}", lambda: ntt.forward(x, moduli),
                      lambda: ntt.forward_plain(x, t), bound_)
        y = ntt.forward(x, moduli)
        inv = compare(f"ntt_inverse {label}", lambda: ntt.inverse(y, moduli),
                      lambda: ntt.inverse_plain(y, t), bound_)
        if not torch.equal(ntt.inverse(y, moduli), x):
            raise AssertionError(f"inverse(forward(x)) != x at {label}")
        log(f"  inverse(forward(x)) == x at {label}")
        shapes["ntt_forward"].append(fwd)
        shapes["ntt_inverse"].append(inv)
    for name, per_shape in shapes.items():
        results[name] = {**per_shape[-1], "shapes": per_shape}

    mod = modular.make_mod_consts(qp, device)
    digits = uniform(qp, (3, n), rng, device)
    kb = uniform(qp, (3, n), rng, device)
    ka = uniform(qp, (3, n), rng, device)
    rows = list(range(len(qp)))
    rows_t = torch.tensor(rows, dtype=torch.int64, device=device)
    results["ks_inner_product"] = compare(
        "ks_inner_product [3, 11, 65536] 60-bit QP",
        lambda: elementwise.ks_inner_product(digits, kb, ka, rows, mod),
        lambda: elementwise.ks_inner_product_plain(
            digits, kb, ka, rows_t, mod), ks_bound(3, len(qp), n))
    x, y, acc = digits[0], kb[0], ka[0]
    results["fused_mac_mod"] = compare(
        "fused_mac_mod [11, 65536] 60-bit QP",
        lambda: elementwise.fused_mac_mod(x, y, acc, mod),
        lambda: elementwise.fused_mac_plain(x, y, acc, mod),
        fused_mac_bound(len(qp), n))
    return results


def counters():
    from openfhe_tpu_torch.ops import elementwise, ntt
    return {"ntt_forward": ntt.forward, "ntt_inverse": ntt.inverse,
            "ks_inner_product": elementwise.ks_inner_product,
            "fused_mac_mod": elementwise.fused_mac_mod}


def main_path(ckks, ctx, label, seed):
    """Phases 3 and 4: the CKKS main path, timed stage by stage."""

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    times = {}
    n = ctx.n
    rng = np.random.default_rng(seed)
    for wrapper in counters().values():
        wrapper.launches = 0
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
    launches = {k: w.launches for k, w in counters().items()}
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
    missing = [k for k, v in launches.items() if v == 0]
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


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's kernels need one")
    from openfhe_tpu_torch import _build
    from openfhe_tpu_torch.models import ckks

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

    log("[2] kernels against their twins")
    checks = check_kernels(ctx60, ctx30, device)

    log("[3] main path, 60-bit chain")
    launches = main_path(ckks, ctx60, "60-bit chain", seed=7)
    log("[4] main path, composite chain")
    main_path(ckks, ctx30, "composite chain", seed=11)
    log("[5] the slice on the card against the CPU twins")
    check_against_cpu(ckks)

    ntt_pallas = "openfhe_tpu/ops/ntt_pallas.py"
    mac_pallas = "openfhe_tpu/ops/elementwise_pallas.py:54"
    sources = {"ntt_forward": ("csrc/ntt.cu", f"{ntt_pallas}:282"),
               "ntt_inverse": ("csrc/ntt.cu", f"{ntt_pallas}:293"),
               "ks_inner_product": ("csrc/mac.cu", mac_pallas),
               "fused_mac_mod": ("csrc/mac.cu", mac_pallas)}
    kernels = [{"name": name, "route": "cuda",
                "source": f"openfhe_tpu_torch/{src}", "replaces": rep,
                "launches": launches[name], **checks[name]}
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
