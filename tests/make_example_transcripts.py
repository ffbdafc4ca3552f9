"""Capture the JAX example programs' transcripts for the port's tests.

Runs each ``examples/<name>.py`` the way the JAX package runs it (through
its own ``common.py``, from ``cwd=examples/``, with ``runpy``), one process
per program, several at a time, each under its own time limit, and writes
its standard output, with the ``tempfile.mkdtemp`` directory masked, to
``tests/data/example_transcripts/<name>.txt``.

A program that ends by an exception (three of the bootstrapping programs
run out of levels) has the exception's last traceback line as the last
line of its transcript, as the port's ``run`` writes it. Each program runs
jitted or with ``jax_disable_jit``, as ``_NOJIT`` says. A summary line per
program (seconds, mode, outcome) goes to standard output.

    JAX_PLATFORMS=cpu python tests/make_example_transcripts.py [names...]
        [--jobs 5] [--limit 5400]
"""

import argparse
import os
import runpy
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
OUT_DIR = os.path.join(ROOT, "tests", "data", "example_transcripts")

# BGV/BFV key switches run ~100 s a call jitted on a CPU; op by op they take
# seconds. A bootstrap jitted compiles every op at every level, and so does
# function_evaluation's depth-8 chain (jitted it ran over 40 minutes);
# scheme switching finished only op by op. The other CKKS programs and the
# BINFHE ones are faster jitted (the blind rotation is one lax.scan).
_NOJIT = {"rotation", "inner_product", "function_evaluation",
          "simple_integers_bgvrns", "depth_bgvrns",
          "simple_integers_serial_bgvrns", "simple_integers", "depth_bfvrns",
          "depth_bfvrns_behz", "simple_integers_serial", "string_encoding",
          "threshold_fhe_5p", "simple_ckks_bootstrapping",
          "advanced_ckks_bootstrapping", "iterative_ckks_bootstrapping",
          "scheme_switching"}


def names():
    return sorted(f[:-3] for f in os.listdir(EXAMPLES)
                  if f.endswith(".py") and f != "common.py")


def _child(name, nojit):
    """Runs one program in this process, as ``python examples/<name>.py``."""
    os.chdir(EXAMPLES)
    sys.path.insert(0, EXAMPLES)
    import common  # noqa: F401  (the JAX package's own example setup)
    import jax
    jax.config.update("jax_disable_jit", nojit)
    path = os.path.join(EXAMPLES, name + ".py")
    sys.argv = [path]
    sys.path.insert(0, ROOT)
    from openfhe_tpu_torch.examples._common import transcript_of
    text = transcript_of(runpy.run_path, path, None, "__main__")
    sys.stdout.write(text)


def _mask(text):
    sys.path.insert(0, ROOT)
    from openfhe_tpu_torch.examples._common import mask_tmp
    return mask_tmp(text)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*")
    ap.add_argument("--jobs", type=int, default=5)
    ap.add_argument("--limit", type=float, default=5400.0)
    ap.add_argument("--child", metavar="NAME")
    a = ap.parse_args()
    if a.child:
        _child(a.child, a.child in _NOJIT)
        return
    queue = a.names or names()
    os.makedirs(OUT_DIR, exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    running, failed = {}, []
    while queue or running:
        while queue and len(running) < a.jobs:
            n = queue.pop(0)
            p = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--child", n],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env,
                text=True)
            running[n] = (p, time.time())
        time.sleep(1.0)
        for n, (p, t0) in list(running.items()):
            sec = time.time() - t0
            if p.poll() is None and sec < a.limit:
                continue
            if p.poll() is None:
                p.kill()
            out = p.communicate()[0]
            del running[n]
            mode = "nojit" if n in _NOJIT else "jit"
            if p.returncode == 0:
                with open(os.path.join(OUT_DIR, n + ".txt"), "w") as f:
                    f.write(_mask(out))
                print(f"{n}: {sec:.1f} s {mode} ok", flush=True)
            else:
                why = "over the limit" if sec >= a.limit else \
                    f"rc {p.returncode}"
                print(f"{n}: {sec:.1f} s {mode} {why}", flush=True)
                failed.append(n)
    print("not finished:", failed, flush=True)


if __name__ == "__main__":
    main()
