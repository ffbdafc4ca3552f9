"""The test harness's own settings in the repository's root conftest.py: the
XLA:CPU options the JAX reference is compiled with, and each test's time
limit."""

import ast
import os
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from openfhe_tpu import keyswitch
from openfhe_tpu.models import bgv

CONFTEST = Path(__file__).parents[1] / "conftest.py"


@pytest.mark.parametrize("option", ["--xla_cpu_use_fusion_emitters=false",
                                    "--xla_backend_optimization_level=0"])
def test_xla_flags_hold_the_cpu_options(option):
    assert option in os.environ.get("XLA_FLAGS", "").split()


def test_limits_name_tests_that_exist():
    """Every entry of the harness's LIMITS names a test function its file
    defines, so a renamed test does not lose its limit unseen."""
    tree = ast.parse(CONFTEST.read_text())
    limits = next(ast.literal_eval(node.value) for node in tree.body
                  if isinstance(node, ast.Assign)
                  and getattr(node.targets[0], "id", None) == "LIMITS")
    assert limits
    for nodeid in limits:
        path, name = nodeid.split("::")
        source = (CONFTEST.parent / path).read_text()
        assert f"\ndef {name}(" in source, nodeid


def test_compiled_keyswitch_runs_in_seconds():
    """One jitted key switch at tests/test_bgv.py's setup runs in about
    6 ms once compiled under the options, 72-94 s without them."""
    rng = np.random.default_rng(99)
    params = bgv.BGVParams(ring_dim=128, mult_depth=2,
                           plaintext_modulus=12289, mod_size=55, dnum=2)
    ctx = bgv.gen_context(params)
    pk, sk = bgv.keygen(ctx, rng)
    evk = bgv.relin_keygen(ctx, sk, rng)
    ct = bgv.encrypt(ctx, pk, [1] * ctx.n, rng)
    c2 = bgv.eval_mult(ct, ct).polys[2]
    compiled = keyswitch.apply.lower(evk, c2).compile()
    jax.block_until_ready(compiled(evk, c2))
    start = time.perf_counter()
    jax.block_until_ready(compiled(evk, c2))
    assert time.perf_counter() - start < 5


def test_time_limit_fails_the_test_and_a_marker_replaces_it(pytester):
    pytester.makeconftest(CONFTEST.read_text() + "\nTEST_TIME_LIMIT = 1\n")
    pytester.makepyfile("""
        import time
        import pytest

        def test_overruns():
            time.sleep(3)

        @pytest.mark.timeout(5)
        def test_marker_gives_more_time():
            time.sleep(2)
    """)
    result = pytester.runpytest_subprocess("-p", "no:randomly")
    result.assert_outcomes(passed=1, failed=1)
    result.stdout.fnmatch_lines(
        ["*test_overruns ran past its time limit of 1 s*"])


def test_files_with_a_long_test_start_first(pytester):
    pytester.makeconftest(CONFTEST.read_text() + "\nLIMITS = "
                          "{'test_c.py::test_long': 900}\n")
    for name in "abc":
        pytester.makepyfile(**{f"test_{name}": f"def test_{name}(): pass\n"
                               "def test_long(): pass\n"})
    result = pytester.runpytest("--collect-only", "-q", "-p", "no:randomly")
    result.stdout.fnmatch_lines(["test_c.py::test_c", "test_c.py::test_long",
                                 "test_a.py::test_a", "test_a.py::test_long",
                                 "test_b.py::test_b"])


def test_hard_stop_ends_a_test_the_alarm_cannot_reach(pytester):
    """A test stuck where the alarm's handler cannot run (here: SIGALRM
    blocked, as inside one long native call) ends its process, with every
    thread's stack, at the limit plus the margin."""
    pytester.makeconftest(CONFTEST.read_text() + "\nTEST_TIME_LIMIT = 1"
                          "\nHARD_STOP_MARGIN = 1\n")
    pytester.makepyfile("""
        import signal
        import time

        def test_stuck():
            signal.pthread_sigmask(signal.SIG_BLOCK, [signal.SIGALRM])
            time.sleep(30)
    """)
    start = time.monotonic()
    result = pytester.runpytest_subprocess("-p", "no:randomly")
    assert time.monotonic() - start < 25
    assert result.ret != 0
    result.stderr.fnmatch_lines(["Timeout (0:00:02)!*", "*test_stuck*"])
