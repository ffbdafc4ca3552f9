"""The test run's harness, for every test under this directory.

tests/conftest.py sets up the JAX reference's CPU backend; this file, loaded
before it, adds what keeps a run of the tests bounded: the XLA:CPU options
the reference is compiled with, torch's threads per xdist worker, and each
test's time limit; and the order in which xdist starts the files.
"""

import faulthandler
import os
import signal
import sys

import pytest


def _add_xla_flag(flag):
    """Append `flag` to XLA_FLAGS unless the variable already sets it."""
    flags = os.environ.get("XLA_FLAGS", "")
    if flag.split("=")[0] not in flags:
        os.environ["XLA_FLAGS"] = (flags + " " + flag).strip()


# The JAX reference's u32-limb arithmetic is long chains of shared integer
# ops on small arrays. XLA:CPU's fusion emitters turn its fusions into code
# that runs one jitted key switch at n = 128 in 72-94 s a call; the legacy
# emitters run the same fusions in 2 ms, with the same bits, and compile
# faster than with fusion disabled. XLA reads XLA_FLAGS when the backend
# starts, which is lazy (tests/conftest.py); os.environ carries it to xdist
# workers and subprocesses.
_add_xla_flag("--xla_cpu_use_fusion_emitters=false")
# With that, compiling is most of the reference's cost on the CPU; LLVM at
# -O0 compiles the same key switch in 6.7 s instead of 8.4-10 s and runs it
# in 6 ms instead of 2 ms, with the same bits.
_add_xla_flag("--xla_backend_optimization_level=0")

# xdist workers share the CPU's cores among them (one each for 6 workers on
# 8 cores): torch's default, every core in every worker, thrashes.
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    import torch

    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

# Each test's own limit, in seconds, over its setup, call and teardown;
# @pytest.mark.timeout(seconds) replaces it. A test that overruns it fails
# under its own name. XLA:CPU can hold the interpreter inside one call for
# minutes, where the alarm cannot fire; HARD_STOP_MARGIN seconds later
# faulthandler dumps every thread's stack and ends the process, which xdist
# reports as a crash of that test and replaces with a fresh worker.
TEST_TIME_LIMIT = 600
HARD_STOP_MARGIN = 60

# Limits of the tests in the JAX package's own test files that need more
# than the default, which carry no marker: about twice their cold time on an
# 8-core CPU (581 s and 441 s in a tier-1 run, the iterative test 416 s
# alone; each runs out of levels, ROADMAP Queue 3 item 8).
LIMITS = {
    "tests/test_bootstrap_fft.py::test_bootstrap_staged_roundtrip": 1200,
    "tests/test_bootstrap.py::test_bootstrap_roundtrip": 900,
    "tests/test_bootstrap.py::test_bootstrap_iterative_improves_precision":
        900,
}

_STDERR = pytest.StashKey[int]()

pytest_plugins = ["pytester"]  # tests/test_conftest.py runs pytest in pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", f"timeout(seconds): this test's time limit in place of "
        f"the default {TEST_TIME_LIMIT} s")
    # Captured output is lost when the process ends, so the stack dump goes
    # to a copy of the stderr that pytest started with.
    config.stash[_STDERR] = os.dup(sys.__stderr__.fileno())
    # xdist (--dist loadfile) would start the files with the most tests
    # first; keep the order pytest_collection_modifyitems gives them.
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR])


@pytest.hookimpl(trylast=True)
def pytest_collection_modifyitems(items):
    """Start first the files with a test in LIMITS, the longest first.

    xdist hands each worker two files at its start and one more each time
    it ends one, so a long file that is not among the first six can wait
    behind another: in collection order the two bootstrap files shared one
    worker and a cold tier-1 run on 8 cores took 1245 s, 962 s with them
    first. The rest keep their collection order.
    """
    longest = {}
    for item in items:
        longest[item.path] = max(longest.get(item.path, 0),
                                 LIMITS.get(item.nodeid, 0))
    items.sort(key=lambda item: -longest[item.path])


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    marker = item.get_closest_marker("timeout")
    limit = (marker.args[0] if marker
             else LIMITS.get(item.nodeid, TEST_TIME_LIMIT))

    def overrun(signum, frame):
        pytest.fail(f"{item.nodeid} ran past its time limit of {limit} s")

    previous = signal.signal(signal.SIGALRM, overrun)
    signal.setitimer(signal.ITIMER_REAL, limit)
    faulthandler.dump_traceback_later(limit + HARD_STOP_MARGIN, exit=True,
                                      file=item.config.stash[_STDERR])
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
