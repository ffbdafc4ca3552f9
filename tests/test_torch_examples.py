"""The port's example programs against the JAX package's, transcript for
transcript.

Each program of ``openfhe_tpu_torch/examples`` makes the calls of its
namesake in ``examples/`` with the same seeds and prints the same lines.
Run on the CPU, its standard output, with the ``tempfile.mkdtemp``
directory masked, must equal the JAX program's as
``tests/make_example_transcripts.py`` captured it
(``tests/data/example_transcripts``), string for string: the data are
bit-equal, so no tolerance applies. Each program's own asserts run too. A
program that ends by an exception must end by the same one: the three
bootstrapping programs run out of levels before SlotsToCoeffs in both
packages, and their transcripts end with the ``AssertionError`` line.
This file holds the CKKS, bootstrapping, BGV, BFV and protocol programs and
the checks of the set; ``test_torch_examples_binfhe.py`` the BINFHE programs
and scheme switching (a separate file, so that the two run on separate
test workers). None is marked ``slow``: on one thread the slowest programs
(``eval_sign``, ``scheme_switching``, ``eval_decomp``) take 20-30 s.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from openfhe_tpu_torch.examples._common import mask_tmp, run

ROOT = Path(__file__).resolve().parents[1]
PORT_EXAMPLES = ROOT / "openfhe_tpu_torch" / "examples"
TRANSCRIPTS = ROOT / "tests" / "data" / "example_transcripts"
JAX_EXAMPLES = sorted(p.stem for p in (ROOT / "examples").glob("*.py")
                      if p.stem != "common")

SCHEMES = ("simple_real_numbers", "rotation", "polynomial_evaluation",
           "function_evaluation", "linearwsum_evaluation", "inner_product",
           "advanced_real_numbers", "advanced_real_numbers_128",
           "ckks_noise_flooding", "simple_real_numbers_serial",
           "simple_ckks_bootstrapping", "advanced_ckks_bootstrapping",
           "iterative_ckks_bootstrapping",
           "simple_integers_bgvrns", "depth_bgvrns",
           "simple_integers_serial_bgvrns",
           "simple_integers", "depth_bfvrns", "depth_bfvrns_behz",
           "simple_integers_serial", "string_encoding",
           "threshold_fhe", "threshold_fhe_5p",
           "tckks_interactive_mp_bootstrapping",
           "tckks_interactive_mp_bootstrapping_chebyshev", "pre_buffer")
BINFHE = ("boolean", "boolean_methods", "boolean_multi_input",
          "boolean_truth_tables", "boolean_serial_binary",
          "boolean_serial_json", "eval_sign", "eval_flooring", "eval_decomp",
          "boolean_serial_binary_dynamic_large_precision",
          "boolean_serial_json_dynamic_large_precision", "scheme_switching")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the programs' tensors are small, and with the
    default thread count several test workers' threads thrash the CPU."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def check_transcript(name):
    want = (TRANSCRIPTS / f"{name}.txt").read_text()
    got = mask_tmp(run(name, "cpu"))
    assert got == want


@pytest.mark.parametrize("name", SCHEMES)
def test_transcript_equals_jax(name):
    check_transcript(name)


def test_every_jax_example_has_a_port_and_a_test():
    ported = sorted(p.stem for p in PORT_EXAMPLES.glob("*.py")
                    if not p.stem.startswith("_"))
    assert ported == JAX_EXAMPLES
    assert sorted(SCHEMES + BINFHE) == JAX_EXAMPLES
    assert sorted(p.stem for p in TRANSCRIPTS.glob("*.txt")) == JAX_EXAMPLES


@pytest.mark.parametrize("path", sorted(PORT_EXAMPLES.glob("*.py")),
                         ids=lambda p: p.name)
def test_examples_exec_no_file(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            assert node.func.id not in ("exec", "eval"), path.name


def test_no_device_argument_needs_a_card():
    """Without --device a program takes the current CUDA device; on a
    machine with none it raises and names the remedy."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "openfhe_tpu_torch.examples.boolean"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert 'device="cpu"' in proc.stderr
    assert proc.stdout == ""
