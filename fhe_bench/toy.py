"""Toy cells for the CPU tests: the benchmark's two traffic mixes at sizes
a test run holds (CKKS at n = 4096 over 4 + 2 towers of the cell's widths; the TOY gate set, a
batch of 16)."""

from __future__ import annotations

import copy

from . import harness

CKKS_CONFIG = {
    "scheme": "ckks", "ring_dim": 4096, "mult_depth": 3,
    "first_mod_size": 60, "scaling_mod_size": 59, "dnum": 2, "sigma": 3.19,
    "secret": "UNIFORM_TERNARY", "security_level": "HEStd_NotSet",
    "scaling_technique": "FIXEDMANUAL",
    "q_moduli": [1152921504606904321, 576460752303415297, 576460752303439873,
                 576460752303210497],
    "p_moduli": [1152921504606830593, 1152921504606748673]}

BINFHE_CONFIG = {
    "scheme": "binfhe", "paramset": "TOY", "n_lwe": 32, "N": 256,
    "Q": 134221313, "q": 512, "q_ks": 16384, "log_bg": 10, "B_ks": 32,
    "sigma": 3.19, "method": "GINX", "key_dist": "TERNARY"}


def cell(workload: str, root=harness.ROOT) -> harness.CellSpec:
    """The benchmark's cell `workload` with its configuration swapped for
    the toy one of its scheme and a smaller pool or batch."""
    spec = harness.resolve(workload, root)
    spec = copy.deepcopy(spec)
    if spec.config["scheme"] == "ckks":
        spec.config = dict(CKKS_CONFIG)
        spec.traffic["pool"] = 2
    else:
        spec.config = dict(BINFHE_CONFIG)
        spec.traffic["batch"] = 16
    return spec
