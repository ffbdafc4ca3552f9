"""The port's driver entry points against ``__graft_entry__.py``.

``entry()``: both packages build the flagship step's inputs from the same
seed (n = 2^12, depth 3, dnum 2); the inputs, the port's step on its own
inputs and the port's step on the JAX inputs (carried over by
``openfhe_tpu_torch.convert``) must all equal the JAX step's output, bit
for bit. The JAX step runs jitted, as ``__graft_entry__.entry()`` is meant
to run (op by op the JAX side took 166 s on an 8-core CPU, jitted 102 s,
most of it the one compile).

``dryrun_multichip(n)``: n gloo ranks, each a process of its own, run the
step at n = 256 unrouted and routed through the distributed four-step NTT
and find the two equal.
"""

import jax
import pytest
import torch

import __graft_entry__ as jentry
from openfhe_tpu_torch import convert, entry


@pytest.fixture(scope="module")
def steps():
    jfn, jargs = jentry.entry()
    jout = jax.jit(jfn)(*jargs)
    fn, args = entry.entry("cpu")
    ct1, ct2, evk = (convert.ciphertext_from_jax(jargs[0], "cpu"),
                     convert.ciphertext_from_jax(jargs[1], "cpu"),
                     convert.kskey_from_jax(jargs[2], "cpu"))
    return dict(jargs=jargs, jout=jout, args=args, out=fn(*args),
                carried=fn(ct1, ct2, evk))


def _same_ct(jct, tct):
    want = convert.ciphertext_from_jax(jct, "cpu")
    return (jct.scale == tct.scale and len(want.polys) == len(tct.polys)
            and all(w.basis.moduli == t.basis.moduli
                    and torch.equal(w.data, t.data)
                    for w, t in zip(want.polys, tct.polys)))


def test_entry_inputs_equal_jax(steps):
    jct1, jct2, jevk = steps["jargs"]
    ct1, ct2, evk = steps["args"]
    assert _same_ct(jct1, ct1) and _same_ct(jct2, ct2)
    k = convert.kskey_from_jax(jevk, "cpu")
    assert k.params == evk.params
    assert torch.equal(k.b, evk.b) and torch.equal(k.a, evk.a)


@pytest.mark.parametrize("inputs", ["own", "carried"])
def test_entry_step_equals_jax(steps, inputs):
    out = steps["out" if inputs == "own" else "carried"]
    assert out.towers == steps["jout"].towers == 3
    assert _same_ct(steps["jout"], out)


@pytest.mark.parametrize("n_devices", [2, 4])
def test_dryrun_multichip_on_gloo(n_devices, capsys):
    entry.dryrun_multichip(n_devices, "cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"dryrun_multichip: ok on {n_devices} devices")
    assert line.endswith("four-step distributed NTT bit-equal")

