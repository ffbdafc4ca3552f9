"""A run with its timed path broken underneath must come out not correct:
the harness is driven as a run drives it (set-up, warm-up, window, check),
on the CPU at toy sizes, with one fault planted in the program for each
fault the cell can have. One chip, so no exchange between chips to leave
out."""

from __future__ import annotations

import time

import pytest

from fhe_bench import harness, toy


def _run(workload):
    return harness.run_cell(toy.cell(workload), 2 ** 33 + 1, 0.3, False,
                            "cpu", time.perf_counter())


def test_sound_runs_are_correct():
    for workload in ("ckks-d20-mult-rotate", "binfhe-std128-and-b4096"):
        assert _run(workload)["correct"]


def _ckks_unchanged_rotation(monkeypatch):
    from openfhe_tpu_torch.models import ckks
    monkeypatch.setattr(ckks, "eval_rotate", lambda ct, rot, key: ct)


def _ckks_altered_answer(monkeypatch):
    from openfhe_tpu_torch.models import ckks
    real = ckks.eval_rotate

    def altered(ct, rot, key):
        out = real(ct, rot, key)
        c0 = out.polys[0]
        data = c0.data.clone()
        data[1, 7] = (data[1, 7] + 1) % c0.basis.moduli[1]
        return ckks.Ciphertext((c0.with_data(data),) + out.polys[1:],
                               out.scale)

    monkeypatch.setattr(ckks, "eval_rotate", altered)


def _binfhe_unchanged_rotation(monkeypatch):
    from openfhe_tpu_torch.models import binfhe
    monkeypatch.setattr(binfhe, "_blind_rotate_cggi",
                        lambda ctx, ek, acc, a_t: acc)


def _binfhe_half_batch(monkeypatch):
    from openfhe_tpu_torch.models import binfhe
    real = binfhe.eval_gate_batch

    def half(ctx, gate, bk, cts1, cts2):
        h = len(cts1) // 2
        outs = real(ctx, gate, bk, cts1[:h], cts2[:h])
        return outs + outs[:len(cts1) - h]

    monkeypatch.setattr(binfhe, "eval_gate_batch", half)


def _binfhe_altered_answer(monkeypatch):
    from openfhe_tpu_torch.models import binfhe
    real = binfhe.eval_gate_batch

    def altered(ctx, gate, bk, cts1, cts2):
        outs = real(ctx, gate, bk, cts1, cts2)
        o = outs[3]
        outs[3] = binfhe.LWECiphertext(o.a, (o.b + o.modulus // 4)
                                       % o.modulus, o.modulus)
        return outs

    monkeypatch.setattr(binfhe, "eval_gate_batch", altered)


FAULTS = [("ckks-d20-mult-rotate", _ckks_unchanged_rotation),
          ("ckks-d20-mult-rotate", _ckks_altered_answer),
          ("binfhe-std128-and-b4096", _binfhe_unchanged_rotation),
          ("binfhe-std128-and-b4096", _binfhe_half_batch),
          ("binfhe-std128-and-b4096", _binfhe_altered_answer)]


@pytest.mark.parametrize("workload,plant", FAULTS,
                         ids=[f.__name__.strip("_") for _, f in FAULTS])
def test_a_planted_fault_is_not_correct(monkeypatch, workload, plant):
    plant(monkeypatch)
    result = _run(workload)
    assert not result["correct"], result["compared"]
