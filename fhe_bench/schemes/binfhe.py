"""BINFHE cells: a pool of batches of encrypted bit pairs made by the
benchmark, a request that evaluates one gate over a whole batch through the
port's ``models.binfhe.eval_gate_batch`` (one blind rotation, then the LWE
key switch), and a check of every output against the plain reference."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..reference import binfhe as ref
from ..harness import NOTHING
from ..tracing import op_span

# the configuration's keys and the program's BinFHEParams fields they state
_PARAMS = {"n_lwe": "n_lwe", "N": "N", "Q": "Q", "q": "q", "q_ks": "q_ks",
           "log_bg": "log_bg", "B_ks": "B_ks", "sigma": "sigma",
           "method": "method", "key_dist": "key_dist"}


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 parts, control=None):
        """With a `control` (the cell file's ``"control"``) the program runs
        with those parameters in place of the configuration's."""
        from openfhe_tpu_torch.models import binfhe
        self.binfhe, self.traffic, self.device = binfhe, traffic, device
        params = binfhe.PARAM_SETS[config["paramset"]]()
        stated = {k: getattr(params, f) for k, f in _PARAMS.items()}
        if stated != {k: config[k] for k in _PARAMS}:
            raise RuntimeError(f"the program's {config['paramset']} is not "
                               f"the configuration's: {stated}")
        if control:
            params = dataclasses.replace(params, **control)
        with parts("context"):
            self.ctx = binfhe.gen_context(params, device)
        q, n = params.q, params.n_lwe
        self.q, self.gate = q, traffic["gate"]
        rng = np.random.default_rng(seed)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        s_lwe, z_ring = ref.ternary(n, rng), ref.ternary(params.N, rng)
        self.s = torch.from_numpy(s_lwe).to(device)
        sk = binfhe.BinFHESecret(s_lwe, z_ring)
        with parts("keys"):
            self.bk = binfhe.bootstrap_keygen(self.ctx, sk, rng)
        pool, batch = traffic["pool"], traffic["batch"]
        with parts("inputs"):
            self.bits = torch.randint(0, 2, (pool, 2, batch), generator=gen,
                                      device=device, dtype=torch.int64)
            a, b = ref.encrypt(self.bits, self.s, q, params.sigma, gen)
            b = b.tolist()
            self.inputs = [[[binfhe.LWECiphertext(a[p, j, k], b[p][j][k], q)
                             for k in range(batch)] for j in range(2)]
                           for p in range(pool)]
        self.work_per_request = batch

    def request(self, i: int, trace: bool = False):
        cts1, cts2 = self.inputs[i % len(self.inputs)]
        with op_span("eval_gate_batch", trace):
            return self.binfhe.eval_gate_batch(self.ctx, self.gate, self.bk,
                                               cts1, cts2)

    def release(self):
        self.bk = self.inputs = None

    def check(self, outputs) -> dict:
        """outputs: [(request index, [LWECiphertext] * batch)]. Returns the
        gates that decrypt to the wrong bit (an exact count) and the widest
        phase error as a share of the q/8 margin."""
        wrong, worst = 0, 0.0
        for i, outs in outputs:
            p = i % self.bits.shape[0]
            want = ref.GATES[self.gate](self.bits[p, 0], self.bits[p, 1])
            if len(outs) != want.numel() or any(o.modulus != self.q
                                                for o in outs):
                return {"wrong_gates": want.numel(),
                        "phase_margin": NOTHING}
            a = torch.stack([o.a for o in outs]).to(self.device)
            b = torch.tensor([o.b for o in outs], device=self.device)
            ph = ref.phase(a, b, self.s, self.q)
            wrong += int((ref.decode(ph, self.q) != want).sum())
            worst = max(worst, float(ref.margin_share(ph, want, self.q)
                                     .max()))
        return {"wrong_gates": wrong, "phase_margin": worst}
