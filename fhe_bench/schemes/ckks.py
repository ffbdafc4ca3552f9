"""CKKS cells: a pool of encrypted operand tuples made by the benchmark, a
request that runs the traffic's operations on one tuple through the port's
``models.ckks``, and a check of sampled outputs against the plain
reference."""

from __future__ import annotations

import numpy as np
import torch

from ..reference import ckks as ref
from ..harness import NOTHING, log
from ..tracing import op_span

# the configuration's secret distribution as the program's CKKSParams states
# it (its key generation is not used: the benchmark makes the secret)
_SECRET_HW = {"UNIFORM_TERNARY": 0}


class Cell:
    """Set-up builds the context from the configuration, keys from the
    benchmark's own secret, and the operand pool; ``request(i)`` runs on
    pool entry i mod the pool's size. With a `control` (the cell file's
    ``"control"``, ``{"slots": "complex64"}``) a request is served by the
    plain reference in the program's place, its slots computed in that
    lower precision and encrypted as the program's output would be."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 parts, control=None):
        from openfhe_tpu_torch import dcrt
        from openfhe_tpu_torch.models import ckks
        self.ckks, self.traffic, self.device = ckks, traffic, device
        params = ckks.CKKSParams(
            ring_dim=config["ring_dim"], mult_depth=config["mult_depth"],
            scaling_mod_size=config["scaling_mod_size"],
            first_mod_size=config["first_mod_size"], dnum=config["dnum"],
            sigma=config["sigma"], secret_hw=_SECRET_HW[config["secret"]],
            security_level=config["security_level"],
            scaling_technique=config["scaling_technique"])
        with parts("context"):
            self.ctx = ckks.gen_context(params, device)
        if (list(self.ctx.q_moduli) != config["q_moduli"]
                or list(self.ctx.p_moduli) != config["p_moduli"]):
            raise RuntimeError("the program's modulus chain is not the "
                               "configuration's")
        n = params.ring_dim
        self.n, self.q_moduli = n, tuple(config["q_moduli"])
        rng = np.random.default_rng(seed)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        secret = ref.ternary(n, rng)
        self.ref = ref.Scheme(n, self.q_moduli, self.ctx.scale, secret,
                              params.sigma, device)
        sk = ckks.SecretKey(secret)
        rots = sorted(self._rotations(traffic["ops"]))
        with parts("keys"):
            self.evk = ckks.relin_keygen(self.ctx, sk, rng)
            self.rot_keys = ckks.rot_keygen(self.ctx, sk, rots, rng)
        pool, k = traffic["pool"], traffic["operands"]
        with parts("inputs"):
            self.z = ref.unit_disk(pool * k, n // 2, gen, device)
            c0, c1 = self.ref.encrypt(self.z, gen)
        basis = self.ctx.basis()
        self.inputs = [
            [ckks.Ciphertext((dcrt.RnsPoly(c0[i * k + j], basis,
                                           dcrt.Format.EVAL),
                              dcrt.RnsPoly(c1[i * k + j], basis,
                                           dcrt.Format.EVAL)),
                             self.ctx.scale) for j in range(k)]
            for i in range(pool)]
        self.work_per_request = 1
        if control:
            self.gen, self.dtype = gen, getattr(torch, control["slots"])
            self.request = self._control_request

    @staticmethod
    def _rotations(ops):
        return {int(op[1]) for op in ops if op[0] == "rotate"}

    def request(self, i: int, trace: bool = False):
        ckks, xs, acc = self.ckks, self.inputs[i % len(self.inputs)], None
        for op in self.traffic["ops"]:
            name, args = op[0], op[1:]
            val = [acc if a == "acc" else xs[int(a[1:])] for a in args
                   if isinstance(a, str)]
            with op_span(name, trace):
                if name == "mult_relin":
                    acc = ckks.eval_mult_relin(val[0], val[1], self.evk)
                elif name == "rescale":
                    acc = ckks.rescale_ctx(self.ctx, acc)
                elif name == "rotate":
                    acc = ckks.eval_rotate(acc, int(args[0]),
                                           self.rot_keys[int(args[0])])
                else:
                    raise ValueError(f"unknown CKKS operation {name!r}")
        return acc

    def release(self):
        """Drop the program's state before the reference runs."""
        self.evk = self.rot_keys = self.inputs = None

    def expected(self, i: int, dtype=torch.complex128):
        pool, k = len(self.z) // self.traffic["operands"], \
            self.traffic["operands"]
        p = i % pool
        return ref.expected(self.traffic["ops"], self.z[p * k:(p + 1) * k],
                            self.ctx.scale, len(self.q_moduli),
                            self.q_moduli, dtype)

    def check(self, outputs) -> dict:
        """outputs: [(request index, ciphertext)]. Returns the numbers
        compared: coefficients whose towers disagree (an exact count) and
        the root mean square of the slot errors against the reference (the
        widest slot error is logged beside them)."""
        mismatch, sq, count, worst = 0, 0.0, 0, 0.0
        for i, ct in outputs:
            want, scale, towers = self.expected(i)
            if (len(ct.polys) != 2 or ct.basis.moduli
                    != self.q_moduli[:towers]):
                return {"tower_mismatch": self.n * towers,
                        "slot_rms_err": NOTHING}
            c0, c1 = (p.data.to(self.device) for p in ct.polys)
            centered = self.ref.decrypt(c0, c1)
            mismatch += int((centered != centered[:1]).any(0).sum())
            err = (self.ref.decode(centered[0], scale) - want).abs()
            sq += float((err ** 2).sum())
            count += err.numel()
            worst = max(worst, float(err.max()))
        log(f"widest slot error {worst!r}")
        return {"tower_mismatch": mismatch,
                "slot_rms_err": (sq / count) ** 0.5}

    def _control_request(self, i: int, trace: bool = False):
        """The control's request: the reference's slots in the lower
        precision, encrypted at the scale and towers of the program's
        output, so the run's own check judges them."""
        from openfhe_tpu_torch import dcrt
        want, scale, towers = self.expected(i, self.dtype)
        c0, c1 = self.ref.encrypt(want[None], self.gen, towers, scale)
        basis = self.ctx.basis(towers)
        return self.ckks.Ciphertext(
            (dcrt.RnsPoly(c0[0], basis, dcrt.Format.EVAL),
             dcrt.RnsPoly(c1[0], basis, dcrt.Format.EVAL)), scale)
