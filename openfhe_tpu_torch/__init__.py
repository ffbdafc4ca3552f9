"""openfhe_tpu_torch — the PyTorch/CUDA port of ``openfhe_tpu``.

Residues are ``int64`` tensors ``[..., L, n]`` holding the reduced residue in
``[0, q)`` for moduli up to 61 bits. Plain tensor code is PyTorch; the
forward/inverse negacyclic NTT and the keyswitch multiply-accumulate are
hand-written CUDA kernels (``csrc/``) built on first use by ``_build``.
Each kernel wrapper launches its kernel for a CUDA tensor and runs a plain
PyTorch twin of the same function for a CPU tensor.

The package imports nothing of ``openfhe_tpu``: the host-only helpers
(``utils.nbtheory``, ``utils.sampling``, ``utils.security``, ``encoding``)
are its own copies. Entry points that take a ``device`` place tensors on the
current CUDA device unless the caller asks for another (``device="cpu"``)
and raise when there is none.
"""
