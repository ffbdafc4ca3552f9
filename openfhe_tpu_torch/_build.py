"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

The sources are compiled on first use into one shared library with a plain
C interface (no PyTorch headers, so a build takes seconds). Every source is
compiled by its own nvcc, all started together, and the objects are linked:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
         -fPIC -Xptxas -v -c -o build/<name>_<hash>.o csrc/<name>.cu
    nvcc -shared -o build/libopenfhe_tpu_torch_<hash>.so build/*_<hash>.o

ptxas' report of registers, shared memory and spills for each kernel is kept
beside the library as ``build/libopenfhe_tpu_torch_<hash>.log``.

The library lands in ``openfhe_tpu_torch/build/`` under a name that carries
the hash of the sources and flags, so an edited source is rebuilt and a
stale library is never loaded. Each C entry point takes raw device
pointers and a CUDA stream, launches on that stream without synchronising,
and returns ``cudaGetLastError()``; ``check`` turns a non-zero code into an
exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of every exported function (pointers and the stream as void*,
# so ctypes never truncates them to 32 bits)
_SIGNATURES = {
    "ntt_forward": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "ntt_inverse": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "ntt_small_forward": [_P, _P, _I, _I, _I, _P, _P, _P, _P],
    "ntt_small_inverse": [_P, _P, _I, _I, _I, _P, _P, _P, _P],
    "ks_inner_product": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "fused_mac_mod": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P],
}

_LIB: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the nvcc run, if one ran


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(path)


def _sources() -> list:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libopenfhe_tpu_torch_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list) -> str:
    """Run the commands together; their combined output, or raise on the
    first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> Path:
    """Compile csrc/*.cu into the hashed library unless it already exists."""
    global build_seconds
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem.rsplit('_', 1)[1]}.{os.getpid()}"
    units = [(src, BUILD_DIR / f"{src.stem}_{tag}.o")
             for src in _sources() if src.suffix == ".cu"]
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    nvcc_bin = nvcc()
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc_bin, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                        for src, obj in units])
        log += _run_all([[nvcc_bin, "-shared", "-o", str(tmp),
                          *[str(obj) for _, obj in units]]])
    finally:
        for _, obj in units:
            obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    so.with_suffix(".log").write_text(log)
    os.replace(tmp, so)
    return so


def bench_library(name: str) -> ctypes.CDLL:
    """``bench/<name>.cu`` built on its own into a shared library beside the
    kernel library (not part of it), under a name that carries its hash,
    and loaded."""
    src = SRC_DIR.parent / "bench" / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + src.read_bytes())
    so = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        _run_all([[nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   str(src)]])
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the CUDA kernels need a CUDA device")
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device. None means the current CUDA device: the
    port runs on the card unless the caller asks for the CPU, and never falls
    back to it by itself."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device: the port runs on the card by default; pass '
            'device="cpu" to run the plain PyTorch twins on the CPU')
    return torch.device("cuda", torch.cuda.current_device())


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Kernel inputs must be contiguous int64 CUDA tensors on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: the kernel takes CUDA tensors on one "
                             f"device, got {t.device}")
        if t.dtype != torch.int64:
            raise ValueError(f"{name}: the kernel takes int64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
