"""The port's driver for its example programs.

Each program module has ``main(device=None)`` and runs as
``python -m openfhe_tpu_torch.examples.<name> [--device cpu|cuda[:i]]``.
Without ``--device`` it runs on the current CUDA device and raises when
there is none (``_build.resolve_device``).
"""

import argparse
import contextlib
import importlib
import io
import os
import re
import tempfile
import traceback

from .._build import resolve_device


def device_from_argv(argv=None):
    """The ``--device`` argument of the command line; None means the current
    CUDA device."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu or cuda[:i]; default: the current CUDA device")
    dev = ap.parse_args(argv).device
    return resolve_device(dev)


def run(name: str, device) -> str:
    """Runs program `name` on `device` and returns its transcript: what it
    printed and, if it ended by an exception, the exception's last
    traceback line (``AssertionError: ...``), as ``transcript_of`` writes
    it for the JAX programs."""
    mod = importlib.import_module(f"{__package__}.{name}")
    return transcript_of(mod.main, device)


def transcript_of(fn, *args) -> str:
    """What fn(*args) prints, then the last traceback line of the exception
    it raised, if any."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            fn(*args)
    except Exception as e:  # the transcript records how the program ended
        buf.write(traceback.format_exception_only(e)[-1])
    return buf.getvalue()


def mask_tmp(text: str) -> str:
    """`text` with each directory made by ``tempfile.mkdtemp`` written as
    ``<tmpdir>``."""
    pat = re.escape(os.path.join(tempfile.gettempdir(), "")) + r"[^\s/]+"
    return re.sub(pat, "<tmpdir>", text)
