"""The port's BINFHE and scheme-switching example programs against the JAX
package's, transcript for transcript (``test_torch_examples.py`` says how;
this file runs on a test worker of its own)."""

import pytest

from test_torch_examples import BINFHE, check_transcript, one_thread  # noqa: F401


@pytest.mark.parametrize("name", BINFHE)
def test_transcript_equals_jax(name):
    check_transcript(name)
