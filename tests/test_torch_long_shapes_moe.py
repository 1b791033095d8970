"""``long_500k``'s decode across the ring's wrap for the MoE families,
against the reference: Granite-MoE-3B-a800m and OLMoE-1B-7B.  The cases
of ``test_torch_long_shapes.py`` (which says what is held) in a file of
their own, so that ``--dist loadfile`` puts them on another worker.
"""
import pytest

from test_torch_long_shapes import (RING, _one_thread,  # noqa: F401
                                    check_long_500k, jref)

CASES = [("granite-moe-3b-a800m", RING), ("olmoe-1b-7b", RING)]


@pytest.mark.parametrize("arch,window", CASES)
def test_long_500k_decode_across_the_wrap_matches_reference(jref, arch,
                                                           window):
    check_long_500k(jref, arch, window)
