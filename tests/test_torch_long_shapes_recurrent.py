"""``long_500k``'s decode across the ring's wrap for the families with a
recurrent state, against the reference: Hymba-1.5B (its ring of 8 and
its Mamba state) and xLSTM-1.3B (no window; its mLSTM and sLSTM
states).  The cases of ``test_torch_long_shapes.py`` (which says what is
held) in a file of their own, so that ``--dist loadfile`` puts them on
another worker.
"""
import pytest

from test_torch_long_shapes import (RING, _one_thread,  # noqa: F401
                                    check_long_500k, jref)

CASES = [("hymba-1.5b", RING), ("xlstm-1.3b", 0)]


@pytest.mark.parametrize("arch,window", CASES)
def test_long_500k_decode_across_the_wrap_matches_reference(jref, arch,
                                                           window):
    check_long_500k(jref, arch, window)
