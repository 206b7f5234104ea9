"""Each fault the caption cell can have, planted under the timed path of
a run at a CPU size (the look for a card skipped), turns `correct` false;
the same run without it is correct."""

from __future__ import annotations

import pytest

from benchmark.controls.caption import FAULTS, planted
from benchmark.entries import caption_beam
from benchmark.tests import tiny


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_caption_cell_faults(fault):
    with planted(fault):
        out = caption_beam.run(tiny.ctx(tiny.caption_cell()))
    assert out["correct"] is (fault is None), out["checks"]
