"""The port's op-level FLOP count of a train step (forward, remat
recompute, backward and the AdamW update) against the reference's HLO
count, one smoke config per family: ``tests/test_torch_op_analysis.py``
holds the rule and the serving steps."""

from __future__ import annotations

import pytest

pytest.importorskip("torch")

from test_torch_op_analysis import (FAMILIES,  # noqa: E402
                                    check_against_the_reference)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_dot_flops_match_the_reference_hlo(arch):
    check_against_the_reference(arch, "train")
