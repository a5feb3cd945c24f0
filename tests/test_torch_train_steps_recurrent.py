"""Port parity of the zoo's train step for the recurrent and enc-dec
families (ssm, hybrid, audio); the dense, moe and vlm families, the gates
and the bound on the updated parameters are in
``tests/test_torch_train_steps.py``.  A file of its own so that the
``pytest -n N --dist loadfile`` runs the two halves on two workers.
"""
import pytest

from torch_zoo_parity import train_step_parity


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("family", ["ssm", "hybrid", "audio"])
def test_train_step_matches_reference(family, microbatches):
    train_step_parity(family, microbatches)
