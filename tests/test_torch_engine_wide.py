"""The port's Engine against the JAX Engine on the wide (multi-word key)
programs, with the arrangement layer on and off, and on TC under
force_multiword() in both packages."""
import pytest

from test_torch_engine import assert_port_matches

WIDE = ["WideReach", "WideReach2", "WideJoin", "WideAgg"]


@pytest.mark.parametrize("arrangements", [True, False])
@pytest.mark.parametrize("program", WIDE)
def test_engine_wide_matches_reference(program, arrangements):
    assert_port_matches(program, arrangements)


def test_engine_force_multiword_matches_reference():
    assert_port_matches("TC", multiword=True)
