"""Device mode's update streams (on the CPU, the device loop without
capture): the port's IncrementalEngine against the JAX package's
``mode="device"`` after every step, and against the port's own
device-mode batch runs. The streams, the reference and the checks are
``tests/test_torch_incremental.py``'s."""
import pytest

from test_torch_incremental import STREAMS, assert_stream_matches


@pytest.mark.parametrize("program", list(STREAMS))
def test_stream_matches_reference_and_batch_device_mode(program):
    assert_stream_matches(program, "device")
