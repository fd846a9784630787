"""The resilience plane's reference tests, run against the port.

Each case runs one test file of the JAX package against the port, through
``tests/torch_redirect.py`` (an import finder maps ``ytk_mp4j_tpu.*`` onto
``ytk_mp4j_tpu_torch.*``), in a child interpreter with ``-m 'not slow'``.
A case passes when the inner run has no failure, passes at least the
count stated here, and its ``ytk_mp4j_tpu.comm.process_comm`` was the
port's. ``DESELECT`` lists what the inner run leaves out, one reason a
line: the case reaches JAX or a module outside this slice, it starts a
child interpreter (which runs the reference), or it is a timing test that
also fails in the reference's own runs.
"""

import pytest

from torch_redirect import check_reference_file

FILES = {
    "test_resilience": 55,
    "test_membership": 25,
    "test_autoscaler": 21,
}

DESELECT = {
    "test_autoscaler": [
        ("test_circuit_breaker_trips_after_two_failed_evictions",
         "a timing test that also fails in the reference's own runs"),
    ],
}


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_file_passes_on_the_port(name, tmp_path):
    check_reference_file(name, FILES[name], DESELECT.get(name, ()),
                         tmp_path)
