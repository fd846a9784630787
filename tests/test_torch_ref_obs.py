"""The observability plane's reference tests, run against the port.

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
    "test_metrics": 48,
    "test_sink": 28,
    "test_audit": 39,
    "test_tuner": 38,
    "test_obs": 11,
    "test_health": 35,
    "test_fleet": 13,
}

DESELECT = {
    "test_health": [
        ("test_chaos_slow_rank_reaches_suspect_within_bound",
         "a timing test that also fails in the reference's own runs"),
    ],
    "test_fleet": [
        ("test_fleet_two_real_jobs_shared_host_then_sigkill",
         "its jobs run in child interpreters of _JOB_DRIVER, whose imports "
         "load ytk_mp4j_tpu.comm.master outside the redirect: they would "
         "run the reference; tests/test_torch_fleet.py runs the same case "
         "on the port"),
    ],
}


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_file_passes_on_the_port(name, tmp_path):
    check_reference_file(name, FILES[name], DESELECT.get(name, ()),
                         tmp_path)
