"""The serve plane's reference tests, run against the port.

``tests/test_serve.py`` runs against the port through
``tests/torch_redirect.py`` (an import finder maps ``ytk_mp4j_tpu.*`` onto
``ytk_mp4j_tpu_torch.*``), in a child interpreter with ``-m 'not slow'``.
The case passes when the inner run has no failure, passes at least the
count stated here, and its ``ytk_mp4j_tpu.comm.process_comm`` was the
port's. ``DESELECT`` lists what the inner run leaves out, one reason a
line; ``tests/test_torch_serve.py`` covers the GBDT family on the port.
"""

import pytest

from torch_redirect import check_reference_file

FILES = {"test_serve": 35}

_GBDT_REASON = ("_gbdt_servable trains through ytk_mp4j_tpu.parallel."
                "make_mesh, which the port lacks (its device.make_mesh "
                "refuses to train without CUDA unless asked for the CPU)")

DESELECT = {
    "test_serve": [
        (f"test_sharded_serve_bit_exact_grid[{n}-{t}-gbdt]", _GBDT_REASON)
        for n in (2, 4) for t in ("tcp", "shm")
    ] + [
        ("test_deadline_honored_under_slow_rank", _GBDT_REASON),
    ],
}


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_file_passes_on_the_port(name, tmp_path):
    check_reference_file(name, FILES[name], DESELECT.get(name, ()),
                         tmp_path)
