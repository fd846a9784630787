"""The ``mp4j-lint`` analyzer's reference tests, run against the port.

Each case runs one test file of the JAX package against the port's
``analysis/``, through ``tests/torch_redirect.py`` (an import finder maps
``ytk_mp4j_tpu.*`` onto ``ytk_mp4j_tpu_torch.*``), in a child interpreter
with ``-m 'not slow'``. A case passes when the inner run has no failure,
passes at least the count stated here (the reference's own run of the
file passes the same count), and its ``ytk_mp4j_tpu.comm.process_comm``
was the port's. Those files write snippets and trees under
``ytk_mp4j_tpu/...`` paths; the port's analyzer takes both package names
as roots (``analysis.report.PACKAGE_ROOTS``), so they run unchanged and
nothing is deselected.
"""

import pytest

from torch_redirect import check_reference_file

FILES = {
    "test_analysis_rules": 150,
    "test_concurrency_analysis": 72,
    "test_lockset_analysis": 16,
}


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_file_passes_on_the_port(name, tmp_path):
    check_reference_file(name, FILES[name], (), tmp_path)
