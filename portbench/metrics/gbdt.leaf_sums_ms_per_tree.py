"""gbdt.leaf_sums_ms_per_tree: device ms a round of the work the trainer
launched inside its ``gbdt::leaf_sums`` spans (the leaf sums, a float64
``index_add_``, and their fold), over the traced window's rounds."""

from portbench.spans import phase_ms_per_tree


def read(run):
    return phase_ms_per_tree(run, "leaf_sums")
