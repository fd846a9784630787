"""gbdt.hist_ms_per_tree: device ms a round of the work the trainer
launched inside its ``gbdt::histograms`` spans (each level's left-child
ids and its call of ``models.gbdt.build_histograms``: the kernel's
passes and its accumulator's fill), over the traced window's rounds."""

from portbench.spans import phase_ms_per_tree


def read(run):
    return phase_ms_per_tree(run, "histograms")
