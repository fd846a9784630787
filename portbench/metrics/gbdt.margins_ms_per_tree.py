"""gbdt.margins_ms_per_tree: device ms a round of the work the trainer
launched inside its ``gbdt::margins`` spans (the leaf values, each row's
leaf value gathered and added to the margins), over the traced window's
rounds."""

from portbench.spans import phase_ms_per_tree


def read(run):
    return phase_ms_per_tree(run, "margins")
