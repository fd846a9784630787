"""gbdt.splits_ms_per_tree: device ms a round of the work the trainer
launched inside its ``gbdt::splits`` spans (each level's sibling
subtraction, best splits, freeze and the tree's table writes), over the
traced window's rounds."""

from portbench.spans import phase_ms_per_tree


def read(run):
    return phase_ms_per_tree(run, "splits")
