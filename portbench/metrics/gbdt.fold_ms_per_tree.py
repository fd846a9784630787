"""gbdt.fold_ms_per_tree: device ms a round of the work the trainer
launched inside its ``gbdt::fold`` spans (each level's rank-order fold
of the members' histogram partials), over the traced window's rounds."""

from portbench.spans import phase_ms_per_tree


def read(run):
    return phase_ms_per_tree(run, "fold")
