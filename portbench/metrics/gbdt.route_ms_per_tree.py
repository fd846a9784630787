"""gbdt.route_ms_per_tree: device ms a round of the work the trainer
launched inside its ``gbdt::route`` spans (each level's routing of every
row to its child node), over the traced window's rounds."""

from portbench.spans import phase_ms_per_tree


def read(run):
    return phase_ms_per_tree(run, "route")
