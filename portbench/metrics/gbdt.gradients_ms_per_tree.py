"""gbdt.gradients_ms_per_tree: device ms a round of the work the trainer
launched inside its ``gbdt::gradients`` spans (g and h from the margins
and weights, and the round's set-up tensors: member ids, zeroed node
ids, the tree's tables), over the traced window's rounds."""

from portbench.spans import phase_ms_per_tree


def read(run):
    return phase_ms_per_tree(run, "gradients")
