"""gbdt.tree_mfu: the least time the cell's cards need for one boosting
round (``roofline.tree_seconds``: its bytes at the HBM rate) over the
measured round, the traced window's length over the rounds it holds."""


def read(run):
    trees = run.traced.get("trees")
    if not trees or run.trace is None:
        return None
    return 100 * run.traced["least_tree_s"] / (run.trace.window_s / trees)
