"""dist.exchange_ms_per_tree: device ms a round of the work launched
inside the program's ``dist::*`` spans on rank 0 (``dist::all_gather_rows``:
each level's histogram partials and the leaf sums gathered in rank order;
``dist::all_reduce``: the round's fixed-point scale), over the traced
window's rounds."""

from portbench.spans import device_s


def read(run):
    trees = run.traced.get("trees")
    spent = [device_s(run.trace, "dist::" + name)
             for name in ("all_gather_rows", "all_reduce")]
    if not trees or all(s is None for s in spent):
        return None
    return 1e3 * sum(s for s in spent if s is not None) / trees
