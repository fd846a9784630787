"""hist_kernel_roofline: the least time of every histogram call in the
traced window (``roofline.hist_level_seconds``, each input at its least
width) over the device time of the work launched inside the trainer's
histogram call (``models.gbdt.build_histograms``: the kernel's passes and
its accumulator's fill)."""

from portbench import roofline


def read(run):
    calls = run.traced.get("hist_calls")
    if not calls or run.trace is None:
        return None
    spent = run.trace.range_device_s("histograms")
    if spent <= 0:
        return None
    cfg = run.ctx.config
    least = sum(roofline.hist_level_seconds(rows, valid, nodes,
                                            cfg["n_features"],
                                            cfg["n_bins"])
                for rows, valid, nodes in calls)
    return 100 * least / spent
