"""gbdt.hist_row_passes: the passes the histogram kernel made over its
rows in the traced window (the program's ``histograms.row_passes``
counter, one a group of cells a launch) over its launches
(``histograms.launches``). 1 where one node's cells fit a block (F = 28);
more where a node's cells take several groups, each a pass."""


def read(run):
    return run.traced.get("hist_row_passes")
