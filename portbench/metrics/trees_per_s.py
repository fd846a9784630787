"""trees_per_s: boosting rounds the window completed, over its length
(the loop, then the wait for the device to finish the last round)."""


def read(run):
    trees = run.window.get("trees")
    return None if not trees else trees / run.window["seconds"]
