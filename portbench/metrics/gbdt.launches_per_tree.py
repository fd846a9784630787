"""gbdt.launches_per_tree: kernel-launch runtime calls in the traced
window (``cudaLaunchKernel*``, ``cuLaunchKernel*``) over its rounds."""


def read(run):
    trees = run.traced.get("trees")
    if not trees or run.trace is None:
        return None
    return len(run.trace.launches) / trees
