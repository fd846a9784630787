"""setup_s: seconds from the process's start to the window's first item
(imports, the kernels' build where the cache lacks them, the inputs made,
the program built and warmed up)."""


def read(run):
    return run.setup_s
