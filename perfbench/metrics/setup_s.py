"""setup_s: seconds from the start of the run to the window: imports,
kernel builds (the first run of a checkout), weights, warm-up and the
check's first steps (host clock)."""


def read(run):
    return run.setup_s
