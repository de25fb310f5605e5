"""Seconds a node waits for one device validation: the window over the
validations it completed."""


def read(run):
    return run.window_s / run.steps if run.steps else None
