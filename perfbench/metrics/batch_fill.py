"""Requests served over the rows the window's engine steps offered
(steps x slots), in %."""


def read(run):
    if run.steps == 0 or run.slots == 0:
        return None
    return 100.0 * run.rows / (run.steps * run.slots)
