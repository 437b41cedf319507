"""The DCL kernels' device time over all device busy time in the traced
window, in %."""


def read(run):
    t = run.trace
    if t is None or t["dcl_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * t["dcl_s"] / t["busy_s"]
