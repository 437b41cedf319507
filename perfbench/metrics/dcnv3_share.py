"""The ``dv3_`` kernels' device time over all device busy time in the
traced window, in %."""


def read(run):
    t = run.trace
    if t is None or t.get("dv3_s", 0.0) <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * t["dv3_s"] / t["busy_s"]
