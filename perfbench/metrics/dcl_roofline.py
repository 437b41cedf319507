"""The DCL kernels' bound over their device time in the traced window,
in %: the bound of every DCL call the window's steps made
(``pb_yard.dcl_bound_s``) over the summed device time of the kernels of
the port's DCL libraries (``pb_yard.DCL_KERNEL_PREFIXES``)."""


def read(run):
    t = run.trace
    if t is None or t["dcl_s"] <= 0 or run.dcl_bound_s <= 0:
        return None
    return 100.0 * run.dcl_bound_s / t["dcl_s"]
