"""The DCNv3 kernels' bound over their device time in the traced window,
in %: the bound of every DCNv3 call the window's steps made
(``pb_iimg.dcnv3_bound_s``) over the summed device time of the ``dv3_``
kernels (``pb_iimg.dv3_time``)."""


def read(run):
    t = run.trace
    bound = getattr(run, "dcnv3_bound_s", 0.0)
    if t is None or t.get("dv3_s", 0.0) <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t["dv3_s"]
