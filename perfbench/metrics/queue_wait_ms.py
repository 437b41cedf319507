"""The median, over the requests served ok, of the time from a
request's due time to the start of the engine step that took it, in
ms."""
import statistics


def read(run):
    if not run.queue_waits:
        return None
    return 1e3 * statistics.median(run.queue_waits)
