"""Device idle in the traced window while the serving engine built a
batch on the host and copied it to the device (``serve/batch``), in %
of the window (``pb_spans.idle_share``)."""
import pb_spans


def read(run):
    return pb_spans.idle_share(run, {"serve/batch"})
