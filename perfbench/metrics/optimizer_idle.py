"""Device idle in the traced window while the Trainer updated the params
(``train/optimizer``: the error-feedback compression, if any, and the
optimizer's update), in % of the window (``pb_spans.idle_share``)."""
import pb_spans


def read(run):
    return pb_spans.idle_share(run, {"train/optimizer"})
