"""Device idle in the traced window while the host launched the model's
work: a serving forward (``serve/forward``), or a training step's
forward and backward (``train/forward``, ``train/backward``), in % of
the window (``pb_spans.idle_share``)."""
import pb_spans


def read(run):
    return pb_spans.idle_share(
        run, {"serve/forward", "train/forward", "train/backward"})
