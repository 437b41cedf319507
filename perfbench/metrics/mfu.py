"""Model FLOPs of the window's work over the window and the card's
dense bf16 peak, in %: served images' forward FLOPs, or a training
step's (forward and backward, three forwards) for every image of the
steps completed."""
import pb_yard


def read(run):
    if run.window_s <= 0 or run.images == 0:
        return None
    flops = run.images * run.flops_per_image
    return 100.0 * flops / run.window_s / pb_yard.PEAK_BF16_FLOPS
