"""CPU numerics for tests that hold a data-sharded run against the flat
one: the rows of a shard must round as the same rows of the whole batch
do."""
import contextlib

import torch


@contextlib.contextmanager
def rows_round_alike():
    """CPU convolutions that round a row alike at any batch and in any
    call: oneDNN picks its algorithm by batch size, and with several
    intra-op threads a batch-1 convolution's backward rounds otherwise in
    a process's first call of a shape than in later ones.  Off both, a
    data shard's rows round as the same rows of the whole batch do, and
    the shards change only the order the gradients are summed in."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            yield
    finally:
        torch.set_num_threads(threads)
