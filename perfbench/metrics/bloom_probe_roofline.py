"""bloom_probe_roofline: K5's share of its roofline, in percent, over the
traced window's first launches: the least time of each
(``roofline.bloom_probe_least_work``, which depends on the keys' data, so
it is counted once the window has closed) over the device time of the
``bloom_probe_kernel`` it launched."""

import torch

from perfbench import roofline

KERNEL = "bloom_probe"
DEVICE_NAMES = ("bloom_probe_kernel",)
#: One device kernel a launch, read in launch order.
PAIRED = True


def work(keys, words, *, k):
    flat = keys.reshape(-1)
    if not flat.numel():
        return None
    return lambda: roofline.bloom_probe_least_work(flat.to(torch.int32),
                                                   words, k)


def read(ctx):
    return ctx.roofline(KERNEL, DEVICE_NAMES)
