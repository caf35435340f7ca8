"""partition_hist_roofline: K1's share of its roofline in the traced
window, in percent: the least time of every launch
(``roofline.hist_least_work`` over the H100's published peaks) over the
device time of its register and shared/global-bin kernels."""

from perfbench import roofline

KERNEL = "partition_hist"
DEVICE_NAMES = ("hist_registers", "hist_bins")


def work(dest, *, nd, valid=None):
    if not dest.numel() or nd <= 0:
        return None
    return roofline.hist_least_work(dest.numel(), nd, valid is not None)


def read(ctx):
    return ctx.roofline(KERNEL, DEVICE_NAMES)
