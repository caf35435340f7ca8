"""tiled_probe_roofline: K2's share of its roofline in the traced window,
in percent: the least time of every launch (``roofline.probe_least_work``
over the H100's published peaks) over the device time of the kernels the
wrapper launches (table fill and build, shared- or global-table probe)."""

from perfbench import roofline

KERNEL = "tiled_probe"
DEVICE_NAMES = ("probe_shared_table", "probe_global_table", "build_tables",
                "fill_tables")


def work(a_keys, b_keys):
    if not a_keys.numel() or not b_keys.numel():
        return None
    return roofline.probe_least_work(a_keys.numel(), b_keys.numel())


def read(ctx):
    return ctx.roofline(KERNEL, DEVICE_NAMES, exclusive_of=("tiled_probe3",))
