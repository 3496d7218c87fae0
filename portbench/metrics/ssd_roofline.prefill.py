"""ssd_roofline.prefill: the SSD scan's kernels against their roofline over the traced
window, forward calls (``kernels.ssd_share``)."""
from portbench import kernels


def read(run):
    return kernels.ssd_share(run, "prefill")
