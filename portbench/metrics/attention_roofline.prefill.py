"""attention_roofline.prefill: the attention kernels against their roofline over the traced
window, forward calls (``kernels.attention_share``)."""
from portbench import kernels


def read(run):
    return kernels.attention_share(run, "prefill")
