"""idle_share.train: the share of the traced window in which the device ran
nothing (``kernels.idle_share``)."""
from portbench import kernels


def read(run):
    return kernels.idle_share(run, "train")
