"""mfu.prefill: the model FLOPs of the traced window's prefill batches over the window's
length, as a share of one H100's bf16 peak (989 TFLOP/s) (``kernels.step_mfu``)."""
from portbench import kernels


def read(run):
    return kernels.step_mfu(run, "prefill")
