"""PyTorch/CUDA port of the reproduction's data plane.

A second package beside ``repro`` (the JAX reference): it imports
``torch`` and never ``jax`` or ``repro``. This slice serves the dense
family (``launch/serve.py::run_serving``) with hand-written CUDA kernels
for prefill and decode attention (``kernels/csrc/flash_attention.cu``).
"""
