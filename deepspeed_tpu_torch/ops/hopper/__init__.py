"""Hand-written Hopper kernels (CUDA C++ sources in ``csrc/``) and their
Python wrappers — the port's counterpart of ``deepspeed_tpu/ops/pallas``."""
