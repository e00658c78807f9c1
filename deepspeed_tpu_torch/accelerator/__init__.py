from .cuda_accelerator import CudaAccelerator
from .real_accelerator import get_accelerator, resolve_device

__all__ = ["CudaAccelerator", "get_accelerator", "resolve_device"]
