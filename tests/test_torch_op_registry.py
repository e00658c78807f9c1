"""Parity: the port's op registry (``deepspeed_tpu_torch.ops.op_registry``)
against the JAX package's: the same op names, the same errors, each entry
loading the port's module (``async_io`` the ctypes binding of
``csrc/aio/ds_aio.cpp``); and the CUDA accelerator's ``create_op_builder``
over it."""

import pytest

from deepspeed_tpu.ops import op_registry as jreg
from deepspeed_tpu_torch.accelerator.cuda_accelerator import CudaAccelerator
from deepspeed_tpu_torch.ops import op_registry as treg

# the port module each op loads
MODULES = {"evoformer_attn": "deepspeed_tpu_torch.ops.evoformer",
           "grouped_gemm": "deepspeed_tpu_torch.ops.hopper.grouped_matmul",
           "flash_attention": "deepspeed_tpu_torch.ops.hopper.flash_attention",
           "fused_adam": "deepspeed_tpu_torch.ops.fused_optimizers",
           "quantizer": "deepspeed_tpu_torch.ops.quantizer",
           "paged_attention": "deepspeed_tpu_torch.ops.hopper.paged_attention",
           "async_io": "deepspeed_tpu_torch.nvme.aio_handle"}


def test_names_equal_the_reference():
    jreg._ensure_builtin_ops()
    treg._ensure_builtin_ops()
    assert sorted(treg._REGISTRY) == sorted(jreg._REGISTRY)
    assert sorted(treg._REGISTRY) == sorted(MODULES)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_each_op_loads_the_port_module(name):
    entry = treg.get_op_builder(name)
    assert entry.name == name and entry.is_compatible("cuda")
    assert entry.load().__name__ == MODULES[name]
    assert entry.module == MODULES[name]


def test_unknown_op_raises_the_reference_error():
    with pytest.raises(KeyError) as want:
        jreg.get_op_builder("no_such_op")
    with pytest.raises(KeyError) as got:
        treg.get_op_builder("no_such_op")
    assert str(got.value) == str(want.value)


def test_async_io_refuses_and_is_not_available():
    """Until the ctypes binding was ported (ROADMAP.md A3) ``async_io``
    refused; now it loads the binding, whose handle writes and reads back
    through the built library, and every op is available, as in the
    reference."""
    import numpy as np

    aio = treg.get_op_builder("async_io").load()
    assert aio.aio_available()
    assert set(treg.available_ops()) == set(MODULES)
    assert set(treg.available_ops()) == set(jreg.available_ops())
    buf = np.arange(4096, dtype=np.uint8)
    back = np.zeros_like(buf)
    with aio.AsyncIOHandle(thread_count=1) as h:
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            path = f"{d}/blob"
            assert h.sync_pwrite(path, buf) == buf.nbytes
            assert h.sync_pread(path, back) == buf.nbytes
    assert np.array_equal(buf, back)


def test_create_op_builder_on_the_cuda_accelerator():
    entry = CudaAccelerator().create_op_builder("evoformer_attn")
    assert entry is treg.get_op_builder("evoformer_attn", "cuda")
    assert entry.load().__name__ == MODULES["evoformer_attn"]
    with pytest.raises(KeyError, match="unknown op"):
        CudaAccelerator().create_op_builder("no_such_op")
