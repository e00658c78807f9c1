"""Host views of tensors for the safetensors writers — the part of
``deepspeed_tpu/utils/tree_io.py`` the port needs.

numpy has no bfloat16 and the port does not depend on ``ml_dtypes``, so a
bf16 tensor crosses to numpy as a ``uint16`` view of its bits, while its
safetensors dtype stays ``"BF16"``: a payload written here is byte for
byte the reference's (which holds bf16 as an ``ml_dtypes`` array).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

#: numpy dtype name -> safetensors dtype (``"bfloat16"`` covers a numpy
#: array of ml_dtypes' bfloat16 handed in by a caller that has it)
ST_DTYPES = {
    "float64": "F64", "float32": "F32", "float16": "F16",
    "bfloat16": "BF16",
    "int64": "I64", "int32": "I32", "int16": "I16", "int8": "I8",
    "uint64": "U64", "uint32": "U32", "uint16": "U16", "uint8": "U8",
    "bool": "BOOL",
}

#: safetensors dtype -> torch dtype (what a payload decodes into)
TORCH_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_ST_OF_TORCH = {v: k for k, v in TORCH_DTYPES.items()}


def host_array(x: Any) -> Tuple[np.ndarray, str]:
    """``(C-contiguous numpy array holding x's bytes, safetensors dtype)``
    for a numpy array or a torch tensor (copied to the host if it lies on
    the device; bf16 as a ``uint16`` view tagged ``"BF16"``)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        st = _ST_OF_TORCH.get(t.dtype)
        if st is None:
            raise TypeError(f"dtype {t.dtype} not representable in "
                            "safetensors")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.uint16)
        return t.numpy(), st
    arr = np.ascontiguousarray(x)
    st = ST_DTYPES.get(str(arr.dtype))
    if st is None:
        raise TypeError(f"dtype {arr.dtype} not representable in "
                        "safetensors")
    return arr, st


def host_arrays(arrays: Dict[str, Any]) -> Dict[str, Tuple[np.ndarray, str]]:
    """:func:`host_array` of every entry, in the dict's order."""
    return {name: host_array(x) for name, x in arrays.items()}
