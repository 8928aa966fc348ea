"""Inference API: ``Config`` and ``Predictor`` over exported programs (port
of ``paddle_tpu/inference/__init__.py``).

The reference's ``paddle.inference`` (``AnalysisPredictor``,
``paddle_infer::Config``) runs an optimised program.  Here the artifact
``jit.save`` (or ``static.save_inference_model``) writes IS the program: a
``torch.export`` graph whose kernel entries are the port's custom ops, and
its weights.  The predictor loads it on the card (the ``Config`` default;
``disable_gpu()`` asks for the CPU), binds IO handles and runs it; the
kernels launch as in the eager forward.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..framework.tensor import Tensor
from ..jit import load as _jit_load

__all__ = ["Config", "Predictor", "create_predictor", "DataType", "PlaceType", "PrecisionType",
           "PredictorPool", "get_num_bytes_of_data_type", "get_version",
           "get_trt_compile_version", "get_trt_runtime_version", "convert_to_mixed_precision"]


class Config:
    """Reference-shaped ``paddle.inference.Config``: the artifact's prefix
    (``prog_file`` may carry a suffix) and the device, the card unless
    ``disable_gpu()``."""

    def __init__(self, prog_file: Optional[str] = None, params_file: Optional[str] = None):
        self._prefix = None
        if prog_file is not None:
            self._prefix = prog_file
            for suffix in (".pt2", ".pdmodel.json", ".pdmodel"):
                if self._prefix.endswith(suffix):
                    self._prefix = self._prefix[: -len(suffix)]
        self._device = "gpu:0"

    def set_prog_file(self, path):
        self.__init__(path)

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device = f"gpu:{device_id}"

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self) -> bool:
        return self._device != "cpu"

    def enable_memory_optim(self):
        pass   # the caching allocator owns buffers

    def switch_ir_optim(self, flag=True):
        pass   # the artifact is the program as exported

    def model_dir(self):
        return self._prefix


class _IOHandle:
    """An input or output handle (reference ZeroCopyTensor)."""

    def __init__(self, device=None):
        self._value = None
        self._device = device

    def copy_from_cpu(self, arr: np.ndarray):
        t = torch.as_tensor(np.asarray(arr))
        self._value = t if self._device is None else t.to(self._device)

    def reshape(self, shape):
        pass   # shapes come from the bound value

    def shape(self):
        return list(self._value.shape)

    def copy_to_cpu(self) -> np.ndarray:
        return Tensor._wrap(self._value).numpy()

    def share_external_data(self, tensor):
        self._value = tensor._data if isinstance(tensor, Tensor) else torch.as_tensor(tensor)


class Predictor:
    def __init__(self, config: Config):
        if config._prefix is None:
            raise ValueError("Config has no model path")
        self._fn = _jit_load(config._prefix, device=config._device)
        n_inputs = len(self._fn.meta["inputs"])
        dev = self._fn._program.device
        self._inputs = {f"input_{i}": _IOHandle(dev) for i in range(n_inputs)}
        self._outputs: List[_IOHandle] = []

    def get_input_names(self):
        return list(self._inputs.keys())

    def get_input_handle(self, name) -> _IOHandle:
        return self._inputs[name]

    def run(self):
        out = self._fn(*[h._value for h in self._inputs.values()])
        outs = out if isinstance(out, (list, tuple)) else [out]
        self._outputs = []
        for o in outs:
            h = _IOHandle()
            h._value = o._data if isinstance(o, Tensor) else torch.as_tensor(o)
            self._outputs.append(h)
        return True

    def get_output_names(self):
        return [f"output_{i}" for i in range(len(self._outputs))]

    def get_output_handle(self, name) -> _IOHandle:
        return self._outputs[int(name.split("_")[-1])]


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


# -- the reference's auxiliary surface -----------------------------------------

class DataType:
    """Reference ``paddle.inference.DataType``."""

    FLOAT32 = "float32"
    FLOAT16 = "float16"
    BFLOAT16 = "bfloat16"
    INT8 = "int8"
    INT32 = "int32"
    INT64 = "int64"
    UINT8 = "uint8"
    BOOL = "bool"


class PlaceType:
    """Reference ``PlaceType``: where a bound tensor lives."""

    kUNK = -1
    kCPU = 0
    kGPU = 1
    kXPU = 2
    kNPU = 3
    kCUSTOM = 4


class PrecisionType:
    """Reference ``PrecisionType``."""

    Float32 = 0
    Half = 1
    Bfloat16 = 2
    Int8 = 3


def get_num_bytes_of_data_type(dtype) -> int:
    name = dtype if isinstance(dtype, str) else str(dtype).replace("torch.", "")
    if name in ("bfloat16", "float16"):
        return 2
    return np.dtype(name).itemsize


def get_version() -> str:
    """The inference library's version string (reference ``get_version``)."""
    from .. import __version__

    return (f"paddle_tpu_torch-inference {__version__} (torch {torch.__version__}, "
            f"torch.export programs)")


def get_trt_compile_version():
    raise NotImplementedError("TensorRT is not part of the port; the serving path is the "
                              "exported program and Predictor")


def get_trt_runtime_version():
    get_trt_compile_version()


def convert_to_mixed_precision(model_file, params_file, mixed_model_file, mixed_params_file,
                               mixed_precision=None, backend=None, keep_io_types=True,
                               black_list=None, **kwargs):
    """Cast a saved artifact's floating weights to a mixed-precision dtype
    (reference ``convert_to_mixed_precision``) and copy the program."""
    import shutil

    from ..framework.io import load as _load
    from ..framework.io import save as _save

    state = _load(params_file)
    tgt = {None: torch.float16, PrecisionType.Half: torch.float16, "float16": torch.float16,
           "bfloat16": torch.bfloat16,
           PrecisionType.Bfloat16: torch.bfloat16}.get(mixed_precision, torch.float16)
    block = set(black_list or [])

    def cast(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = cast(v)
                continue
            d = v._data if isinstance(v, Tensor) else torch.as_tensor(np.asarray(v))
            out[k] = d.to(tgt) if k not in block and d.is_floating_point() else d
        return out

    _save(cast(state), mixed_params_file)
    if model_file != mixed_model_file:
        shutil.copy(model_file, mixed_model_file)
    return mixed_params_file


class PredictorPool:
    """Predictors over one Config (reference ``PredictorPool``)."""

    def __init__(self, config, size: int = 1):
        self._predictors = [Predictor(config) for _ in range(int(size))]

    def retrieve(self, idx: int):
        return self._predictors[idx]

    def __len__(self):
        return len(self._predictors)
