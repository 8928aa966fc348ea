"""paddle_tpu_torch — the PyTorch/CUDA counterpart of ``paddle_tpu``.

Module for module, this package mirrors ``paddle_tpu`` (same names, same
parameter names, same public tensor layouts) so each piece can be held
against its JAX original on identical weights.  Plain tensor code is
PyTorch; every Pallas kernel on a ported path becomes a CUDA kernel written
for Hopper (``kernels/csrc``), built with ``nvcc`` at first use.

Covered so far: the eager Paddle API — ``Tensor`` / ``to_tensor``, the op
namespace (``paddle_tpu_torch.add``, ``.matmul``, ...; the same ops as
Tensor methods), autograd on torch's tape (``backward``, ``grad``,
``no_grad``, ``autograd.PyLayer``), ``amp`` (``auto_cast``, ``decorate``,
``GradScaler``), ``io`` (datasets, samplers, ``DataLoader``) and
``save`` / ``load`` — so ``import paddle_tpu_torch as paddle`` runs a
dygraph program; the serving path — ``serving.Engine`` over
``models.llama.LlamaForCausalLM`` with the paged KV cache, and
``LlamaForCausalLM.generate`` — and the pretraining path: ``jit.TrainStep``
over ``compute_loss`` with ``optimizer.AdamW`` and the presets of
``models.presets``; the SSD family, ``models.ssd.SSDForCausalLM``, in
training and through the Engine's recurrent and hybrid paths; the
Mixture-of-Experts Llama (``incubate.moe``, the ``moe`` preset) in training
and serving; the rest of ``incubate``; the stock ``nn`` library with the
ERNIE and PP-OCR recipes; the high-level API (``Model`` fit / evaluate /
predict, ``callbacks``, ``metric``, ``summary``, ``flops``) and
``vision`` (models, transforms, datasets; not yet ``vision.ops``); the
whole of ``nn`` (``functional``, the layers, ``initializer``, ``utils``,
``ParamAttr``) with ``regularizer``, ``fft`` and ``signal``; the
compiled-graph layer: ``static`` (``Program``, ``Executor``, ``static.nn``),
``jit.to_static`` with fragment capture (``jit.capture``), ``jit.save`` /
``jit.load``, ``inference`` (``Config``, ``Predictor``) and
``amp.debugging``; the serving front end (``serving.router.Router``,
``serving.loadgen``) and ``LlamaForCausalLM.export_generate``; the
measuring surface: ``profiler``, ``device`` (with ``device.cuda``),
``version`` and ``sysconfig``.

Device policy: entry points take an explicit ``device``; when none is given
it is the one ``set_device`` chose, else ``"cuda"``, and a missing card
raises instead of running on the CPU.  ``set_device("cpu")`` asks for the
CPU.

The boundary: a ``Tensor`` is unwrapped where user code enters the port
(``nn.Layer.__call__``, the models' ``__call__``, ``compute_loss`` and
``generate``, the op namespace) and results come back as Tensors; inside,
layers, models, kernels, optimizers and ``TrainStep`` work on plain
``torch.Tensor`` / ``nn.Parameter``.
"""

from __future__ import annotations

# framework core: these names come first (the submodules import them from
# the package)
from .framework.dtype import DTYPES, to_dtype  # noqa: F401
from .framework.dtype import (  # noqa: F401
    bool_ as bool,  # noqa: A001
    bfloat16, complex128, complex64, float16, float32, float64, int16, int32, int64, int8,
    uint8, get_default_dtype, set_default_dtype,
)
from .framework.device import (  # noqa: F401
    default_device, device_count, get_device, is_compiled_with_tpu, set_device, synchronize,
)
from .framework.random import default_generator, make_generator, seed  # noqa: F401
from .framework.tensor import Parameter, Tensor, create_parameter, to_tensor  # noqa: F401
from .framework.autograd import (  # noqa: F401
    enable_grad, grad, is_grad_enabled, no_grad, set_grad_enabled,
)
from .framework.flags import get_flags, set_flags  # noqa: F401
from .framework.param_attr import ParamAttr  # noqa: F401

# the op namespace (this also installs the Tensor's methods)
from .ops import *  # noqa: F401,F403
from . import ops  # noqa: F401

# subsystems
from . import nn  # noqa: F401
from . import optimizer  # noqa: F401
from . import amp  # noqa: F401
from . import io  # noqa: F401
from . import jit  # noqa: F401
from . import autograd  # noqa: F401
from . import incubate  # noqa: F401
from . import linalg  # noqa: F401
from . import regularizer  # noqa: F401
from . import fft  # noqa: F401
from . import signal  # noqa: F401
from . import metric  # noqa: F401
from . import vision  # noqa: F401
from . import callbacks  # noqa: F401
from . import hapi  # noqa: F401
from .hapi import Model, flops, summary  # noqa: F401
from .framework.io import load, save  # noqa: F401
from . import static  # noqa: F401
from . import inference  # noqa: F401
from . import device  # noqa: F401
from . import profiler  # noqa: F401
from . import sysconfig  # noqa: F401
from . import version  # noqa: F401
from .version import full_version as __version__  # noqa: F401,E402
from .device import is_compiled_with_cuda  # noqa: F401
from .static import disable_static, enable_static  # noqa: F401

dtype = type(float32)


def in_dynamic_mode() -> bool:
    """True outside static mode (``enable_static``)."""
    return not static.in_static_mode()
