"""``paddle_tpu_torch.nn`` (port of ``paddle_tpu.nn``): the base ``Layer``
and containers, the layer library (linear, embedding, dropouts,
activations, padding and resampling, norms, convolutions and pools, the
transformer and recurrent families, the losses, the long tail of
``layers_extras``), ``functional``, ``initializer``, ``utils``, the
gradient clips, ``ParamAttr`` and ``Parameter``."""

from . import clip, functional, initializer, utils  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,  # noqa: F401
                   clip_grad_norm_, clip_grad_value_)
from .layers import Layer, LayerList, ParameterList, Sequential  # noqa: F401
from .common_layers import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .layers_extras import *  # noqa: F401,F403

from ..framework.param_attr import ParamAttr  # noqa: F401
from ..framework.tensor import Parameter  # noqa: F401
