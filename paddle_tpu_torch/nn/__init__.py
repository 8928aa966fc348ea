"""``paddle_tpu_torch.nn``: the stock layer library of ``paddle_tpu.nn``
that the ported recipes stand on (the base ``Layer`` and containers,
linear, embedding, dropout, norms, convolutions and pools, the transformer
and recurrent families, the losses, their initializers and the functional
ops under them), and the gradient clips."""

from . import clip, functional, initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,  # noqa: F401
                   clip_grad_norm_, clip_grad_value_)
from .common_layers import (GELU, ChannelShuffle, Dropout, Embedding, Flatten,  # noqa: F401
                            Hardsigmoid, Hardswish, Identity, Linear, ReLU, ReLU6, Sigmoid,
                            Swish, Tanh, Upsample)
from .conv import (AdaptiveAvgPool2D, AvgPool2D, Conv1D, Conv2D,  # noqa: F401
                   Conv2DTranspose, MaxPool2D)
from .layers import Layer, LayerList, ParameterList, Sequential  # noqa: F401
from .loss import BCELoss, CrossEntropyLoss, CTCLoss, MSELoss  # noqa: F401
from .norm import BatchNorm, BatchNorm1D, BatchNorm2D, LayerNorm  # noqa: F401
from .rnn import GRU, LSTM, RNN, GRUCell, LSTMCell, SimpleRNN, SimpleRNNCell  # noqa: F401
from .transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                          TransformerDecoder, TransformerDecoderLayer, TransformerEncoder,
                          TransformerEncoderLayer)
