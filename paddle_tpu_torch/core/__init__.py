"""``paddle_tpu_torch.core``: the native host runtime (port of
``paddle_tpu/core``).

The compute path is PyTorch and the CUDA kernels of ``kernels/``; this
package is the C++ runtime around it: the DataLoader's shared-memory batch
channel, the control-plane ``TCPStore`` and the host tracer.  Sources live
in ``csrc/``; ``native.py`` builds them at first use and loads them through
ctypes.
"""

from .native import available, build, load

__all__ = ["available", "build", "load"]
