"""``paddle.version`` (port of ``paddle_tpu/version``; reference
``python/paddle/version.py``): static version fields, and the versions of
the accelerator stack torch was built with.  The JAX package's
``jax_version`` has no counterpart: the port never imports JAX."""

import torch

full_version = "3.0.0-cuda"
major = "3"
minor = "0"
patch = "0"
rc = "0"

commit = "cuda-port"
with_pip_cuda_libraries = "ON" if torch.version.cuda else "OFF"

__all__ = ["full_version", "major", "minor", "patch", "rc", "show", "commit",
           "cuda", "cudnn", "nccl", "xpu", "cinn", "tensorrt"]


def cuda() -> str:
    """The CUDA version torch was built with, or ``"False"``."""
    return torch.version.cuda or "False"


def cudnn() -> str:
    """cuDNN's version as ``major.minor.patch``, or ``"False"``."""
    if not torch.backends.cudnn.is_available():
        return "False"
    v = torch.backends.cudnn.version()
    base = 10000 if v >= 10000 else 1000    # cuDNN 9 counts majors in 10000s
    return f"{v // base}.{v % base // 100}.{v % 100}"


def nccl() -> str:
    """NCCL's version, or ``"False"`` where torch has no NCCL."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_nccl_available()):
        return "False"
    return ".".join(map(str, torch.cuda.nccl.version()))


def xpu() -> str:
    return "False"


def cinn() -> str:
    return "False"


def tensorrt() -> str:
    return "False"


def show() -> None:
    print(f"full_version: {full_version}")
    print(f"commit: {commit}")
    print(f"torch: {torch.__version__}")
    print(f"cuda: {cuda()}")
    print(f"cudnn: {cudnn()}")
    print(f"backend: {'cuda' if torch.cuda.is_available() else 'cpu'}")
