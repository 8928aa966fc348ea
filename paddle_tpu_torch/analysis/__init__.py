"""Analyzers of the port: :mod:`.kernel_lint`, the verifier of the
hand-written CUDA kernels, reporting through :mod:`.findings`."""

from .findings import Finding, Report

__all__ = ["Finding", "Report"]
