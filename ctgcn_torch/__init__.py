# coding: utf-8
"""PyTorch/CUDA port of the CTGCN framework.

The port runs on an NVIDIA Hopper GPU by default.  Every entry point takes a
``device`` (``"cuda"`` unless the caller asks for ``"cpu"``); on a CUDA
tensor the block-sparse SpMM runs through the hand-written kernels in
``csrc/``, on a CPU tensor through their plain PyTorch versions.

Importing the package imports no JAX and nothing of ``ctgcn_tpu``, and
builds no kernel: the kernels compile at first use.
"""
from ctgcn_torch.utils import resolve_device

__all__ = ["resolve_device"]
