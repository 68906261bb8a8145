# coding: utf-8
"""PyTorch/CUDA port of the CTGCN framework.

The port runs on an NVIDIA Hopper GPU by default.  Every entry point takes a
``device`` (``"cuda"`` unless the caller asks for ``"cpu"``); on a CUDA
tensor the block-sparse SpMM runs through the hand-written kernels in
``csrc/``, on a CPU tensor through their plain PyTorch versions.

Importing the package imports no JAX and nothing of ``ctgcn_tpu``, and
builds no kernel: the kernels compile at first use.  It does not import
torch either, so that worker processes which only format files (the
embedding CSV writer's) start quickly; ``resolve_device`` loads it.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from ctgcn_torch.utils import resolve_device

        return resolve_device
    raise AttributeError(f"module 'ctgcn_torch' has no attribute {name!r}")
