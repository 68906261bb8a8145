# coding: utf-8
"""Device ops: BSR SpMM kernels, core pyramids, RNN cells."""
