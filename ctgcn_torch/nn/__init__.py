# coding: utf-8
"""Models: dense layers and the CTGCN family."""
