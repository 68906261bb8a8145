# coding: utf-8
"""Graph file IO and per-window loaders."""
