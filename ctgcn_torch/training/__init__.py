# coding: utf-8
"""Training engine and the embedding-task driver."""
