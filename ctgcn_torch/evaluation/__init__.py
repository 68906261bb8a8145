# coding: utf-8
"""The five evaluation tasks (link prediction, node and edge
classification, centrality and similarity prediction), without pandas,
scikit-learn or networkx: they read the exported embedding CSVs and write
the JAX package's split, data and record files."""
