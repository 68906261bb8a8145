# coding: utf-8
"""Multi-device training on ``torch.distributed`` (port of
``ctgcn_tpu/parallel/``): one process a GPU, launched by ``torchrun``.

  * ``dist``: the process group from torchrun's environment, the parts a
    run splits into, and the collectives with their gradients (the
    pipeline's ring shift among them);
  * ``graph_partition``: the row-partitioned SpMM, all-gather and halo
    exchange, and the halo GCN forward (config ``graph_partition``);
  * ``core_partition``: the row-partitioned k-core pyramid and the halo
    CGCN / CTGCN forward (config ``graph_partition``);
  * ``mesh``: time sharding of every method (config ``n_devices``) and
    the gradient rule of every partitioned path;
  * ``pipeline``: GPipe over time for CTGCN's time RNN (config
    ``temporal_pipeline``).
"""
