"""The benchmark's plain reference: graph reading, the k-core peel, the
random-walk tables, the model forwards, the U-neg loss and training with
``torch.optim.Adam``, in float32, in plain PyTorch, NumPy and SciPy.  It
imports nothing of the package under test."""
