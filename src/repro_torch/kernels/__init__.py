"""Hand-written CUDA kernels for Hopper, one package per TPU kernel of the
reference, each with the reference's three-file layout: ``ref.py`` (plain
PyTorch version), ``ops.py`` (wrapper: padding and dispatch by the tensor's
device), ``kernel.py`` (ctypes binding of ``csrc/<name>.cu``)."""
