"""PyTorch/CUDA port of the spectral-clustering pipeline in :mod:`repro`.

Same three stages and the same public names as the JAX package, module for
module (``repro_torch.core.spectral`` mirrors ``repro.core.spectral`` and so
on), written as plain functions on ``torch`` tensors.  The three kernels on
the main path (``knn_topk``, ``ell_spmm``, ``kmeans_iter``) are CUDA C++ for
Hopper under ``csrc/``, built with ``nvcc`` at first use
(:mod:`repro_torch.kernels._build`); on CPU tensors each wrapper runs its
plain PyTorch version instead.

Entry points (``SpectralPipeline`` and the data loaders) run on ``cuda``
unless the caller passes ``device="cpu"``; without a card they raise.  On
the card they turn TF32 off for matmuls and convolutions
(:func:`repro_torch._device.resolve_device`): label parity rests on fp32
distances.
"""
