"""The plain reference of the spectral pipeline: PyTorch and NumPy only.

It imports nothing of the port (``repro_torch``), of the JAX package or of
``jax``, and takes nothing the port made: it builds the graph again from the
points the benchmark made (:mod:`.graph`), solves its own eigenproblem
(:mod:`.eigen`) and runs its own k-means (:mod:`.kmeans`); :mod:`.judge`
reads the port's outputs only to judge them.  Every product goes through
:mod:`.precision`, so the whole reference runs in float64, float32, or TF32
(the control: the nearest precision below the configuration's float32).
"""
