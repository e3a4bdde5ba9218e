from repro_torch.kernels.kmeans_iter.ops import kmeans_iter  # noqa: F401
from repro_torch.kernels.kmeans_iter.ref import kmeans_iter_ref  # noqa: F401
