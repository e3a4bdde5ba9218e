from repro_torch.kernels.knn_topk.ops import knn_topk  # noqa: F401
from repro_torch.kernels.knn_topk.ref import knn_topk_ref  # noqa: F401
