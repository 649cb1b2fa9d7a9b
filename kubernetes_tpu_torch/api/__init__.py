from kubernetes_tpu_torch.api.objects import Node, Pod  # noqa: F401
from kubernetes_tpu_torch.api.quantity import parse_quantity  # noqa: F401
