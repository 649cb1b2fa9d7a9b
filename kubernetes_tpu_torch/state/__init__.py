from kubernetes_tpu_torch.state.layout import Capacities, Resource  # noqa: F401
from kubernetes_tpu_torch.state.cluster_state import (  # noqa: F401
    ClusterState,
    NodeTable,
    encode_nodes,
)
from kubernetes_tpu_torch.state.pod_batch import (  # noqa: F401
    PodBatch,
    encode_cluster,
    encode_pods,
)
