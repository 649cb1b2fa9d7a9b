from kubernetes_tpu_torch.scheduler.driver import Scheduler  # noqa: F401
