"""ray_tpu_torch.serve: model serving over the in-process runtime (the
serve control plane of ray_tpu.serve for one process).

Importing it starts no thread and opens no socket: ``run`` starts the
controller, ``start_http_proxy`` the HTTP ingress.
"""

from ray_tpu_torch.serve.api import (delete, get_deployment_handle, run, shutdown,
                                     start_http_proxy, status)
from ray_tpu_torch.serve.controller import DeploymentHandle
from ray_tpu_torch.serve.deployment import (Application, AutoscalingConfig, Deployment,
                                            deployment)
from ray_tpu_torch.serve.llm import build_llm_deployment
from ray_tpu_torch.serve.openai_api import build_openai_app

__all__ = ["run", "delete", "status", "shutdown", "start_http_proxy", "get_deployment_handle",
           "deployment", "Application", "AutoscalingConfig", "Deployment", "DeploymentHandle",
           "build_openai_app", "build_llm_deployment"]
