"""ray_tpu_torch.serve: model serving over the in-process runtime (the
serve control plane of ray_tpu.serve for one process).

Importing it starts no thread, opens no socket and imports no ``grpc``:
``run`` starts the controller, ``start_http_proxy`` the HTTP ingress,
``start_front_door`` the epoch-routed ingresses, ``start_grpc_proxy`` the
gRPC ingress (it needs ``grpc``), and ``DeploymentAutoscaler.start`` the SLO
autoscaler's loop.
"""

from ray_tpu_torch.serve.admission import AdmissionConfig, AdmissionGate
from ray_tpu_torch.serve.api import (delete, get_deployment_handle, run, shutdown,
                                     start_grpc_proxy, start_http_proxy, status)
from ray_tpu_torch.serve.autoscale import DeploymentAutoscaler
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.controller import DeploymentHandle
from ray_tpu_torch.serve.deployment import (Application, AutoscalingConfig, Deployment,
                                            deployment)
from ray_tpu_torch.serve.front_door import (EpochCache, EpochKVRouter, EpochRouter, FrontDoor,
                                            IngressActor, front_door_addresses,
                                            front_door_view, start_front_door,
                                            stop_front_door)
from ray_tpu_torch.serve.llm import build_llm_deployment
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.openai_api import build_openai_app

__all__ = ["run", "delete", "status", "shutdown", "start_http_proxy", "start_grpc_proxy",
           "get_deployment_handle", "deployment", "Application", "AutoscalingConfig",
           "Deployment", "DeploymentHandle", "build_openai_app", "build_llm_deployment",
           "batch", "multiplexed", "get_multiplexed_model_id", "DeploymentAutoscaler",
           "AdmissionConfig", "AdmissionGate", "start_front_door", "stop_front_door",
           "front_door_addresses", "front_door_view", "FrontDoor", "IngressActor",
           "EpochRouter", "EpochKVRouter", "EpochCache"]
