"""ray_tpu_torch.serve — online serving over actors.

Reference surface: Ray Serve (ray: python/ray/serve/ —
@serve.deployment classes, ServeController managing replica actors,
Router with power-of-two-choices replica scheduling, model composition
via DeploymentHandle, HTTP ingress). Minimum-viable parity: deployments
with N replica actors, least-of-two-queues routing, handle composition
through bind(), replica crash recovery, redeploy/scaling, and a small
JSON HTTP ingress. A copy of ray_tpu.serve on the port's runtime (thread
mode); the LLM deployments (serve/llm.py) hold the port's engine.
"""

from ray_tpu_torch.serve.core import (AdmissionShedError,  # noqa: F401
                                Application, AutoscalingConfig,
                                Deployment, DeploymentHandle, deployment,
                                get_app_handle, get_multiplexed_model_id,
                                multiplexed, run, serving_stats, shutdown,
                                start_grpc, start_http, status)

__all__ = [
    "deployment", "run", "shutdown", "status", "get_app_handle",
    "Deployment", "DeploymentHandle", "Application", "start_http",
    "AutoscalingConfig", "multiplexed", "get_multiplexed_model_id",
    "start_grpc", "AdmissionShedError", "serving_stats",
]
