"""ray_tpu_torch.serve — online model serving on the port's runtime
(counterpart of `ray_tpu.serve`; the control plane imports no torch).

Parity: reference `python/ray/serve/` (controller reconciliation loop,
replica FSM with rolling updates, pow-2 routing, HTTP proxy, queue-based
autoscaling, batching, multiplexing, handle-DAG composition).
"""

from ray_tpu_torch.serve.api import (  # noqa: F401
    delete,
    get_app_handle,
    get_deployment_handle,
    run,
    shutdown,
    status,
)
from ray_tpu_torch.serve.batching import batch  # noqa: F401
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig  # noqa: F401
from ray_tpu_torch.serve.grpc_proxy import (  # noqa: F401
    grpc_call,
    start_grpc_proxy,
    stop_grpc_proxy,
)
from ray_tpu_torch.serve.deployment import Application, Deployment, deployment  # noqa: F401
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse  # noqa: F401
from ray_tpu_torch.serve.multiplex import (  # noqa: F401
    get_multiplexed_model_id,
    multiplexed,
)
from ray_tpu_torch.serve.proxy import Request  # noqa: F401
