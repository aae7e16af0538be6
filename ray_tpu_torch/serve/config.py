"""Serve configuration schemas
(counterpart of `ray_tpu/serve/config.py`).

Parity: reference `python/ray/serve/config.py` / `serve/schema.py`
(AutoscalingConfig, DeploymentConfig pydantic models) — plain dataclasses
here; validation is explicit and cheap.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

DEFAULT_HTTP_PORT = 8000
CONTROLLER_NAME = "_SERVE_CONTROLLER"
PROXY_NAME = "_SERVE_PROXY"


@dataclasses.dataclass
class AutoscalingConfig:
    """Queue-depth-driven autoscaling (parity: serve/config.py AutoscalingConfig,
    policy in serve/_private/autoscaling_policy.py)."""

    min_replicas: int = 1
    max_replicas: int = 1
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 3.0
    downscale_delay_s: float = 30.0
    upscale_smoothing_factor: float = 1.0
    downscale_smoothing_factor: float = 1.0
    initial_replicas: Optional[int] = None
    # Admission-shed-driven scale-UP (the serving plane's overload
    # signal, `ray_tpu_serve_shed_total{pool=...}`): when reporters
    # attribute >= this many sheds/second (sustained over
    # shed_window_s) to this deployment, the controller targets one
    # more replica — bounded by max_replicas and paced by
    # upscale_delay_s like any other upscale decision. None = off.
    upscale_shed_rate: Optional[float] = None
    shed_window_s: float = 5.0

    def __post_init__(self):
        if self.min_replicas < 0 or self.max_replicas < max(1, self.min_replicas):
            raise ValueError(
                "need 0 <= min_replicas <= max_replicas and max_replicas >= 1")
        if self.target_ongoing_requests <= 0:
            raise ValueError("target_ongoing_requests must be > 0")
        if self.upscale_shed_rate is not None and self.upscale_shed_rate <= 0:
            raise ValueError("upscale_shed_rate must be > 0 (or None)")
        if self.shed_window_s <= 0:
            raise ValueError("shed_window_s must be > 0")


@dataclasses.dataclass
class DeploymentConfig:
    """Per-deployment behavior knobs (parity: serve DeploymentConfig)."""

    num_replicas: int = 1
    max_ongoing_requests: int = 100
    user_config: Any = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    health_check_period_s: float = 2.0
    health_check_timeout_s: float = 30.0
    graceful_shutdown_timeout_s: float = 5.0
    ray_actor_options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # A placement group per replica (parity: the reference's deployment
    # option of this name), its bundles packed on one node (STRICT_PACK):
    # the controller reserves them before it starts a replica, the
    # replica actor runs in bundle 0 (its ray_actor_options must fit
    # there) and the group goes with the replica; the replica places
    # what it starts in the other bundles. None = no group.
    placement_group_bundles: Optional[list] = None

    def target_initial_replicas(self) -> int:
        ac = self.autoscaling_config
        if ac is None:
            return self.num_replicas
        if ac.initial_replicas is not None:
            return max(ac.min_replicas, min(ac.initial_replicas, ac.max_replicas))
        return max(ac.min_replicas, min(1, ac.max_replicas))


@dataclasses.dataclass
class ReplicaInfo:
    """What a router needs to know about one live replica."""

    replica_id: str
    actor_name: str
    max_ongoing_requests: int


@dataclasses.dataclass
class DeploymentTarget:
    """Controller -> router snapshot for one deployment (one long-poll unit).

    Parity: serve `_private/common.py` DeploymentTargetInfo pushed via
    LongPollHost (`_private/long_poll.py:204`).
    """

    app_name: str
    deployment_name: str
    replicas: list  # [ReplicaInfo]
    version: int
