"""@serve.deployment decorator, Deployment, Application (bound graphs)
(counterpart of `ray_tpu/serve/deployment.py`).

Parity: reference `python/ray/serve/api.py:248` (@deployment),
`serve/deployment.py:65` (Deployment.bind -> model composition via handle
DAGs). bind() captures init args; nested bound deployments become
DeploymentHandles at deploy time, which is how composition works.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig


@dataclasses.dataclass
class Application:
    """A bound deployment graph rooted at the ingress deployment."""

    root: "BoundDeployment"

    def walk(self):
        """Yield every unique BoundDeployment reachable from the root."""
        seen = {}
        stack = [self.root]
        while stack:
            node = stack.pop()
            if id(node) in seen:
                continue
            seen[id(node)] = node
            for arg in list(node.init_args) + list(node.init_kwargs.values()):
                if isinstance(arg, Application):
                    stack.append(arg.root)
                elif isinstance(arg, BoundDeployment):
                    stack.append(arg)
        return list(seen.values())


class BoundDeployment:
    def __init__(self, deployment: "Deployment", init_args, init_kwargs):
        self.deployment = deployment
        self.init_args = init_args
        self.init_kwargs = init_kwargs

    @property
    def name(self):
        return self.deployment.name


class Deployment:
    """The product of @serve.deployment (parity: serve/deployment.py)."""

    def __init__(self, func_or_class: Callable, name: str,
                 config: DeploymentConfig):
        self.func_or_class = func_or_class
        self.name = name
        self.config = config

    def options(self, *, name: Optional[str] = None,
                num_replicas: Optional[int] = None,
                max_ongoing_requests: Optional[int] = None,
                user_config: Any = None,
                autoscaling_config=None,
                ray_actor_options: Optional[dict] = None,
                health_check_period_s: Optional[float] = None,
                graceful_shutdown_timeout_s: Optional[float] = None,
                placement_group_bundles: Optional[list] = None,
                ) -> "Deployment":
        cfg = dataclasses.replace(self.config)
        if num_replicas is not None:
            if num_replicas == "auto":
                autoscaling_config = autoscaling_config or AutoscalingConfig(
                    min_replicas=1, max_replicas=100)
            else:
                cfg.num_replicas = num_replicas
        if max_ongoing_requests is not None:
            cfg.max_ongoing_requests = max_ongoing_requests
        if user_config is not None:
            cfg.user_config = user_config
        if autoscaling_config is not None:
            if isinstance(autoscaling_config, dict):
                autoscaling_config = AutoscalingConfig(**autoscaling_config)
            cfg.autoscaling_config = autoscaling_config
        if ray_actor_options is not None:
            cfg.ray_actor_options = dict(ray_actor_options)
        if health_check_period_s is not None:
            cfg.health_check_period_s = health_check_period_s
        if graceful_shutdown_timeout_s is not None:
            cfg.graceful_shutdown_timeout_s = graceful_shutdown_timeout_s
        if placement_group_bundles is not None:
            cfg.placement_group_bundles = [dict(b) for b in
                                           placement_group_bundles]
        return Deployment(self.func_or_class, name or self.name, cfg)

    def bind(self, *args, **kwargs) -> Application:
        return Application(BoundDeployment(self, args, kwargs))

    def __call__(self, *a, **kw):
        raise TypeError(
            f"Deployment {self.name} cannot be called directly; use "
            ".bind() and serve.run(), then handle.remote()")


def deployment(_func_or_class=None, *, name: Optional[str] = None,
               num_replicas=None, max_ongoing_requests: Optional[int] = None,
               user_config: Any = None, autoscaling_config=None,
               ray_actor_options: Optional[dict] = None,
               health_check_period_s: Optional[float] = None,
               graceful_shutdown_timeout_s: Optional[float] = None,
               placement_group_bundles: Optional[list] = None):
    """@serve.deployment decorator (parity: serve/api.py:248)."""

    def wrap(func_or_class):
        d = Deployment(
            func_or_class,
            name or getattr(func_or_class, "__name__", "deployment"),
            DeploymentConfig())
        return d.options(
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            user_config=user_config,
            autoscaling_config=autoscaling_config,
            ray_actor_options=ray_actor_options,
            health_check_period_s=health_check_period_s,
            graceful_shutdown_timeout_s=graceful_shutdown_timeout_s,
            placement_group_bundles=placement_group_bundles)

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap
