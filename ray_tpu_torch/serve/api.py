"""serve public API: run / delete / status / shutdown / handles
(counterpart of `ray_tpu/serve/api.py`, on the port's runtime).

Parity: reference `python/ray/serve/api.py` (serve.run:591, serve.delete,
serve.status, serve.shutdown, get_deployment_handle/get_app_handle).
"""

from __future__ import annotations

import inspect
import time

import ray_tpu_torch
from ray_tpu_torch.core.serialization import dumps_code
from ray_tpu_torch.core.status import RayTpuError
from ray_tpu_torch.serve.config import CONTROLLER_NAME, DEFAULT_HTTP_PORT
from ray_tpu_torch.serve.controller import ServeController
from ray_tpu_torch.serve.deployment import Application, BoundDeployment
from ray_tpu_torch.serve.handle import DeploymentHandle


def _get_or_create_controller(http_port=DEFAULT_HTTP_PORT):
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        pass
    return ray_tpu_torch.remote(ServeController).options(
        name=CONTROLLER_NAME, num_cpus=0).remote(http_port)


def _get_controller():
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        raise RayTpuError("Serve is not running (no controller); call serve.run")


def run(app: Application, *, name: str = "default",
        route_prefix: str | None = "/", http_port: int = DEFAULT_HTTP_PORT,
        blocking_timeout_s: float = 60.0, _blocking: bool = True,
        local_testing_mode: bool = False) -> DeploymentHandle:
    """Deploy an application and return a handle to its ingress deployment.

    local_testing_mode=True runs every deployment in-process with no
    cluster, controller, or HTTP proxy (parity:
    serve/_private/local_testing_mode.py) — unit-test an app's composition
    logic with plain function calls."""
    if not isinstance(app, Application):
        raise TypeError("serve.run takes an Application (deployment.bind(...))")
    if local_testing_mode:
        from ray_tpu_torch.serve.local_testing import run_local
        return run_local(app)
    controller = _get_or_create_controller(http_port)

    deployments = {}
    for bound in app.walk():
        # Composition: bound-deployment init args become handles.
        def swap(v):
            if isinstance(v, Application):
                return DeploymentHandle(name, v.root.name)
            if isinstance(v, BoundDeployment):
                return DeploymentHandle(name, v.name)
            return v
        init_args = tuple(swap(a) for a in bound.init_args)
        init_kwargs = {k: swap(v) for k, v in bound.init_kwargs.items()}
        target = bound.deployment.func_or_class
        call = (target if not inspect.isclass(target)
                else getattr(target, "__call__", None))

        def _is_gen(fn):
            return fn is not None and (inspect.isgeneratorfunction(fn)
                                       or inspect.isasyncgenfunction(fn))
        # Streaming modes (parity: serve/_private/proxy.py:420 generator
        # path): a generator __call__ ALWAYS streams; a __stream__ method
        # streams per request (SSE accept header / {"stream": true} body).
        if _is_gen(call):
            streaming = "always"
        elif (inspect.isclass(target)
              and _is_gen(getattr(target, "__stream__", None))):
            streaming = "opt-in"
        else:
            streaming = ""
        deployments[bound.name] = {
            # by value through cloudpickle where it is installed, else by
            # reference: the deployment class must then be importable
            "def_blob": dumps_code(bound.deployment.func_or_class),
            "init_args_blob": dumps_code((init_args, init_kwargs)),
            "config": bound.deployment.config,
            "streaming": streaming,
        }
    ray_tpu_torch.get(controller.deploy_application.remote(
        name, route_prefix, app.root.name, deployments), timeout=30)
    handle = DeploymentHandle(name, app.root.name)
    if _blocking:
        _wait_running(controller, name, blocking_timeout_s)
    return handle


def _wait_running(controller, app_name, timeout_s):
    # Paced by the shared backoff policy (core/retry.py), not a fixed
    # 100ms poll — many clients waiting out one controller deploy should
    # not arrive in lockstep.
    from ray_tpu_torch.core.retry import Backoff
    bo = Backoff(base_s=0.05, cap_s=0.5, deadline_s=timeout_s)
    while True:
        st = ray_tpu_torch.get(controller.get_status.remote(), timeout=10)
        app = st.get(app_name)
        if app is not None and app["status"] == "RUNNING":
            return
        if not bo.sleep():
            break
    raise TimeoutError(
        f"application {app_name!r} did not reach RUNNING in {timeout_s}s: "
        f"{ray_tpu_torch.get(controller.get_status.remote(), timeout=10)}")


def status() -> dict:
    """Cluster-wide serve status (parity: serve.status)."""
    try:
        controller = _get_controller()
    except RayTpuError:
        return {}
    return ray_tpu_torch.get(controller.get_status.remote(), timeout=10)


def delete(name: str, *, blocking_timeout_s: float = 30.0):
    from ray_tpu_torch.core.retry import Backoff
    controller = _get_controller()
    ray_tpu_torch.get(controller.delete_application.remote(name), timeout=10)
    bo = Backoff(base_s=0.05, cap_s=0.5, deadline_s=blocking_timeout_s)
    while True:
        if name not in ray_tpu_torch.get(controller.get_status.remote(), timeout=10):
            return
        if not bo.sleep():
            raise TimeoutError(f"application {name!r} did not delete")


def get_deployment_handle(deployment_name: str, app_name: str = "default"
                          ) -> DeploymentHandle:
    return DeploymentHandle(app_name, deployment_name)


def get_app_handle(app_name: str = "default") -> DeploymentHandle:
    controller = _get_controller()
    st = ray_tpu_torch.get(controller.get_status.remote(), timeout=10)
    if app_name not in st:
        raise ValueError(f"no serve application named {app_name!r}")
    return DeploymentHandle(app_name, st[app_name]["ingress"])


def shutdown():
    """Tear down all applications and the controller/proxy."""
    try:
        controller = _get_controller()
    except RayTpuError:
        return
    try:
        ray_tpu_torch.get(controller.graceful_shutdown.remote(), timeout=30)
    except RayTpuError:
        pass
    try:
        ray_tpu_torch.kill(controller)
    except Exception:
        pass
    from ray_tpu_torch.serve.config import PROXY_NAME
    try:
        ray_tpu_torch.kill(ray_tpu_torch.get_actor(PROXY_NAME))
    except Exception:
        pass
