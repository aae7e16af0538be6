"""gRPC ingress for Serve
(counterpart of `ray_tpu/serve/grpc_proxy.py`).

Parity: reference `python/ray/serve/_private/proxy.py` gRPC side (the
proxy serves user-defined gRPC services next to HTTP). Design departure:
the reference compiles user protos into the proxy; here a
GenericRpcHandler accepts ANY unary-unary method and routes by the
method's service path — `/<app_name>/<method_name>` — handing the raw
request bytes to the deployment. Apps that speak protobuf decode their
own messages (bytes in, bytes/str out); plain-python clients can use the
pickle-based `grpc_call` helper.
"""

from __future__ import annotations

import pickle
from concurrent import futures

import ray_tpu_torch

PICKLE_METHOD = "__pickle__"


class _GenericHandler:
    """grpc.GenericRpcHandler routing every unary call into serve."""

    HANDLE_TTL_S = 10.0

    def __init__(self, allow_pickle: bool):
        import threading
        import grpc
        self._grpc = grpc
        self._allow_pickle = allow_pickle
        # app -> (handle, fetched_at); bounded by the number of REAL apps
        # (unknown apps abort before caching)
        self._handles: dict = {}
        self._hlock = threading.Lock()

    def _handle_for(self, app: str):
        import time
        from ray_tpu_torch.serve.api import get_app_handle
        now = time.monotonic()
        with self._hlock:
            hit = self._handles.get(app)
            if hit is not None and now - hit[1] < self.HANDLE_TTL_S:
                return hit[0]
        handle = get_app_handle(app)  # raises for unknown apps
        with self._hlock:
            self._handles[app] = (handle, now)
        return handle

    def service(self, handler_call_details):
        grpc = self._grpc
        path = handler_call_details.method  # "/<app>/<method>"
        try:
            _, app, method = path.split("/", 2)
        except ValueError:
            return None

        def unary_unary(request: bytes, context):
            from ray_tpu_torch.core.status import RayTpuError
            # Gates abort OUTSIDE the handler try: context.abort raises to
            # unwind, and a blanket except would re-abort it as INTERNAL.
            if method == PICKLE_METHOD and not self._allow_pickle:
                context.abort(
                    grpc.StatusCode.PERMISSION_DENIED,
                    "pickle route disabled (start_grpc_proxy("
                    "allow_pickle=True) enables it for trusted "
                    "networks only)")
                return b""
            try:
                handle = self._handle_for(app)
            except (KeyError, ValueError, RayTpuError) as e:
                context.abort(grpc.StatusCode.NOT_FOUND,
                              f"no serve app {app!r}: {e}")
                return b""
            try:
                if method == PICKLE_METHOD:
                    args, kwargs = pickle.loads(request)
                    out = handle.remote(*args, **kwargs).result(timeout_s=60)
                    return pickle.dumps(out)
                target = (handle if method == "__call__"
                          else getattr(handle, method))
                out = target.remote(request).result(timeout_s=60)
                if isinstance(out, bytes):
                    return out
                if isinstance(out, str):
                    return out.encode()
                return pickle.dumps(out)
            except Exception as e:  # noqa: BLE001 — surface to the client
                context.abort(grpc.StatusCode.INTERNAL, repr(e))
                return b""

        # Handlers are NOT cached: the closure is cheap to build and a
        # cache keyed by client-supplied paths would grow without bound.
        return grpc.unary_unary_rpc_method_handler(
            unary_unary,
            request_deserializer=None,   # raw bytes through
            response_serializer=None)


class _RoutingServicer:
    """Stands in for the user's Servicer when their generated
    `add_XServicer_to_server` mounts onto the proxy: every service method
    becomes a route into a Serve deployment (parity: the reference's
    `grpc_servicer_functions`, serve/_private/proxy.py:1131). The gRPC
    runtime decodes requests with the USER's proto classes before the
    handler runs, so deployments receive and return real message objects
    — no hand-decoding of bytes anywhere.

    App selection: the `application` request-metadata key, defaulting to
    Serve's "default" app (same convention as the reference)."""

    def __init__(self, handler: "_GenericHandler"):
        self._h = handler

    def __getattr__(self, method_name: str):
        if method_name.startswith("_"):
            raise AttributeError(method_name)
        h = self._h
        grpc = h._grpc

        def call(request, context):
            from ray_tpu_torch.core.status import RayTpuError
            md = dict(context.invocation_metadata())
            app = md.get("application", "default")
            try:
                handle = h._handle_for(app)
            except (KeyError, ValueError, RayTpuError) as e:
                context.abort(grpc.StatusCode.NOT_FOUND,
                              f"no serve app {app!r}: {e}")
                return None
            try:
                out = getattr(handle, method_name).remote(
                    request).result(timeout_s=60)
            except Exception as e:  # noqa: BLE001 — surface to client
                context.abort(grpc.StatusCode.INTERNAL, repr(e))
                return None
            if not hasattr(out, "SerializeToString"):
                # Clear abort beats the runtime's opaque 'Exception
                # serializing response!' when a method returns a
                # non-proto value.
                context.abort(
                    grpc.StatusCode.INTERNAL,
                    f"deployment method {method_name!r} returned "
                    f"{type(out).__name__}, not a protobuf message")
                return None
            return out

        return call


class _MountServer:
    """Shim handed to the user's add_XServicer_to_server: validates that
    every mounted method is unary-unary (the routing servicer cannot
    represent streaming RPCs — rejecting at mount time beats an opaque
    call-time failure) and forwards everything else to the real server."""

    def __init__(self, server):
        self._server = server

    def add_generic_rpc_handlers(self, handlers):
        for h in handlers:
            methods = getattr(h, "_method_handlers", None)
            if methods is None:
                # Fail CLOSED: an uninspectable handler could smuggle a
                # streaming method past the guard into an opaque
                # call-time failure.
                raise ValueError(
                    "serve gRPC ingress: only handlers built by "
                    "grpc.method_handlers_generic_handler (what "
                    "generated add_XServicer_to_server code uses) can "
                    "mount onto the proxy")
            for svc_method, mh in methods.items():
                if mh.request_streaming or mh.response_streaming:
                    raise ValueError(
                        f"serve gRPC ingress: {svc_method!r} is a "
                        f"streaming RPC; only unary-unary methods can "
                        f"route to deployments")
        self._server.add_generic_rpc_handlers(handlers)

    def __getattr__(self, name):
        return getattr(self._server, name)


_server = None


def start_grpc_proxy(host: str = "127.0.0.1", port: int = 0,
                     allow_pickle: bool = False,
                     servicer_functions: list | None = None) -> str:
    """Start (or return) the serve gRPC ingress; returns 'host:port'.

    `servicer_functions`: generated `add_XServicer_to_server` callables
    (or "module.add_XServicer_to_server" strings) mounting the user's own
    proto services; their methods route to same-named deployment methods
    with fully-decoded request/response messages. The generic raw-bytes
    routes stay available alongside.

    SECURITY: `allow_pickle=True` enables the `__pickle__` convenience
    route (used by `grpc_call`), which unpickles client bytes — arbitrary
    code execution for anyone who can reach the port. Enable it only on
    trusted networks; the raw-bytes and proto routes are always safe."""
    global _server
    import grpc
    if _server is not None:
        if _server[2] != allow_pickle:
            raise ValueError(
                f"gRPC proxy already running with allow_pickle="
                f"{_server[2]}; stop_grpc_proxy() first to change it")
        if servicer_functions:
            raise ValueError(
                "gRPC proxy already running; stop_grpc_proxy() first to "
                "mount additional servicer_functions")
        return _server[1]
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=16))
    generic = _GenericHandler(allow_pickle)
    routing = _RoutingServicer(generic)
    mount = _MountServer(server)
    for fn in servicer_functions or []:
        if isinstance(fn, str):
            import importlib
            mod, _, attr = fn.rpartition(".")
            fn = getattr(importlib.import_module(mod), attr)
        fn(routing, mount)
    server.add_generic_rpc_handlers((generic,))
    bound = server.add_insecure_port(f"{host}:{port}")
    server.start()
    addr = f"{host}:{bound}"
    _server = (server, addr, allow_pickle)
    return addr


def stop_grpc_proxy():
    global _server
    if _server is not None:
        _server[0].stop(grace=1.0)
        _server = None


def grpc_call(addr: str, app: str, *args, timeout_s: float = 60.0,
              **kwargs):
    """Python-client helper: pickled unary call to `app`'s __call__."""
    import grpc
    with grpc.insecure_channel(addr) as channel:
        fn = channel.unary_unary(
            f"/{app}/{PICKLE_METHOD}",
            request_serializer=None,
            response_deserializer=None)
        out = fn(pickle.dumps((args, kwargs)), timeout=timeout_s)
    return pickle.loads(out)
