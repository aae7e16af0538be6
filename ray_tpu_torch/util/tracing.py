"""OpenTelemetry task tracing.

Parity: reference `python/ray/util/tracing/tracing_helper.py` — opt-in
spans around task/actor submit and execute, with the trace context
propagated to the worker so execute spans are children of submit spans
(the reference injects method decorators at `ray.init(_tracing_startup_hook)`;
here `setup_tracing()` flips a module flag the hot paths check — zero cost
when tracing is off).
"""

from __future__ import annotations

_enabled = False
_tracer = None


def setup_tracing(tracer_provider=None):
    """Enable span emission. With no provider, installs a basic SDK
    provider (spans go to any configured exporter; use
    opentelemetry-sdk's ConsoleSpanExporter for stdout)."""
    global _enabled, _tracer
    from opentelemetry import trace
    if tracer_provider is not None:
        trace.set_tracer_provider(tracer_provider)
    elif not isinstance(trace.get_tracer_provider(),
                        trace.ProxyTracerProvider):
        pass  # a real provider is already installed
    else:
        try:
            from opentelemetry.sdk.trace import TracerProvider
            trace.set_tracer_provider(TracerProvider())
        except ImportError:
            pass
    _tracer = trace.get_tracer("ray_tpu_torch")
    _enabled = True
    # Workers spawned after this point self-enable at boot.
    import os
    os.environ["RAY_TPU_TORCH_TRACING"] = "1"


def maybe_setup_from_env():
    """Worker boot hook: join tracing if the driver enabled it."""
    import os
    if os.environ.get("RAY_TPU_TORCH_TRACING") == "1" and not _enabled:
        try:
            setup_tracing()
        except Exception:  # noqa: BLE001 — tracing must never break boot
            pass


def tracing_enabled() -> bool:
    return _enabled


def inject_context() -> dict | None:
    """W3C traceparent headers for the current span (rides the TaskSpec)."""
    if not _enabled:
        return None
    from opentelemetry.propagate import inject
    carrier: dict = {}
    inject(carrier)
    return carrier or None


def submit_span(name: str, kind: str):
    """Context manager for a submit-side span (no-op contextless when
    tracing is off)."""
    import contextlib
    if not _enabled:
        return contextlib.nullcontext()
    return _tracer.start_as_current_span(
        f"{name}.remote()", attributes={"ray_tpu_torch.kind": kind})


def execute_span(name: str, carrier: dict | None):
    """Worker-side execute span, child of the submitter's span."""
    import contextlib
    if not _enabled:
        return contextlib.nullcontext()
    from opentelemetry import context as otel_ctx
    from opentelemetry.propagate import extract
    ctx = extract(carrier) if carrier else otel_ctx.get_current()
    return _tracer.start_as_current_span(
        name, context=ctx, attributes={"ray_tpu_torch.side": "execute"})
