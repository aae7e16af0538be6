"""Internal KV API over the head's control plane (counterpart of
`ray_tpu/experimental/internal_kv.py`, over the port's runtime KV).

Parity: reference `python/ray/experimental/internal_kv.py`
(`_internal_kv_get/put/del/exists/list` over the GCS KV,
`gcs_kv_manager.h`). Works from the driver (direct) and from any worker
(request RPC to the head).
"""

from __future__ import annotations


def _rt():
    from ray_tpu_torch.core.runtime import get_runtime
    return get_runtime()


def _is_head(rt) -> bool:
    from ray_tpu_torch.core.runtime import Runtime
    return isinstance(rt, Runtime)


def _internal_kv_initialized() -> bool:
    try:
        _rt()
        return True
    except Exception:  # noqa: BLE001
        return False


def _internal_kv_put(key, value, overwrite: bool = True) -> bool:
    """Returns True if the key already existed. overwrite=False is atomic
    (single head-side check-and-set, like the reference's GCS KV PUT) —
    concurrent writers cannot both win."""
    rt = _rt()
    if _is_head(rt):
        with rt.lock:
            existed = key in rt.kv
            if overwrite or not existed:
                rt.kv[key] = value
        return existed
    if overwrite:
        return rt.request("kv_put", (key, value))
    return rt.request("kv_putnx", (key, value))


def _internal_kv_get(key):
    rt = _rt()
    if _is_head(rt):
        with rt.lock:
            return rt.kv.get(key)
    return rt.request("kv_get", key)


def _internal_kv_exists(key) -> bool:
    return _internal_kv_get(key) is not None


def _internal_kv_del(key):
    rt = _rt()
    if _is_head(rt):
        with rt.lock:
            rt.kv.pop(key, None)
    else:
        rt.request("kv_del", key)


def _internal_kv_take(key):
    """Atomic get+delete; returns None if absent (exactly one of N
    concurrent callers receives a present value)."""
    rt = _rt()
    if _is_head(rt):
        return rt.kv_take(key)
    return rt.request("kv_take", key)


def _internal_kv_list(prefix=b"") -> list:
    rt = _rt()
    if _is_head(rt):
        return rt.kv_keys(prefix)
    return rt.request("kv_keys", prefix)
