"""Compile-on-demand for the native components.

The .so is built with g++ the first time it is needed and cached next to the
source keyed by a content hash, so `pip install`-style build steps are never
required and edits to the .cpp invalidate the cache automatically.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
# Beside the CUDA kernels' builds, in the package's gitignored _build/.
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build", "native")
_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _source_hash(paths) -> str:
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


# Sanitizer builds (parity: the reference's bazel --config=tsan/asan for
# the C++ runtime, .bazelrc:112-155): RAY_TPU_TORCH_NATIVE_SANITIZER=thread|
# address compiles the native components under TSan/ASan. Sanitized .so's
# are cached under a distinct tag; loading an ASan lib into a regular
# python needs LD_PRELOAD of the asan runtime — build_native() compiles
# without loading for CI-style race hunts.
_SANITIZE_ENV = "RAY_TPU_TORCH_NATIVE_SANITIZER"


def _sanitizer_flags(sanitizer: str | None) -> tuple[list, str]:
    san = (sanitizer if sanitizer is not None
           else os.environ.get(_SANITIZE_ENV, ""))
    if san in ("thread", "tsan"):
        return ["-fsanitize=thread", "-g", "-O1"], "-tsan"
    if san in ("address", "asan"):
        return ["-fsanitize=address", "-g", "-O1"], "-asan"
    return [], ""


def build_native(name: str, sources: tuple = (),
                 sanitizer: str | None = None,
                 headers: tuple = ()) -> str:
    """Compile (if needed) and return the .so path WITHOUT loading it.

    `sanitizer` overrides the env var ("thread"/"address"/""/None) — passed
    through as a parameter, never by mutating process-global env (a
    concurrent load_native in another thread must not pick it up)."""
    return _build(name, sources, sanitizer=sanitizer, headers=headers)


def _build(name: str, sources: tuple = (),
           sanitizer: str | None = None, headers: tuple = ()) -> str:
    # Default source is _native/<name>.cpp; absolute `sources` entries
    # are taken as-is, relative ones from _native/, so one cache serves
    # both layouts. `headers` are hashed (so an edit to a shared .h like
    # frame_core.h invalidates every .so that includes it) and their
    # directories ride -I; they are never handed to g++ as inputs.
    srcs = []
    primary = os.path.join(_DIR, f"{name}.cpp")
    if os.path.exists(primary):
        srcs.append(primary)
    srcs += [s if os.path.isabs(s) else os.path.join(_DIR, s)
             for s in sources]
    if not srcs:
        raise FileNotFoundError(f"no sources for native module {name!r}")
    hdrs = [p if os.path.isabs(p) else os.path.join(_DIR, p)
            for p in headers]
    extra, san_tag = _sanitizer_flags(sanitizer)
    tag = _source_hash(srcs + hdrs) + san_tag
    so_path = os.path.join(_BUILD_DIR, f"{name}-{tag}.so")
    if not os.path.exists(so_path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = so_path + f".tmp{os.getpid()}"
        cmd = [
            "g++", "-O2", "-fPIC", "-shared", "-pthread",
            "-std=c++17", *extra,
            *sorted({f"-I{os.path.dirname(p)}" for p in hdrs}),
            "-o", tmp, *srcs,
        ]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, so_path)  # atomic: concurrent builders race safely
    return so_path


def load_native(name: str, sources: tuple = (),
                headers: tuple = ()) -> ctypes.CDLL:
    """Build (if needed) and dlopen a native lib from ray_tpu_torch/_native/.

    Default source is <name>.cpp; `sources` names additional .cpp files
    compiled into the same .so and `headers` shared includes (the hash
    covers all of them, so editing any source OR header invalidates the
    cache)."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        lib = ctypes.CDLL(_build(name, sources, headers=headers))
        _loaded[name] = lib
        return lib
