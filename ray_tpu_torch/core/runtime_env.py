"""Runtime environments: pip package sets with URI-cache semantics and
per-env worker pools.

Parity: reference `python/ray/_private/runtime_env/pip.py` (pip envs built
once per content hash, cached under a URI key) served by the runtime-env
agent (`agent/runtime_env_agent.py:167`), and per-env worker pools keyed by
the env in `WorkerPool` (`worker_pool.h:228`).

TPU-first simplification: instead of full virtualenvs + a per-node agent
service, a pip env is a `pip install --target` directory keyed by the
sha256 of its requirement list. Workers spawned for the env prepend the
directory to sys.path at boot (before any task runs), giving the
requirement set import precedence over the host env; the scheduler keys
worker pools by the env so tasks only ever land on matching workers.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import tempfile
import threading

_build_lock = threading.Lock()
_build_counts: dict[str, int] = {}  # env key -> builds performed (tests)


def pip_requirements(runtime_env: dict | None) -> list[str] | None:
    """Normalized pip requirement list of a runtime_env, or None."""
    spec = env_spec(runtime_env)
    return spec[1] if spec and spec[0] == "pip" else None


def env_spec(runtime_env: dict | None):
    """(tool, packages) of a runtime_env's package set, or None.

    tool: "pip" or "uv" (parity: runtime_env/pip.py and runtime_env/uv.py
    — uv builds the same content-hashed target dirs, just much faster),
    "conda" (runtime_env/conda.py — a whole interpreter env), or
    "container" (runtime_env/image_uri.py — worker runs inside an OCI
    image)."""
    if not runtime_env:
        return None
    for tool in ("pip", "uv"):
        pkgs = runtime_env.get(tool)
        if pkgs:
            if isinstance(pkgs, dict):  # reference: {"packages": [...]}
                pkgs = pkgs.get("packages", [])
            return (tool, [str(p) for p in pkgs])
    conda = runtime_env.get("conda")
    if conda:
        if isinstance(conda, dict):
            # Env yaml body. Entries may be strings ("numpy=1.26") or the
            # standard nested {"pip": [...]} dict — keep dicts structured
            # (conda's yaml understands them; stringifying would corrupt
            # the env file AND the content hash).
            import json
            deps = [d if isinstance(d, (dict, str)) else str(d)
                    for d in conda.get("dependencies", [])]
            return ("conda", sorted(
                deps, key=lambda d: json.dumps(d, sort_keys=True)))
        # Existing named/prefix env ("env:" tag keeps it distinct from a
        # one-package dependency list).
        return ("conda", ["env:" + str(conda)])
    image = runtime_env.get("image_uri")
    container = runtime_env.get("container")
    if not image and isinstance(container, dict):
        image = container.get("image")
    if image:
        return ("container", [str(image)])
    return None


def _norm_spec(spec):
    """Accept a bare requirement list (implied pip — the original API) or
    a (tool, packages) tuple."""
    if (isinstance(spec, tuple) and len(spec) == 2
            and spec[0] in ("pip", "uv", "conda", "container")
            and isinstance(spec[1], list)):
        return spec
    return ("pip", [str(p) for p in spec])


def pip_env_key(spec) -> str:
    """Content hash of (tool, requirement list, interpreter version): the
    URI-cache key AND the worker-pool key. Requirements may be nested
    structures (conda's {"pip": [...]}), hashed canonically."""
    import json
    tool, pkgs = _norm_spec(spec)
    h = hashlib.sha256()
    h.update(tool.encode())
    h.update(sys.version.split()[0].encode())
    for req in sorted(pkgs, key=lambda r: json.dumps(r, sort_keys=True)):
        h.update(json.dumps(req, sort_keys=True).encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


def env_cache_dir() -> str:
    return os.environ.get(
        "RAY_TPU_TORCH_ENV_CACHE",
        os.path.join(tempfile.gettempdir(), "ray_tpu_torch_sessions", "pip_envs"))


def ensure_pip_env(pip: list[str], timeout: float = 600.0) -> str:
    """Build (or reuse) the env for `pip`; returns its site directory.

    Cache-hit = a `.ready` marker exists for the content hash; a crashed
    half-build (dir without marker) is rebuilt from scratch.
    """
    tool, pkgs = _norm_spec(pip)
    key = pip_env_key((tool, pkgs))
    target = os.path.join(env_cache_dir(), key)
    marker = os.path.join(target, ".ready")
    with _build_lock:  # one build per process; cross-process rebuilds are
        # idempotent (same content hash -> same bits)
        if os.path.exists(marker):
            return target
        if os.path.isdir(target):
            # Crashed half-build: pip --target does NOT replace existing
            # package dirs, so building on top would cache a corrupt env
            # behind a fresh marker. Start clean.
            import shutil
            shutil.rmtree(target, ignore_errors=True)
        os.makedirs(target, exist_ok=True)
        if tool == "uv":
            import shutil
            if shutil.which("uv") is None:
                raise RuntimeError(
                    "runtime_env={'uv': ...} requires the uv binary on "
                    "PATH; use {'pip': ...} instead")
            cmd = ["uv", "pip", "install", "--quiet", "--target", target,
                   "--python", sys.executable, *pkgs]
        else:
            cmd = [sys.executable, "-m", "pip", "install", "--quiet",
                   "--target", target, *pkgs]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{tool} env build failed ({' '.join(pkgs)}):\n"
                f"{proc.stderr}")
        with open(marker, "w") as f:
            f.write(" ".join(sorted(pkgs)))
        _build_counts[key] = _build_counts.get(key, 0) + 1
        return target


def build_count(pip: list[str]) -> int:
    """How many times THIS process built the env (0 = every use was a
    cache hit)."""
    return _build_counts.get(pip_env_key(pip), 0)


# ---------------------------------------------------------------------------
# conda envs (parity: runtime_env/conda.py — whole-interpreter envs)
# ---------------------------------------------------------------------------

def conda_binary() -> str | None:
    import shutil
    return (os.environ.get("RAY_TPU_TORCH_CONDA_EXE")
            or shutil.which("conda") or shutil.which("mamba")
            or shutil.which("micromamba"))


def ensure_conda_env(deps: list[str], timeout: float = 1800.0) -> str:
    """Build (or reuse) a conda env for a dependency list; returns its
    prefix directory. A single-element list naming an existing env/prefix
    (no version pins, not a package spec) is used as-is — the reference's
    `runtime_env={"conda": "env_name"}` form."""
    conda = conda_binary()
    if (len(deps) == 1 and isinstance(deps[0], str)
            and deps[0].startswith("env:")):
        # Existing named env or prefix.
        name = deps[0][4:]
        if os.path.isdir(name):
            return name
        if conda is None:
            raise RuntimeError(
                "runtime_env={'conda': ...} requires a conda/mamba binary "
                "on PATH (or RAY_TPU_TORCH_CONDA_EXE)")
        proc = subprocess.run([conda, "env", "list", "--json"],
                              capture_output=True, text=True, timeout=60)
        import json
        for prefix in json.loads(proc.stdout or "{}").get("envs", []):
            if os.path.basename(prefix) == name:
                return prefix
        raise RuntimeError(f"conda env {name!r} not found")
    if conda is None:
        raise RuntimeError(
            "runtime_env={'conda': ...} requires a conda/mamba binary on "
            "PATH (or RAY_TPU_TORCH_CONDA_EXE)")
    key = pip_env_key(("conda", deps))
    prefix = os.path.join(env_cache_dir(), "conda-" + key)
    marker = os.path.join(prefix, ".ready")
    with _build_lock:
        if os.path.exists(marker):
            return prefix
        if os.path.isdir(prefix):
            import shutil
            shutil.rmtree(prefix, ignore_errors=True)
        import yaml
        with tempfile.NamedTemporaryFile(
                "w", suffix=".yml", delete=False) as f:
            yaml.safe_dump({"dependencies": list(deps)}, f)
            env_yaml = f.name
        try:
            proc = subprocess.run(
                [conda, "env", "create", "-p", prefix, "-f", env_yaml],
                capture_output=True, text=True, timeout=timeout)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"conda env build failed ({deps}):\n{proc.stderr}")
        finally:
            os.unlink(env_yaml)
        import json
        with open(marker, "w") as f:
            f.write(json.dumps(deps, sort_keys=True, default=str))
        _build_counts[key] = _build_counts.get(key, 0) + 1
        return prefix


# ---------------------------------------------------------------------------
# container envs (parity: runtime_env/image_uri.py — podman-run workers)
# ---------------------------------------------------------------------------

def container_binary() -> str | None:
    import shutil
    return (os.environ.get("RAY_TPU_TORCH_CONTAINER_EXE")
            or shutil.which("podman") or shutil.which("docker"))


def container_worker_argv(image: str, session_dir: str,
                          repo_root: str) -> list[str]:
    """The `podman run` prefix wrapped around a worker command.

    Matches the reference's worker-in-container launch
    (`runtime_env/image_uri.py` `_modify_context`): host IPC namespace so
    the shm object-store arena is shared, host network for the transport,
    the session dir and framework source mounted through, and
    --preserve-fds so the worker's control socketpair crosses the boundary
    (the worker fd is dup'd to 3 before exec).
    """
    return [
        container_binary() or "podman", "run", "--rm",
        "--ipc=host", "--network=host", "--pid=host",
        "--preserve-fds=1",
        "-v", "/dev/shm:/dev/shm",
        "-v", f"{session_dir}:{session_dir}",
        "-v", f"{repo_root}:{repo_root}:ro",
        "-e", f"PYTHONPATH={repo_root}",
        "--env-host",
        image,
    ]
