"""GPU detection for the resource table (the GPU half of the reference's
accelerator managers).

Parity: reference `python/ray/_private/accelerators/nvidia_gpu.py`
(NvidiaGPUAcceleratorManager: CUDA_VISIBLE_DEVICES first, then NVML's
device count). The head counts GPUs at boot without touching CUDA: a CUDA
context made in the head would be inherited by nothing and would cost the
card memory, and the forkserver's children could not use it. Tasks and
actors that reserve GPUs get device ids from the head's accounting
(`Runtime._take_gpus`) in CUDA_VISIBLE_DEVICES before their first CUDA
call. The TPU pod-slice helpers of the JAX package have no counterpart on
one host.
"""

from __future__ import annotations

import ctypes
import glob
import os

NUM_GPUS_ENV = "RAY_TPU_TORCH_NUM_GPUS"
# One entry per physical device, where the driver exposes it.
PROC_GPUS_DIR = "/proc/driver/nvidia/gpus"
# The device nodes: the last resort. A container may hold more nodes than
# cards (a one-card sandbox has been seen with /dev/nvidia0 and
# /dev/nvidia3), so they are read only when neither of the above answers.
DEV_NODES_GLOB = "/dev/nvidia[0-9]*"


def _nvml_count() -> int | None:
    """The device count from NVML (the driver's management library, which
    makes no CUDA context), or None where it cannot be loaded."""
    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None
    if nvml.nvmlInit_v2() != 0:
        return None
    try:
        n = ctypes.c_uint(0)
        if nvml.nvmlDeviceGetCount_v2(ctypes.byref(n)) != 0:
            return None
        return n.value
    finally:
        nvml.nvmlShutdown()


def _host_gpu_count() -> int:
    """The host's physical GPUs: the entries of PROC_GPUS_DIR, else NVML's
    count, else the /dev/nvidia<N> nodes."""
    if os.path.isdir(PROC_GPUS_DIR):
        return len(os.listdir(PROC_GPUS_DIR))
    n = _nvml_count()
    if n is not None:
        return n
    return len([p for p in glob.glob(DEV_NODES_GLOB)
                if os.path.basename(p)[len("nvidia"):].isdigit()])


def detect_gpu_ids() -> list[str]:
    """This host's GPU device ids as CUDA_VISIBLE_DEVICES names them: the
    entries of CUDA_VISIBLE_DEVICES when it is set, else "0".."n-1" for
    the host's n devices (`_host_gpu_count`); RAY_TPU_TORCH_NUM_GPUS
    overrides the count (ids "0".."n-1", or the first n visible ones)."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        ids = [c.strip() for c in visible.split(",") if c.strip()]
    else:
        ids = [str(i) for i in range(_host_gpu_count())]
    env = os.environ.get(NUM_GPUS_ENV)
    if env:
        n = int(env)
        ids = ids[:n] if n <= len(ids) else [str(i) for i in range(n)]
    return ids


def detect_gpus() -> int:
    """Number of GPUs attached to this host (0 if none)."""
    return len(detect_gpu_ids())
