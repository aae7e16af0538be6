"""PyTorch port, core runtime (`ray_tpu_torch.core`, the port's copy of
`ray_tpu/core/`): tasks, actors, the object store and GPU resources on
the CPU, with a small arena; the JAX package's runtime beside it in one
process; and a task and an actor with cloudpickle and protobuf missing.

The functions the workers run live in `tests/test_torch_dist_workers.py`
(torch and ray_tpu_torch only), so the workers import them by name."""

import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.core.runtime import ARENA_PREFIX
from tests import test_torch_dist_workers as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port_rt():
    """One port runtime for the module: 3 CPUs, a 64 MiB arena, and 2
    GPUs by the detection's env override (this host has none: the ids
    are logical, and no task here touches CUDA)."""
    old = os.environ.get("RAY_TPU_TORCH_NUM_GPUS")
    os.environ["RAY_TPU_TORCH_NUM_GPUS"] = "2"
    try:
        rt.init(num_cpus=3, object_store_memory=64 << 20)
    finally:
        if old is None:
            os.environ.pop("RAY_TPU_TORCH_NUM_GPUS")
        else:
            os.environ["RAY_TPU_TORCH_NUM_GPUS"] = old
    yield rt
    rt.shutdown()


def test_tasks_objects_and_wait(port_rt):
    """Tasks, put/get of numpy arrays and CPU tensors (through the arena
    and inline), and wait."""
    add = rt.remote(W.add_one)
    assert rt.get(add.remote(41), timeout=60) == 42
    arr = np.arange(200_000, dtype=np.float32)       # 800 KB: the arena
    ref = rt.put(arr)
    np.testing.assert_array_equal(rt.get(ref, timeout=60), arr)
    got = rt.get(add.remote(ref), timeout=60)        # a ref as an argument
    np.testing.assert_array_equal(got, arr + 1)
    t = torch.arange(10, dtype=torch.float64)
    assert torch.equal(rt.get(rt.put(t), timeout=60), t)
    assert torch.equal(rt.get(add.remote(t), timeout=60), t + 1)
    refs = [add.remote(i) for i in range(4)]
    ready, pending = rt.wait(refs, num_returns=4, timeout=60)
    assert len(ready) == 4 and not pending
    assert sorted(rt.get(ready, timeout=60)) == [1, 2, 3, 4]


def test_actor_state_and_restart(port_rt):
    """An actor keeps its state between calls; after its process dies,
    max_restarts=1 brings it back in a new process with fresh state."""
    Counter = rt.remote(max_restarts=1)(W.Counter)
    c = Counter.remote(10)
    assert rt.get(c.add.remote(), timeout=60) == 11
    assert rt.get(c.add.remote(5), timeout=60) == 16
    pid = rt.get(c.pid.remote(), timeout=60)
    c.die.remote()
    deadline = time.monotonic() + 60
    while True:
        try:
            new_pid = rt.get(c.pid.remote(), timeout=60)
            break
        except rt.RayTpuError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)
    assert new_pid != pid
    assert rt.get(c.add.remote(), timeout=60) == 11
    rt.kill(c)


def test_gpu_resources_and_visibility(port_rt):
    """`GPU` is the accelerator resource (num_gpus in remote/options):
    a num_gpus=0 task sees CUDA_VISIBLE_DEVICES="", a num_gpus=1 task
    one device id; two whole-GPU actors get distinct ids and hold the
    count while they live; two half-GPU actors share one id (fractions
    pack onto the fullest device that fits) and a whole GPU takes the
    other."""
    assert rt.cluster_resources()["GPU"] == 2.0
    vis = rt.remote(W.cuda_visible_devices)
    assert rt.get(vis.options(num_gpus=0).remote(), timeout=60) == ""
    one = rt.get(vis.options(num_gpus=1).remote(), timeout=60)
    assert one in ("0", "1")

    Vis = rt.remote(W.VisibleDevices)
    a, b = (Vis.options(num_gpus=1).remote() for _ in range(2))
    ids = rt.get([a.get.remote(), b.get.remote()], timeout=60)
    assert sorted(ids) == ["0", "1"]
    assert rt.available_resources().get("GPU", 0.0) == 0.0
    rt.kill(a)
    rt.kill(b)
    deadline = time.monotonic() + 30
    while rt.available_resources().get("GPU", 0.0) < 2.0:
        assert time.monotonic() < deadline, rt.available_resources()
        time.sleep(0.1)

    h1, h2 = (Vis.options(num_gpus=0.5).remote() for _ in range(2))
    whole = Vis.options(num_gpus=1).remote()
    halves = rt.get([h1.get.remote(), h2.get.remote()], timeout=60)
    other = rt.get(whole.get.remote(), timeout=60)
    assert halves[0] == halves[1] and other != halves[0]
    assert {halves[0], other} == {"0", "1"}
    for h in (h1, h2, whole):
        rt.kill(h)



def test_placement_group_bundles_carry_device_ids(port_rt):
    """An actor reserving GPUs out of a placement-group bundle sees the
    devices the bundle holds: two half-GPU bundles packed on one device
    give their actors that device's id, a whole-GPU bundle the other;
    after the group is removed every share is back, and two whole-GPU
    actors get distinct ids again."""
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)
    from ray_tpu_torch.util.scheduling_strategies import \
        PlacementGroupSchedulingStrategy as InGroup
    shares = (0.5, 0.5, 1.0)
    pg = placement_group([{"GPU": g} for g in shares], strategy="PACK")
    assert pg.wait(60)
    Vis = rt.remote(W.VisibleDevices)
    actors = [Vis.options(num_gpus=g, scheduling_strategy=InGroup(pg, i))
              .remote() for i, g in enumerate(shares)]
    ids = rt.get([a.get.remote() for a in actors], timeout=60)
    assert ids[0] == ids[1] and {ids[0], ids[2]} == {"0", "1"}, ids
    for a in actors:
        rt.kill(a)
    remove_placement_group(pg)
    deadline = time.monotonic() + 30
    while rt.available_resources().get("GPU", 0.0) < 2.0:
        assert time.monotonic() < deadline, rt.available_resources()
        time.sleep(0.1)
    a, b = (Vis.options(num_gpus=1).remote() for _ in range(2))
    assert sorted(rt.get([a.get.remote(), b.get.remote()],
                         timeout=60)) == ["0", "1"]
    for h in (a, b):
        rt.kill(h)


def _run_script(code: str, env_extra=None, timeout=180):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.update(env_extra or {})
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


# A get on the JAX package's runtime that waits for its workers to boot
# (each imports jax): 7.4 s after its init and 13.9 s for the four after
# its re-init in a whole tier-1 run at -n 6, 18.8 s under twelve CPU
# hogs, where a 60 s limit once ran out under the whole run's load.
REF_BOOT_GET_S = 240


def test_port_and_reference_runtimes_side_by_side():
    """The JAX package's runtime and the port's in one process: each runs
    tasks on its own arena ("ray_tpu_<pid>_..." and ARENA_PREFIX
    "<pid>_..."); shutting either down, and initializing it again (its
    reaper runs), leaves the other's arena and workers alive and
    working."""
    out = _run_script(f"""
        import glob, os
        import ray_tpu
        import ray_tpu_torch
        from tests import test_torch_dist_workers as W

        def arenas(prefix):
            return [p for p in glob.glob("/dev/shm/" + prefix + "*")
                    if os.path.basename(p).split("_")[
                        2 if prefix == "ray_tpu_" else 1] == str(os.getpid())
                    and not p.endswith(".sock")]

        def alive(pids):
            return all(os.path.exists(f"/proc/{{p}}") for p in pids)

        ref_add = ray_tpu.remote(W.add_one)
        port_add = ray_tpu_torch.remote(W.add_one)
        ray_tpu.init(num_cpus=2, object_store_memory=32 << 20)
        ray_tpu_torch.init(num_cpus=2, object_store_memory=32 << 20)
        pid_of = lambda mod, t=60: mod.get(mod.remote(W.worker_pid).remote(),
                                           timeout=t)
        assert ray_tpu.get(ref_add.remote(1), timeout={REF_BOOT_GET_S}) == 2
        assert ray_tpu_torch.get(port_add.remote(2), timeout=60) == 3
        port_arena = arenas({ARENA_PREFIX!r})
        ref_arena = arenas("ray_tpu_")
        assert len(port_arena) == 1 and len(ref_arena) == 1, (
            port_arena, ref_arena)
        port_pids = {{pid_of(ray_tpu_torch) for _ in range(4)}}

        ray_tpu.shutdown()
        assert arenas({ARENA_PREFIX!r}) == port_arena and alive(port_pids)
        assert ray_tpu_torch.get(port_add.remote(3), timeout=60) == 4
        ray_tpu.init(num_cpus=2, object_store_memory=32 << 20)  # reaps
        assert arenas({ARENA_PREFIX!r}) == port_arena and alive(port_pids)
        assert ray_tpu_torch.get(port_add.remote(4), timeout=60) == 5
        ref_arena = arenas("ray_tpu_")
        ref_pids = {{pid_of(ray_tpu, {REF_BOOT_GET_S}) for _ in range(4)}}

        ray_tpu_torch.shutdown()
        assert arenas("ray_tpu_") == ref_arena and alive(ref_pids)
        assert ray_tpu.get(ref_add.remote(5), timeout=60) == 6
        ray_tpu_torch.init(num_cpus=2, object_store_memory=32 << 20)
        assert arenas("ray_tpu_") == ref_arena and alive(ref_pids)
        assert ray_tpu.get(ref_add.remote(6), timeout=60) == 7
        assert ray_tpu_torch.get(port_add.remote(7), timeout=60) == 8
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()
        assert not arenas({ARENA_PREFIX!r}) and not arenas("ray_tpu_")
        print("ok")
        """, env_extra={"JAX_PLATFORMS": "cpu"},
        timeout=2 * REF_BOOT_GET_S + 240)
    assert out.strip().endswith("ok")


def test_task_and_actor_without_cloudpickle_or_protobuf(tmp_path):
    """With cloudpickle and google.protobuf unimportable (sys.modules
    entries of None, in the driver and, through a sitecustomize first on
    the path, in every worker) a task and an actor still run: functions
    and classes pickle by reference, every frame is pickle-framed, and
    arguments that are no scalars (a list, a numpy array: the collecting
    pickler's path) pickle too."""
    block = tmp_path / "block"
    block.mkdir()
    (block / "sitecustomize.py").write_text(
        "import sys\n"
        "sys.modules['cloudpickle'] = None\n"
        "sys.modules['google.protobuf'] = None\n")
    out = _run_script("""
        import sys
        sys.modules["cloudpickle"] = None
        sys.modules["google.protobuf"] = None
        import ray_tpu_torch as rt
        from tests import test_torch_dist_workers as W
        assert "cloudpickle" not in [m for m, v in sys.modules.items() if v]
        rt.init(num_cpus=2, object_store_memory=32 << 20)
        assert rt.get(rt.remote(W.add_one).remote(1), timeout=60) == 2
        c = rt.remote(W.Counter).remote(5)
        assert rt.get(c.add.remote(2), timeout=60) == 7
        import numpy as np
        got = rt.get(rt.remote(W.add_one).remote(np.arange(3)), timeout=60)
        assert got.tolist() == [1, 2, 3], got
        assert rt.get(c.add.remote(*[3]), timeout=60) == 10
        missing = rt.get(rt.remote(W.imports_fail).remote(
            ["cloudpickle", "google.protobuf"]), timeout=60)
        assert missing == ["cloudpickle", "google.protobuf"], missing
        rt.shutdown()
        print("ok")
        """, env_extra={"PYTHONPATH": f"{block}{os.pathsep}{REPO}"
                        f"{os.pathsep}{os.environ.get('PYTHONPATH', '')}"})
    assert out.strip().endswith("ok")


@pytest.mark.parametrize("proc, nvml, nodes, want", [
    (["0000:18:00.0"], 3, ["nvidia0", "nvidia1"], 1),   # /proc first
    (None, 1, ["nvidia0", "nvidia3"], 1),   # no /proc: NVML, not the nodes
    (None, None, ["nvidia0", "nvidia3", "nvidiactl"], 2),   # last resort
    (None, None, [], 0),
])
def test_gpu_count_reads_the_devices_not_the_nodes(tmp_path, monkeypatch,
                                                   proc, nvml, nodes, want):
    """detect_gpus() counts the host's devices without CUDA: the entries
    of /proc/driver/nvidia/gpus, else NVML's count, and only without
    both the /dev/nvidia<N> nodes (a one-card container has shown two);
    CUDA_VISIBLE_DEVICES, where set, and then the env override win."""
    from ray_tpu_torch.core import accelerators as acc
    if proc is not None:
        for p in proc:
            (tmp_path / "gpus" / p).mkdir(parents=True)
    (tmp_path / "dev").mkdir()
    for n in nodes:
        (tmp_path / "dev" / n).touch()
    monkeypatch.setattr(acc, "PROC_GPUS_DIR", str(tmp_path / "gpus"))
    monkeypatch.setattr(acc, "DEV_NODES_GLOB",
                        str(tmp_path / "dev" / "nvidia[0-9]*"))
    monkeypatch.setattr(acc, "_nvml_count", lambda: nvml)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.delenv(acc.NUM_GPUS_ENV, raising=False)
    assert acc.detect_gpus() == want
    assert acc.detect_gpu_ids() == [str(i) for i in range(want)]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,5")
    assert acc.detect_gpu_ids() == ["2", "5"]
    monkeypatch.setenv(acc.NUM_GPUS_ENV, "1")
    assert acc.detect_gpu_ids() == ["2"]


def test_rank_that_reserved_gpus_without_a_device_raises(monkeypatch):
    """A trainer rank that reserved GPUs and finds no CUDA device fails:
    get_device() and TorchDistributedConfig's backend choice raise instead
    of going on on the CPU over gloo. A rank that reserved none runs on
    the CPU; ranks sharing a card take gloo, each with its own nccl."""
    from ray_tpu_torch.train.backend import (GPUS_PER_WORKER_ENV,
                                             TorchDistributedConfig)
    from ray_tpu_torch.train.torch import get_device
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setenv(GPUS_PER_WORKER_ENV, "0")
    assert get_device() == torch.device("cpu")
    assert TorchDistributedConfig().pick_backend() == "gloo"
    for gpus in ("1", "0.5"):
        monkeypatch.setenv(GPUS_PER_WORKER_ENV, gpus)
        with pytest.raises(RuntimeError, match="CUDA sees no device"):
            get_device()
        with pytest.raises(RuntimeError, match="CUDA sees no device"):
            TorchDistributedConfig().pick_backend()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert TorchDistributedConfig().pick_backend() == "gloo"   # 0.5
    monkeypatch.setenv(GPUS_PER_WORKER_ENV, "1")
    assert TorchDistributedConfig().pick_backend() == "nccl"
    assert get_device() == torch.device("cuda", 0)
