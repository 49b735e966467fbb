"""Multi-process bootstrap for the mesh runtime (the JAX package's
``launch/multihost.py``).

Every process runs the same program; this module wires
``torch.distributed.init_process_group`` from the arguments or the
environment and checks the world against the requested mesh before any
step is built.

Usage (every process):
    from repro_torch.launch.multihost import bootstrap
    bootstrap()                       # no-op for a single process
    mesh = make_host_mesh()           # now spans the world

The three facts come from the reference's variables (``REPRO_COORDINATOR``
host:port of process 0, ``REPRO_NUM_PROCESSES``, ``REPRO_PROCESS_ID``) or,
for a job started by ``torchrun``, from its ``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE`` and ``RANK``.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

EXPECTED = {"16x16": 256, "2x16x16": 512}


def _env_coordinator() -> str | None:
    if os.environ.get("REPRO_COORDINATOR"):
        return os.environ["REPRO_COORDINATOR"]
    if os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"):
        return (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    return None


def bootstrap(coordinator: str | None = None,
              num_processes: int | None = None,
              process_id: int | None = None, *,
              backend: str | None = None, device=None) -> bool:
    """Initialize the default process group from the arguments or the
    environment; returns True if it did (or one exists), False for a
    single process.

    ``coordinator`` is ``host:port`` of process 0 (a TCP rendezvous) or a
    full init method (``tcp://...``, ``file://...``). ``backend`` defaults
    to ``nccl`` on a CUDA ``device`` (None: CUDA when present) and ``gloo``
    on the CPU; pass ``gloo`` where ranks share one card, which NCCL
    refuses. With NCCL each rank takes the card ``LOCAL_RANK`` (else its
    process id modulo the cards)."""
    if dist.is_initialized():
        return True
    coordinator = coordinator or _env_coordinator()
    if not coordinator:
        return False
    num_processes = int(num_processes or os.environ.get("REPRO_NUM_PROCESSES")
                        or os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = os.environ.get("REPRO_PROCESS_ID",
                                    os.environ.get("RANK"))
    process_id = int(process_id)
    if num_processes == 1:
        return False
    if backend is None:
        dev = torch.device(device if device is not None else (
            "cuda" if torch.cuda.is_available() else "cpu"))
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", process_id % torch.cuda.device_count())))
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)
    return True


def assert_fleet(mesh_name: str) -> None:
    """Fail fast (before any step is built) if the world does not match
    the mesh."""
    want = EXPECTED[mesh_name]
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != want:
        raise RuntimeError(
            f"mesh {mesh_name} needs {want} ranks; the world has {have}. "
            "Check REPRO_NUM_PROCESSES (or torchrun's WORLD_SIZE).")


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
