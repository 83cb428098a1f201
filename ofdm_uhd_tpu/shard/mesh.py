"""Mesh construction for single- and multi-host runs (SURVEY.md §2.3, §5.8)."""

from __future__ import annotations

import jax
import numpy as np


def make_mesh(n_frame: int = 1, n_time: int = 1,
              devices=None) -> jax.sharding.Mesh:
    """Build a ('frame', 'time') mesh over the given (or all) devices.

    Either axis may be 1; total must divide the device count (extra devices
    are left unused rather than erroring, taking the first n_frame*n_time).
    """
    devs = np.asarray(devices if devices is not None else jax.devices())
    need = n_frame * n_time
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    grid = devs[:need].reshape(n_frame, n_time)
    return jax.sharding.Mesh(grid, ("frame", "time"))


def make_stage_mesh(n_stage: int = 2, devices=None) -> jax.sharding.Mesh:
    """1-D ('stage',) mesh for the pipeline-parallel RX (stage_pipeline.py)."""
    devs = np.asarray(devices if devices is not None else jax.devices())
    if len(devs) < n_stage:
        raise ValueError(f"need {n_stage} devices, have {len(devs)}")
    return jax.sharding.Mesh(devs[:n_stage], ("stage",))


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-host bring-up: jax.distributed.initialize per host (T4/§5.8).

    Pass the coordinator address (host:port), the process count and this
    process's id; with no args, JAX looks for a cluster in the environment
    and fails where none is described. After this, jax.devices() spans all
    hosts and the same collectives run over NCCL across them.
    """
    kwargs = {}
    if coordinator is not None:
        kwargs = dict(coordinator_address=coordinator,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)
