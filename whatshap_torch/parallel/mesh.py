"""
Several devices: batched phase blocks split data-parallel over a list of
torch devices (the port's counterpart of whatshap_tpu/parallel/mesh.py).

Phase blocks are independent, so a batch splits along its block axis into
contiguous shards, one a device, with no collective: each device runs the
column DP of its shard and the small per-block outputs come back to the
launch device.  The route itself does this for every batched launch
(ops/wmec.py _launch_batched, over wmec.MESH_DEVICES); the functions here
run one stacked batch over a given device list.

Several processes: initialize_distributed() sets up torch.distributed from
environment variables.  The solves here do not use the process group yet: a
sharded solve across processes is not ported (ROADMAP).
"""

import logging
import os
from contextlib import contextmanager
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops import wmec
from .blocks import to_device

logger = logging.getLogger(__name__)


def initialize_distributed() -> bool:
    """Initialise torch.distributed for a multi-process run when the
    environment asks for one: WHATSHAP_TORCH_COORDINATOR (host:port of rank
    0), with WHATSHAP_TORCH_NUM_PROCESSES and WHATSHAP_TORCH_PROCESS_ID
    (defaults 1 and 0).  NCCL where CUDA is available, gloo otherwise.
    Returns True if a process group was set up, False (doing nothing) when
    no coordinator is named."""
    coordinator = os.environ.get("WHATSHAP_TORCH_COORDINATOR")
    if not coordinator:
        return False
    world_size = int(os.environ.get("WHATSHAP_TORCH_NUM_PROCESSES", "1"))
    rank = int(os.environ.get("WHATSHAP_TORCH_PROCESS_ID", "0"))
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    torch.distributed.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank
    )
    logger.info(
        "torch.distributed initialised (%s): process %d/%d, %d local cards",
        backend, rank, world_size, torch.cuda.device_count(),
    )
    return True


def make_block_mesh(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices a batch is split over: `devices` as torch devices, or by
    default every visible card (raising where there is none, as every entry
    point of the port does)."""
    if devices is None:
        wmec.resolve_device(None)
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


@contextmanager
def _on_mesh(mesh: Sequence[torch.device]):
    """wmec.MESH_DEVICES set to `mesh` within the block."""
    saved = wmec.MESH_DEVICES
    wmec.MESH_DEVICES = list(mesh)
    try:
        yield
    finally:
        wmec.MESH_DEVICES = saved


def run_blocks_sharded(mesh: Sequence[torch.device], K: int, T: int, P_: int, arrays):
    """Batched forward DP (costs only, wmec.forward_cost_batched) of the
    stacked numpy arrays of parallel.blocks, with the block axis split over
    the mesh; B need not be a multiple of its size.
    Returns (dp_last (B, T, 2^K), jmin_last (B, T, 2^K), key_last (B, 2^K))
    on the mesh's first device."""
    with _on_mesh(mesh):
        return wmec.forward_cost_batched(K, T, P_, *to_device(arrays, mesh[0]))


def solve_blocks_sharded(mesh: Sequence[torch.device], K: int, T: int, P_: int, arrays):
    """The full batched solve (forward and backtrace,
    wmec.solve_batched_auto) of the stacked numpy arrays of parallel.blocks,
    with the block axis split over the mesh.
    Returns host numpy (costs (B,), index paths (B, C), transmission paths
    (B, C)), bit-identical to per-block run_dp solves."""
    with _on_mesh(mesh):
        out = wmec.solve_batched_auto(K, T, P_, *to_device(arrays, mesh[0]))
    return tuple(wmec._fetch(out))


def optimal_costs_from_batched(dp_last) -> np.ndarray:
    """Final MEC cost per block from the batched forward output."""
    if isinstance(dp_last, torch.Tensor):
        dp_last = dp_last.cpu().numpy()
    return np.asarray(dp_last).min(axis=(1, 2))
