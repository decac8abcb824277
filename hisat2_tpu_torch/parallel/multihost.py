"""Multi-host (multi-process) data path: torch.distributed init, a
world-spanning mesh, and the deterministic cross-host novel-splice-site
merge (the PyTorch port of hisat2_tpu's parallel/multihost.py).

The reference is single-node; its only cross-worker mutable state is
the SpliceSiteDB, shared between pthreads under a mutex with a read-id
skew window (hisat2.cpp:3285-3308). The multi-host equivalent is
ROUND-BASED: every process aligns its own read shard for one batch round
against a frozen site table, then all processes exchange their newly
discovered sites (two all-gathers) and merge them in sorted order —
deterministic regardless of process count or timing, unlike the
reference's skew-window races."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .mesh import gather, local_cuda_index, make_mesh, mesh_device, to_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device: str = "cuda") -> None:
    """Join the process group: coordinator "host:port" (TCP; a URL such
    as file:///path passes through), num_processes ranks, this one
    process_id. device "cuda" takes NCCL and "cpu" gloo; a backend string
    such as "cpu:gloo,cuda:nccl" passes through (one process holding
    both). A CUDA backend with no card raises; nothing falls back."""
    backend = BACKENDS.get(device, device)
    if "nccl" in backend:
        if not torch.cuda.is_available():
            raise RuntimeError(f"init_distributed({device!r}): no CUDA "
                               f"device")
        # NCCL binds each rank to the card current when it first runs
        torch.cuda.set_device(local_cuda_index(process_id))
    method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=method,
                            world_size=num_processes, rank=process_id)


def global_mesh(n_shards: int = 1, device_type: str = "cuda"):
    """The (dp, shard) mesh over every process of the world: dp spans
    hosts (read batches split across hosts); a genome shard's column
    holds consecutive ranks."""
    return make_mesh(None, n_shards, device_type)


def shard_batch_global(mesh, *arrays):
    """This process's own read rows as tensors on its device. With one
    process a device a process's local batch is its dp block, so nothing
    of it travels to another host (the ranks of one dp row pass the same
    rows)."""
    dev = mesh_device(mesh)
    return tuple(to_device(a, dev) for a in arrays)


def _world_device() -> torch.device:
    """Where the default group's collectives run: the card under NCCL."""
    if "nccl" in str(dist.get_backend()):
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def sync_splice_sites(ssdb) -> int:
    """Exchange + merge novel splice sites across processes (one round
    of the cross-host merge). Every process ends with the identical
    union, applied in sorted (left, right) order so downstream site
    tables are deterministic. Returns the number of sites adopted from
    other processes."""
    local = sorted(ssdb.novel)
    rows = np.zeros((len(local), 3), np.int64)
    for i, k in enumerate(local):
        s = ssdb.strands.get(k, ".")
        rows[i] = (k[0], k[1], 1 if s == "+" else (-1 if s == "-" else 0))
    dev = _world_device()
    # pad to the largest count (the gather needs uniform shapes)
    counts = gather(torch.tensor([rows.shape[0]], dtype=torch.int64,
                                 device=dev), None).reshape(-1)
    cap = int(counts.max())
    if cap == 0:
        return 0
    pad = np.full((cap, 3), -1, np.int64)
    pad[:rows.shape[0]] = rows
    allr = gather(torch.from_numpy(pad).to(dev), None).reshape(-1, 3)
    allr = allr.cpu().numpy()
    allr = allr[allr[:, 0] >= 0]
    order = np.lexsort((allr[:, 1], allr[:, 0]))
    adopted = 0
    for li, ri, sc in allr[order]:
        k = (int(li), int(ri))
        if k in ssdb.novel or k in ssdb.known:
            continue
        ssdb.add_novel(int(li), int(ri),
                       "+" if sc > 0 else ("-" if sc < 0 else "."))
        adopted += 1
    return adopted
