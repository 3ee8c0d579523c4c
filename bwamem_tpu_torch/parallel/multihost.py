"""Several processes, one host pipeline each (port of
bwamem_tpu/parallel/multihost.py), through torch.distributed.

``mem --distributed coord,n,i`` runs n processes, each the whole CLI on
its own stripe of the input (``--shard i/n`` by default: chunks i, i+n,
...), each with its own copy of the index on its own device
(``local_device``: card i mod the cards there are).  SAM output stays
per process; the records are those of the ``--shard i/n`` run, because
the read numbering that keys the hash tie-breaks is per stripe.  ``mem``
runs no collective: the process group is its rendezvous only, and each
process estimates the insert sizes of its own chunks.  The group is
gloo's, because NCCL refuses two ranks on one card, which is how a
one-card machine runs the mode.  The rendezvous is a TCP store at
``coord``; it fails after BWAMEM_TPU_DIST_TIMEOUT seconds (default 120)
instead of waiting forever.

``local_shard_bounds`` and ``pestat_histograms`` (the JAX module's psum
of the insert-size histograms over the processes) are ports with no
caller in ``mem``; the tests hold them to the JAX functions.
"""

import datetime
import os

import torch
import torch.distributed as dist

from .mesh import local_pestat


def initialize(coordinator_address: str, num_processes: int,
               process_id: int) -> None:
    """Join the process group: the TCP rendezvous at coordinator_address
    (host:port), gloo."""
    timeout = float(os.environ.get("BWAMEM_TPU_DIST_TIMEOUT", "120"))
    dist.init_process_group(
        "gloo", init_method="tcp://" + coordinator_address,
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout))


def shutdown() -> None:
    """Leave the process group, where one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_device(device: str = "cuda") -> torch.device:
    """This process's device: card rank mod the cards there are, or the
    CPU."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--distributed --device cuda: no CUDA device")
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def local_shard_bounds(n_items: int) -> range:
    """The contiguous slice of a globally-indexed workload this process
    owns (JAX multihost.py:45; no caller in ``mem``)."""
    p = dist.get_rank()
    n = dist.get_world_size()
    per = (n_items + n - 1) // n
    return range(p * per, min((p + 1) * per, n_items))


def pestat_histograms(isize, orient):
    """This process's insert-size observations (isize int64[B],
    orientation int32[B], -1 = none) reduced over every process: counts
    int64[4] and histogram int32[4, MAX_ISIZE], the same on each, on the
    CPU (the psum over the global reads mesh, JAX multihost.py:38; no
    caller in ``mem``)."""
    counts, hist = local_pestat(torch.as_tensor(isize).cpu(),
                                torch.as_tensor(orient).cpu())
    dist.all_reduce(counts)
    dist.all_reduce(hist)
    return counts, hist
