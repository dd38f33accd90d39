"""Cross-rank agreement at step boundaries (the port of the JAX package's
``utils/distributed.py``).

The reference escapes uneven per-rank data with a gloo side channel
(``cosyvoice_join``, train_utils.py:217-235) and DDP ``model.join``.  Here
every step-boundary decision ("does every rank have another batch?", "was
any rank preempted?") is an all-reduce MIN of one integer over the world,
so all ranks take the same branch and no collective is ever entered by a
strict subset of them (which would hang the others).
"""

from __future__ import annotations

from typing import Iterable, Iterator

import torch
import torch.distributed as dist


def _agreement_device() -> torch.device:
    """NCCL reduces CUDA tensors only; gloo takes CPU ones."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_hosts_agree(flag: bool) -> bool:
    """True only if every rank passes True: an all-reduce MIN over the
    world, on the group's device.  The identity without a process group.
    Call it at step boundaries only: it synchronizes every rank."""
    if not dist.is_initialized():
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=_agreement_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def joined_loader(loader: Iterable) -> Iterator:
    """Yield batches while EVERY rank still has one; stop on all ranks the
    moment any rank is exhausted (the DDP ``model.join`` escape,
    executor.py:51-52 + train_utils.py:217-235), so the per-step
    collectives always see every rank.  In a world of one it is a plain
    peek-ahead over the loader."""
    it = iter(loader)
    try:
        while True:
            try:
                batch, have = next(it), True
            except StopIteration:
                batch, have = None, False
            if not all_hosts_agree(have):
                return
            yield batch
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
