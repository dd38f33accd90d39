"""Step checkpoints of the full-parameter trainers, and the reference-format
``.pt`` model export (the port of the JAX package's
``train/checkpoint.py``).

The JAX package writes orbax checkpoints; torch has no orbax, so a step here
is one ``torch.save`` file, ``<directory>/<step>/state.pt``, of a tree of
tensors (parameters, optimizer state dicts, counters).  The two packages'
step checkpoints are therefore not interchangeable; the ``.pt`` model
exports are (a plain state dict of the reference's names).

Under a process group rank 0 writes whole tensors (gathered from ZeRO-2 or
tensor-parallel blocks) and every rank reads them back into its own
layout, so a checkpoint written at one mesh resumes at another, as
orbax's restore to a target layout does.

``async_save``: ``save`` copies every tensor to host memory before it
returns, so the caller may update the live tensors at once, and a writer
thread puts the file on disk (one write in flight; ``wait`` drains it).
Each file is written under a temporary name and renamed, so a step
directory holds a whole checkpoint or none.  ``keep`` retains the newest K
steps.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import List, Optional

import torch
import torch.distributed as dist

from ..params import Params, load_torch_checkpoint, save_torch_checkpoint

__all__ = ["TrainCheckpointer", "save_model_pt", "load_model_pt", "to_host", "wait_written"]


def to_host(tree):
    """A copy of ``tree`` (dicts, lists, tuples of tensors and scalars) with
    every tensor detached and cloned into CPU memory."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


class TrainCheckpointer:
    """Step-numbered checkpoints under ``directory`` with the JAX
    interface: ``save``, ``restore``, ``latest_step``, ``all_steps``,
    ``wait``, ``close``."""

    FILE = "state.pt"

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self.async_save = async_save
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _write(self, step: int, tree) -> None:
        d = os.path.join(self.directory, str(step))
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, self.FILE + ".tmp")
        torch.save(tree, tmp)
        os.replace(tmp, os.path.join(d, self.FILE))
        for old in self.all_steps()[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    def _run(self, step: int, tree) -> None:
        try:
            self._write(step, tree)
        except BaseException as e:  # re-raised by wait()
            self._error = e

    def save(self, step: int, tree) -> None:
        """Save ``tree`` at ``step``: the host copy is taken before this
        returns; the write runs on a thread when ``async_save``."""
        self.wait()
        host = to_host(tree)
        if not self.async_save:
            self._write(step, host)
            return
        self._thread = threading.Thread(target=self._run, args=(step, host), daemon=True)
        self._thread.start()

    def restore(self, tree_like=None, step: Optional[int] = None):
        """The tree saved at ``step`` (default: the latest), on the CPU;
        with ``tree_like`` every tensor is moved to the device and dtype of
        its counterpart there (a missing or extra key raises)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        tree = torch.load(os.path.join(self.directory, str(step), self.FILE),
                          map_location="cpu", weights_only=True)
        return tree if tree_like is None else _like(tree, tree_like)

    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(os.path.join(self.directory, n,
                                                                     self.FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Block until the pending write is on disk (re-raising its error)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def close(self) -> None:
        self.wait()


def wait_written(ck: TrainCheckpointer) -> None:
    """Before any rank reads: the writer (rank 0) drains its pending save,
    then every rank of the process group meets it."""
    ck.wait()
    if dist.is_initialized():
        dist.barrier()


def _like(tree, like):
    if isinstance(like, torch.Tensor):
        return tree.to(device=like.device, dtype=like.dtype)
    if isinstance(like, dict):
        if set(tree) != set(like):
            raise KeyError(f"checkpoint keys differ: missing {sorted(set(like) - set(tree))[:5]}"
                           f", unexpected {sorted(set(tree) - set(like))[:5]}")
        return {k: _like(tree[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_like(a, b) for a, b in zip(tree, like))
    return tree


def save_model_pt(params: Params, path: str, info: Optional[dict] = None) -> str:
    """Reference-format model export: a ``.pt`` state dict plus a yaml info
    sidecar (train_utils.py:195-214).  The trainers call it on rank 0."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    save_torch_checkpoint(params, path)
    if info is not None:
        with open(os.path.splitext(path)[0] + ".yaml", "w") as f:
            for k, v in sorted(info.items()):
                f.write(f"{k}: {v}\n")
    return path


def load_model_pt(path: str) -> Params:
    return load_torch_checkpoint(path)
