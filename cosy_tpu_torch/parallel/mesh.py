"""The (dp, seq, model) mesh of ranks, the process group behind it, and
data-parallel batch sharding (the port of the JAX package's
``parallel/mesh.py``).

The JAX package runs one controller over every device, and GSPMD inserts
the collectives.  Here one process drives one device (``torchrun
--nproc-per-node N``): :func:`init_distributed` joins the process group
torchrun describes, and :func:`make_mesh` lays the world out as JAX's
``(dp, seq, model)`` mesh, a ``DeviceMesh`` with those dimension names.
Without a launcher the world is one process, the mesh has one member and
no process group is needed, as a JAX mesh of one device.

Data parallelism keeps every rank on its own rows of each micro-batch.
Two rules make a run over dp ranks equal the run over one:

- **Draw the whole batch, keep the rows.**  JAX draws over the global
  batch array, so a sharded run draws what the replicated run draws.
  Under :func:`batch_rows` every draw whose axis 0 is the batch
  (:func:`draw_rows`) takes the whole batch's numbers from the shared
  generator and keeps this rank's rows, so every rank's generator
  advances alike and its rows get the numbers the single process gives
  them.
- **Batch-wide denominators.**  A masked mean divides by a count over the
  whole batch: :func:`rows_denominator` turns a rank's count into the
  batch's count over dp, so the dp-mean of the ranks' quotients is the
  global quotient, the rule every trainer's gradient mean relies on.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..params import resolve_device
from . import comm

AXES = ("dp", "seq", "model")
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """Whether a launcher (torchrun) described a process group."""
    return all(v in os.environ for v in LAUNCHER_VARS)


def init_distributed(device=None) -> torch.device:
    """Join the process group of torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
    return this rank's device: ``cuda:LOCAL_RANK`` over NCCL, or the CPU
    over gloo when ``device`` is ``cpu``.  Without those variables the
    world is this one process and no group is made.  A group that cannot
    be made raises; nothing falls back to the CPU or to a world of one."""
    dev = resolve_device(device)
    if not launched():
        return dev
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]),
                                device_id=dev if dev.type == "cuda" else None)
    return dev


def finish_distributed() -> None:
    """Leave the process group :func:`init_distributed` joined under a
    launcher (a no-op otherwise)."""
    if launched() and dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    """This rank (a launcher's ``RANK`` before the group is joined)."""
    return dist.get_rank() if dist.is_initialized() else int(os.environ.get("RANK", 0))


def is_main() -> bool:
    """Rank 0 logs and writes the exports and checkpoints."""
    return world_rank() == 0


class Mesh:
    """JAX's ``Mesh`` with axes ``("dp", "seq", "model")``, over the
    process group.  ``shape`` maps an axis to its size; ``group(axis)`` is
    this rank's process group along the axis (None for a size-1 axis, so
    its collectives are skipped), ``coord(axis)`` its index there.
    ``device_mesh`` is the ``torch.distributed.DeviceMesh`` (None in a
    world of one without a process group)."""

    axis_names = AXES

    def __init__(self, dp: int, seq: int, model: int, device: torch.device):
        self.shape: Dict[str, int] = {"dp": dp, "seq": seq, "model": model}
        self.device = device
        n = dp * seq * model
        if n != world_size():
            raise ValueError(f"a (dp {dp}, seq {seq}, model {model}) mesh needs {n} ranks; "
                             f"the world has {world_size()}")
        self.device_mesh = None
        if dist.is_initialized():
            from torch.distributed.device_mesh import init_device_mesh

            self.device_mesh = init_device_mesh(device.type, (dp, seq, model),
                                                mesh_dim_names=AXES)

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def coord(self, axis: str) -> int:
        if self.device_mesh is None or self.shape[axis] == 1:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        if self.device_mesh is None or self.shape[axis] == 1:
            return None
        return self.device_mesh.get_group(axis)

    @property
    def world(self) -> int:
        return self.shape["dp"] * self.shape["seq"] * self.shape["model"]

    def __repr__(self) -> str:
        return f"Mesh(dp={self.shape['dp']}, seq={self.shape['seq']}, model={self.shape['model']})"


def make_mesh(dp: Optional[int] = None, model: int = 1, seq: int = 1,
              device=None) -> Mesh:
    """(dp, seq, model) mesh over the world; ``dp`` defaults to
    ``world // (model * seq)``.  ``device`` defaults to this rank's CUDA
    device (the CPU under a gloo group)."""
    if device is None:
        backend = dist.get_backend() if dist.is_initialized() else None
        device = (torch.device("cpu") if backend == "gloo"
                  else torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else resolve_device(None))
    device = torch.device(device)
    dp = dp if dp is not None else world_size() // (model * seq)
    return Mesh(dp, seq, model, device)


# ---------------------------------------------------------------------------
# batch sharding
# ---------------------------------------------------------------------------


def dp_rows(mesh: Optional[Mesh], batch: int) -> Tuple[int, int]:
    """This rank's rows [lo, hi) of a global batch of ``batch`` rows."""
    dp = 1 if mesh is None else mesh.size("dp")
    if batch % dp:
        raise ValueError(f"a batch of {batch} rows does not split over dp {dp}")
    n = batch // dp
    lo = (0 if mesh is None else mesh.coord("dp")) * n
    return lo, lo + n


def batch_sharding(mesh: Mesh, batch_axis: int = 0) -> Tuple[Optional[str], ...]:
    """The layout of a batch: ``batch_axis`` split over dp, the rest whole
    (the spec JAX's ``batch_sharding`` builds)."""
    spec = [None] * (batch_axis + 1)
    spec[batch_axis] = "dp"
    return tuple(spec)


def replicated(mesh: Mesh) -> Tuple[Optional[str], ...]:
    """The layout of a whole (unsplit) tensor."""
    return ()


def shard_batch(mesh: Mesh, batch: dict, batch_axis: int = 0) -> dict:
    """This rank's rows of a host batch: ``batch_axis`` split over dp.
    Super-batches (accum, B, ...) split axis 1, so every micro-step is
    data-parallel."""
    B = next(iter(batch.values())).shape[batch_axis]
    lo, hi = dp_rows(mesh, B)
    return {k: np.take(np.asarray(v), np.arange(lo, hi), axis=batch_axis)
            for k, v in batch.items()}


def replicate_tree(mesh: Mesh, tree):
    """Rank 0's tensors on every rank (in place, a broadcast over the
    world); the identity in a world of one."""
    if world_size() == 1:
        return tree
    if isinstance(tree, torch.Tensor):
        with torch.no_grad():
            dist.broadcast(tree.data, src=0)
        return tree
    if isinstance(tree, dict):
        return {k: replicate_tree(mesh, v) for k, v in tree.items()}
    return tree


# ---------------------------------------------------------------------------
# the rows of a data-parallel micro-batch
# ---------------------------------------------------------------------------

_rows = threading.local()


@contextmanager
def batch_rows(mesh: Optional[Mesh], lo: int, hi: int, total: int):
    """Within: this rank computes rows [lo, hi) of a batch of ``total``
    rows, over ``mesh``'s dp axis."""
    prev = getattr(_rows, "v", None)
    _rows.v = None if (mesh is None or mesh.size("dp") == 1) else (mesh, lo, hi, total)
    try:
        yield
    finally:
        _rows.v = prev


def current_rows():
    """(mesh, lo, hi, total) of the active :func:`batch_rows`, or None."""
    return getattr(_rows, "v", None)


def draw_rows(draw: Callable[[Sequence[int]], torch.Tensor],
              shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)`` for a tensor whose axis 0 is this rank's rows: under
    :func:`batch_rows` it draws the whole batch's ``(total, *shape[1:])``
    and keeps rows [lo, hi)."""
    r = current_rows()
    if r is None:
        return draw(tuple(shape))
    _, lo, hi, total = r
    if shape[0] != hi - lo:
        raise ValueError(f"a draw of {tuple(shape)} under a data-parallel split of rows "
                         f"[{lo}, {hi}) of {total}: axis 0 is not the batch")
    return draw((total, *shape[1:]))[lo:hi]


def rows_denominator(count: torch.Tensor, minimum: Optional[float] = None) -> torch.Tensor:
    """The denominator of a per-rank masked mean: ``count`` summed over dp
    (at least ``minimum``) and divided by the dp size, so the dp-mean of
    the ranks' quotients is the batch-wide quotient; ``count`` (at least
    ``minimum``) outside :func:`batch_rows`."""
    r = current_rows()
    if r is None:
        return count if minimum is None else torch.clamp(count, min=minimum)
    mesh = r[0]
    total = comm.all_reduce_(count.detach().to(torch.float32).clone(), mesh.group("dp"))
    if minimum is not None:
        total = torch.clamp(total, min=minimum)
    return total / mesh.size("dp")


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The whole batch of ``x`` (axis 0 = rows) on every rank, for a
    statistic over the batch (a median); its gradient reaches each rank's
    rows summed over the ranks, so under the dp mean of the trainers it is
    the batch-wide gradient.  ``x`` itself outside :func:`batch_rows`."""
    r = current_rows()
    if r is None:
        return x
    return comm.gather(x, 0, r[0].group("dp"), partial_grad=True)
