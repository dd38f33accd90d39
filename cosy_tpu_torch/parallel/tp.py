"""Tensor parallelism over the ``model`` mesh axis, ZeRO-2's layout over
``dp``, and MoE expert stacking (the port of the JAX package's
``parallel/tp.py``).

The rules are pure functions of a flat torch name, a shape and the axis
sizes; they return the axis a leaf splits along, or None, exactly as the
JAX package's PartitionSpecs place ``"model"`` / ``"dp"``:

- conformer / transformer encoders: ``self_attn.linear_{q,k,v,out}``,
  ``feed_forward[_macaron].w_{1,2}``;
- the estimator's diffusers blocks: ``attn1.to_{q,k,v}``, ``attn1.to_out.0``,
  ``ff.net.0.proj``, ``ff.net.2``;
- Qwen2: ``{q,k,v}_proj`` / ``o_proj``, ``gate_proj`` / ``up_proj`` /
  ``down_proj``;
- stacked MoE experts (``.experts_stacked.``) along the expert axis.

Row modules split their weight's output dimension (axis 0, the bias with
it), column modules their input dimension (axis 1, the bias whole).  A leaf
splits only where its dimension divides by the axis size; the rest stay
whole, so any size is valid.

Where GSPMD inserts the collectives, the port's ``dense`` does
(:func:`split_dense`): a row-split product computes this rank's output
columns and all-gathers them, a column-split one its slice of the input
and all-reduces the partial sums.  Every activation outside the split
products stays whole, so no other op needs a rule, whatever the head
layout (Qwen2's two KV heads split at 4 ranks into half heads, as in the
JAX package).
"""

from __future__ import annotations

import re
import threading
from contextlib import contextmanager
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import comm

# module-name suffixes whose .weight (torch (out, in)) splits the OUTPUT dim
# (axis 0); their .bias splits with them
ROW_MODULES = (
    ".self_attn.linear_q",
    ".self_attn.linear_k",
    ".self_attn.linear_v",
    ".feed_forward.w_1",
    ".feed_forward_macaron.w_1",
    ".attn1.to_q",
    ".attn1.to_k",
    ".attn1.to_v",
    ".ff.net.0.proj",
    ".q_proj",
    ".k_proj",
    ".v_proj",
    ".gate_proj",
    ".up_proj",
)

# module-name suffixes whose .weight splits the INPUT dim (axis 1); the bias
# adds after the cross-rank sum, so it stays whole
COL_MODULES = (
    ".self_attn.linear_out",
    ".feed_forward.w_2",
    ".feed_forward_macaron.w_2",
    ".attn1.to_out.0",
    ".ff.net.2",
    ".o_proj",
    ".down_proj",
)

Spec = Tuple[Optional[str], ...]


def tp_spec(name: str, shape: Sequence[int], tp: int) -> Optional[int]:
    """The axis of one flat torch-named parameter that splits over a
    ``model`` axis of size ``tp``, or None (whole)."""
    shape = tuple(shape)
    if tp <= 1 or not shape:
        return None
    if ".experts_stacked." in name:
        return 0 if shape[0] % tp == 0 and shape[0] >= tp else None
    for mod in ROW_MODULES:
        if name.endswith(mod + ".weight") or name.endswith(mod + ".bias"):
            return 0 if shape[0] % tp == 0 and shape[0] >= tp else None
    for mod in COL_MODULES:
        if name.endswith(mod + ".weight"):
            if len(shape) >= 2 and shape[1] % tp == 0 and shape[1] >= tp:
                return 1
            return None
    return None


def norm_spec(spec: Sequence[Optional[str]]) -> Spec:
    """A layout without its trailing whole axes (``()`` = whole)."""
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _spec(ndim: int, placed: Dict[int, str]) -> Spec:
    return norm_spec(placed.get(a) for a in range(ndim))


def tp_param_shardings(mesh, params: Dict[str, torch.Tensor]) -> Dict[str, Spec]:
    """Per-leaf layouts (``("model", None)``-style specs; ``()`` = whole)
    of a flat param dict at the mesh's ``model`` size."""
    tp = mesh.size("model")
    out = {}
    for name, x in params.items():
        axis = tp_spec(name, tuple(x.shape), tp)
        out[name] = _spec(x.dim(), {} if axis is None else {axis: "model"})
    return out


def count_sharded(layout: Dict[str, object]) -> int:
    """How many leaves split over the model axis: of a :func:`shard_params`
    layout (name -> axis or None) or of :func:`tp_param_shardings`' specs."""
    return sum(1 for s in layout.values()
               if ("model" in s if isinstance(s, tuple) else s is not None))


def shard_params(mesh, params: Dict[str, torch.Tensor]
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Optional[int]]]:
    """(this rank's params, the layout): a leaf that :func:`tp_spec` splits
    at the mesh's ``model`` size becomes this rank's block of it (a copy, so
    the whole tensor can be freed), every other leaf stays whole.  The
    layout maps each name to its split axis or None, as
    :func:`tensor_parallel` takes it.  An int8 weight's ``.weight@scale``
    sibling is whole, as in the JAX package's layout: a row-split product
    takes this rank's rows of it (:func:`split_dense`)."""
    tp, rank = mesh.size("model"), mesh.coord("model")
    local, layout = {}, {}
    for name, x in params.items():
        axis = tp_spec(name, tuple(x.shape), tp)
        layout[name] = axis
        local[name] = x if axis is None else comm.local_slice(x, axis, rank, tp).clone()
    return local, layout


def compose_zero2(mesh, params: Dict[str, torch.Tensor],
                  base: Optional[Dict[str, Spec]] = None) -> Dict[str, Spec]:
    """ZeRO-2 on top of a tensor-parallel layout: one more free axis of each
    leaf splits over dp where it divides; leaves keep their model split.
    With ``base=None`` this is the plain ZeRO-2 rule, per name."""
    dp = mesh.size("dp")
    out = {}
    for name, x in params.items():
        shape = tuple(x.shape)
        spec = list(base[name] if base else ()) + [None] * len(shape)
        spec = spec[:len(shape)]
        if dp > 1:
            for axis, dim in enumerate(shape):
                if spec[axis] is None and dim % dp == 0 and dim >= dp:
                    spec[axis] = "dp"
                    break
        out[name] = norm_spec(spec)
    return out


def stack_experts(params: Dict[str, torch.Tensor], n_expert: int) -> Dict[str, torch.Tensor]:
    """Per-expert MoE weights (``...experts.{i}.w_1.weight``, the torch
    naming) -> the stacked layout (``...experts_stacked.w_1.weight`` of
    shape (E, ...)) that ``layers.conformer.moe_ffn`` reads and the expert
    rule splits.  Other leaves pass through."""
    out = dict(params)
    pat = re.compile(r"^(.*\.experts)\.0\.(w_[12]\.(?:weight|bias))$")
    for name in list(params):
        m = pat.match(name)
        if not m:
            continue
        prefix, leaf = m.group(1), m.group(2)
        out[f"{prefix}_stacked.{leaf}"] = torch.stack(
            [params[f"{prefix}.{i}.{leaf}"] for i in range(n_expert)])
        for i in range(n_expert):
            out.pop(f"{prefix}.{i}.{leaf}")
    return out


def spec_axis(spec: Spec, axis_name: str) -> Optional[int]:
    return spec.index(axis_name) if axis_name in spec else None


def local_shard(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec``."""
    for axis, name in enumerate(spec):
        if name is not None:
            x = comm.local_slice(x, axis, mesh.coord(name), mesh.size(name))
    return x


def gather_whole(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block (every rank of the axes in
    ``spec`` takes part; no autograd)."""
    for axis, name in enumerate(spec):
        if name is not None and mesh.size(name) > 1:
            x = comm.all_gather_cat(x, axis, mesh.group(name))
    return x


# ---------------------------------------------------------------------------
# the split products: a P that carries a Split runs them
# ---------------------------------------------------------------------------


class Split(NamedTuple):
    """What a :class:`~cosy_tpu_torch.params.P` over split weights carries:
    the model axis' group and each split leaf's flat name -> its axis."""
    group: object
    layout: Dict[str, int]


def make_split(mesh, layout: Dict[str, Optional[int]]) -> Optional[Split]:
    """The Split of ``layout`` (name -> axis or None) over ``mesh``'s model
    axis, or None when nothing splits (a world of one)."""
    split = {k: a for k, a in layout.items() if a is not None}
    return Split(mesh.group("model"), split) if split and mesh.size("model") > 1 else None


_state = threading.local()


def active() -> Optional[Split]:
    """The Split a ``P`` built from a plain dict takes (see
    :func:`tensor_parallel`)."""
    return getattr(_state, "v", None)


@contextmanager
def tensor_parallel(mesh, layout: Dict[str, Optional[int]]):
    """Within: a ``P`` built from a plain dict carries ``layout``'s Split, so
    its ``dense`` (or ``moe_ffn``) over a split weight reads this rank's
    block and runs the split product over ``mesh``'s model axis.  The
    trainers build their views inside it; a server's pipelines hold split
    views (``infer/pipeline.py shard_pipeline``) and need no context."""
    prev = active()
    _state.v = make_split(mesh, layout)
    try:
        yield
    finally:
        _state.v = prev


@contextmanager
def suspended():
    """Within: a ``P`` built from a plain dict is whole (the pipeline's
    stages run whole blocks)."""
    prev = active()
    _state.v = None
    try:
        yield
    finally:
        _state.v = prev


def split_axis(p, key: str) -> Optional[int]:
    """The split axis of ``p[key]``, or None (whole)."""
    return None if p.split is None else p.split.layout.get(p.full(key))


def gather_weights(p, keys: Sequence[str]) -> List[torch.Tensor]:
    """The whole tensors ``p[k]`` of ``keys``: this rank's blocks of the
    split ones, packed into one all-gather over the model axis, set back
    in place."""
    ws = [p[k] for k in keys]
    axes = [split_axis(p, k) for k in keys]
    idx = [i for i, a in enumerate(axes) if a is not None]
    if not idx:
        return ws
    group = p.split.group
    parts = comm.all_gather_cat(torch.cat([ws[i].reshape(-1) for i in idx]), 0,
                                group).chunk(comm.group_size(group))
    at = 0
    for i in idx:
        n = ws[i].numel()
        ws[i] = torch.cat([q[at:at + n].view(ws[i].shape) for q in parts], dim=axes[i])
        at += n
    return ws


def split_dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                axis: int, group, scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ W^T + b`` with ``W`` split over the model axis' ``group``:
    ``axis`` 0 (output columns) computes this rank's columns and all-gathers
    them; ``axis`` 1 (input dim) multiplies this rank's slice of ``x`` and
    all-reduces the partial sums, then adds the whole bias.  ``scale``: the
    whole per-output-channel scales of an int8 ``W`` (cast to x's dtype),
    applied before the bias: a row split takes this rank's rows of them."""
    if axis == 0:
        x = comm.grad_sum(x, group)
        if scale is None:
            y = F.linear(x, w, b)
        else:
            rows = comm.local_slice(scale, 0, comm.group_rank(group), comm.group_size(group))
            y = F.linear(x, w) * rows
            y = y if b is None else y + b
        return comm.gather(y, y.dim() - 1, group)
    y = F.linear(comm.split(x, x.dim() - 1, group), w)
    y = comm.reduce_sum(y, group)
    y = y if scale is None else y * scale
    return y if b is None else y + b
