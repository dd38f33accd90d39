"""Pipeline parallelism: a GPipe schedule of a transformer block stack over
the ``model`` mesh axis (the port of the JAX package's
``parallel/pp.py``).

The layer parameters are stacked over a leading (L, ...) axis and stage s
of S runs blocks [s L/S, (s+1) L/S).  At tick t stage s runs microbatch
t - s through its blocks and hands the activation to stage s + 1; M
microbatches drain in M + S - 1 ticks, a bubble of (S - 1) / (M + S - 1).
The math is the sequential stack's: the same blocks in the same order.

The JAX package differentiates through ``scan`` + ``ppermute``.  In eager
PyTorch a cross-rank hand-off inside one autograd graph would leave the
order of the backward collectives to each rank's autograd engine, and
stage 0's hand-offs do not chain, so the ranks could pair them
differently.  The port therefore runs the schedule as one autograd
function (:class:`_GPipe`): its forward keeps every stage-local graph,
its backward walks the ticks in reverse, each stage back-propagating its
microbatches and handing the input gradients to stage s - 1, all in one
order that every rank follows.  The hand-offs are all-gathers over the
model group (every rank takes its neighbour's part), so every rank enters
the same collectives.  The output, the input gradient and the stacked
parameters' gradients are summed over the group (``psum`` in JAX), so
every rank holds them whole and the model ranks stay replicas of one
another outside the stack.

Dropout inside the pipelined blocks would need its masks drawn per stage;
the pipeline takes dropout-free blocks only (:func:`maybe_pipeline`
declines the rest), as the JAX package does.
"""

from __future__ import annotations

import re
import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import torch

from ..ctx import EVAL, Ctx
from ..params import P
from . import comm
from . import tp as TP


def stack_layer_params(params: Dict[str, torch.Tensor], prefix: str,
                       n_layers: int) -> Dict[str, torch.Tensor]:
    """Gather per-layer torch-named leaves ``{prefix}{i}.<leaf>`` into
    stacked (L, ...) tensors keyed by ``<leaf>`` (differentiable)."""
    pat = re.compile(re.escape(prefix) + r"0\.(.+)$")
    leaves = [m.group(1) for k in params if (m := pat.match(k))]
    if not leaves:
        raise KeyError(f"no layer-0 leaves under {prefix!r}")
    return {leaf: torch.stack([params[f"{prefix}{i}.{leaf}"] for i in range(n_layers)])
            for leaf in leaves}


def _exchange(send: torch.Tensor, group, src: int) -> torch.Tensor:
    """Every stage's ``send`` gathered; returns stage ``src``'s part (zeros
    for a stage outside the group)."""
    parts = [torch.empty_like(send) for _ in range(comm.group_size(group))]
    torch.distributed.all_gather(parts, send.contiguous(), group=group)
    return parts[src] if 0 <= src < len(parts) else torch.zeros_like(send)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(fctx, xs, attn_bias, pos_emb, run, keys, group, n_micro, *stacked):
        S, s = comm.group_size(group), comm.group_rank(group)
        Ls = stacked[0].shape[0] // S
        local = [w[s * Ls:(s + 1) * Ls].detach().requires_grad_(w.requires_grad)
                 for w in stacked]
        B = xs.shape[0]
        mb = B // n_micro
        x_micro = xs.detach().reshape(n_micro, mb, *xs.shape[1:])
        b_micro = attn_bias.reshape(n_micro, mb, *attn_bias.shape[1:])
        zero = torch.zeros_like(x_micro[0])
        buf, records = zero, {}
        outs: List[torch.Tensor] = [zero] * n_micro
        for t in range(n_micro + S - 1):
            m = t - s
            send = zero
            if 0 <= m < n_micro:
                inp = (x_micro[m] if s == 0 else buf).detach().requires_grad_(True)
                with torch.enable_grad():
                    y = run(dict(zip(keys, local)), inp, b_micro[m], pos_emb)
                records[m] = (inp, y)
                send = y.detach()
                if s == S - 1:
                    outs[m] = send
            buf = _exchange(send, group, s - 1)
        out = torch.cat(outs) if s == S - 1 else torch.zeros_like(xs)
        comm.all_reduce_(out, group)
        fctx.state = (records, local, group, S, s, Ls, n_micro,
                      [tuple(w.shape) for w in stacked])
        return out.reshape(xs.shape)

    @staticmethod
    def backward(fctx, g):
        records, local, group, S, s, Ls, M, shapes = fctx.state
        fctx.state = None
        mb = g.shape[0] // M
        g_micro = g.reshape(M, mb, *g.shape[1:])
        zero = torch.zeros_like(g_micro[0])
        gw = [torch.zeros_like(w) for w in local]
        trainable = [i for i, w in enumerate(local) if w.requires_grad]
        dx: List[torch.Tensor] = [zero] * M
        recv = zero
        for t in reversed(range(M + S - 1)):
            m = t - s
            send = zero
            if 0 <= m < M:
                inp, y = records.pop(m)
                dy = g_micro[m] if s == S - 1 else recv
                grads = torch.autograd.grad(y, [inp] + [local[i] for i in trainable], dy,
                                            allow_unused=True)
                for i, gi in zip(trainable, grads[1:]):
                    if gi is not None:
                        gw[i] += gi
                send = zero if grads[0] is None else grads[0]
                if s == 0:
                    dx[m] = send
            recv = _exchange(send, group, s + 1 if s < S - 1 else -1)
        dxs = torch.cat(dx) if s == 0 else torch.zeros_like(g)
        comm.all_reduce_(dxs, group)
        full = []
        for w_local, shape in zip(gw, shapes):
            G = torch.zeros(shape, dtype=w_local.dtype, device=w_local.device)
            G[s * Ls:(s + 1) * Ls] = w_local
            full.append(comm.all_reduce_(G, group))
        return (dxs.reshape(g.shape), None, None, None, None, None, None, *full)


def pipeline_blocks(stacked: Dict[str, torch.Tensor], cfg, xs: torch.Tensor,
                    attn_bias: torch.Tensor, pos_emb: torch.Tensor, mesh, n_micro: int,
                    ctx: Ctx = EVAL, axis: str = "model") -> torch.Tensor:
    """The stacked transformer blocks as an S-stage GPipe pipeline over
    ``mesh``'s ``axis``: the sequential stack's value, and its gradients
    into ``stacked`` and ``xs``.  xs (B, T, D), attn_bias (B, 1, T, T) or
    (B, T, T), pos_emb the (1, P, D) relative-position table."""
    from ..layers.conformer import transformer_layer

    if ctx.train and cfg.dropout_rate > 0:
        raise ValueError("pipeline blocks must be dropout-free")
    S = mesh.size(axis)
    keys = list(stacked)
    L = stacked[keys[0]].shape[0]
    if L % S:
        raise ValueError(f"{L} blocks cannot split into {S} stages")
    if xs.shape[0] % n_micro:
        raise ValueError(f"batch {xs.shape[0]} does not split into {n_micro} microbatches")

    def run(weights: Dict[str, torch.Tensor], x, bias, pe):
        with TP.suspended():
            for i in range(L // S):
                wl = P({f"L.{k}": w[i] for k, w in weights.items()})
                x = transformer_layer(wl, "L", cfg, x, bias, pe, ctx)
        return x

    return _GPipe.apply(xs, attn_bias, pos_emb, run, keys, mesh.group(axis), n_micro,
                        *[stacked[k] for k in keys])


def pipeline_encoder_forward(p: P, cfg, xs: torch.Tensor, xs_lens: torch.Tensor, mesh,
                             n_micro: int, ctx: Ctx = EVAL, xscale: bool = True,
                             num_decoding_left_chunks: int = -1,
                             axis: str = "model") -> Tuple[torch.Tensor, torch.Tensor]:
    """The transformer encoder with its block stack pipelined; embedding,
    masks and after_norm run whole on every rank.  Equals
    ``layers.conformer.encoder_forward(conformer=False)``.  Blocks whose
    weights are tensor-parallel blocks are gathered whole first."""
    from ..layers import conformer as C
    from ..ops import masks as M

    B, T, _ = xs.shape
    pad_mask = M.make_non_pad_mask(xs_lens, T)[:, None, :]
    h, pos_emb = C.embed_input(p, cfg, xs, ctx, xscale=xscale)
    chunk_masks = M.add_optional_chunk_mask(
        T, pad_mask, cfg.use_dynamic_chunk, cfg.use_dynamic_left_chunk,
        0, cfg.static_chunk_size, num_decoding_left_chunks)
    attn_bias = M.mask_to_bias(chunk_masks, h.dtype)

    prefix = p.prefix + "encoders."
    # sorted: every rank must hand the pipeline its leaves in one order
    layer_keys = sorted(k for k in p.d.keys() if k.startswith(prefix))
    whole = {}
    for k in layer_keys:
        w = p.d[k]
        a = None if p.split is None else p.split.layout.get(k)
        whole[k] = w if a is None else comm.gather(w, a, p.split.group)
    stacked = stack_layer_params(whole, prefix, cfg.num_blocks)
    h = pipeline_blocks(stacked, cfg, h, attn_bias, pos_emb, mesh, n_micro, ctx, axis)
    if cfg.normalize_before:
        h = C.layer_norm(p, "after_norm", h, eps=1e-5)
    return h, pad_mask


# ---------------------------------------------------------------------------
# context-based activation (as parallel/sp.py): trainers enter
# pipeline_context and layers.conformer.encoder_forward dispatches its
# transformer stack through the pipeline when eligible
# ---------------------------------------------------------------------------

_state = threading.local()


@contextmanager
def pipeline_context(mesh, n_micro: int, axis: str = "model"):
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, n_micro, axis)
    try:
        yield
    finally:
        _state.ctx = prev


def eligible(cfg, batch: int, ctx: Ctx, stages: int, n_micro: int) -> bool:
    """JAX's rules: more than one stage, a stage-divisible block count, a
    microbatch-divisible batch, no dropout and no train-time dynamic chunk
    in training; and no LoRA adapters (the stages read the blocks under
    stacked names, which adapters are not keyed by)."""
    return (stages > 1
            and cfg.num_blocks % stages == 0
            and batch % n_micro == 0
            and not (ctx.train and (cfg.dropout_rate > 0 or cfg.attention_dropout_rate > 0
                                    or cfg.positional_dropout_rate > 0))
            and not (ctx.train and cfg.use_dynamic_chunk)
            and ctx.lora is None)


def maybe_pipeline(p: P, cfg, xs, xs_lens, ctx: Ctx, xscale: bool,
                   num_decoding_left_chunks: int = -1
                   ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(h, pad_mask) through the pipeline when a pipeline context is active
    and the stack is :func:`eligible`, else None."""
    pc = getattr(_state, "ctx", None)
    if pc is None:
        return None
    mesh, n_micro, axis = pc
    if not eligible(cfg, xs.shape[0], ctx, mesh.size(axis), n_micro):
        return None
    _state.engaged = getattr(_state, "engaged", 0) + 1
    return pipeline_encoder_forward(p, cfg, xs, xs_lens, mesh, n_micro, ctx, xscale=xscale,
                                    num_decoding_left_chunks=num_decoding_left_chunks,
                                    axis=axis)


def engaged() -> int:
    """How many encoder forwards went through the pipeline (diagnostics)."""
    return getattr(_state, "engaged", 0)

