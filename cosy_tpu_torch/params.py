"""Parameters: torch-named module trees, random init and the weight bridge.

Every model of the port is an ``nn.Module`` tree whose ``state_dict()`` keys
are exactly the flat torch names the JAX package keys its param dicts by
(``decoder.estimator.down_blocks.0.1.0.attn1.to_q.weight``,
``llm.encoders.3.self_attn.linear_pos.weight``), numbered parts being
``nn.ModuleList``s.  Moving weights across is therefore an identity map:
``from_numpy`` turns a flat numpy dict into tensors that
``load_state_dict(..., strict=True)`` accepts.

The math lives in plain functions that read a module's parameters through
``P``, a prefixed view over its flat ``{name: tensor}`` dict.
"""

from __future__ import annotations

import json
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .parallel import tp as _tp

Params = Dict[str, torch.Tensor]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (or defaulted) and absent —
    there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cosy_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


class P:
    """Cheap prefixed view over a flat param dict.

    ``P(params, "encoder.")["embed.out.0.weight"]`` reads
    ``params["encoder.embed.out.0.weight"]``.

    ``split``: a ``parallel.tp.Split`` when some of the leaves are this
    rank's blocks of tensor-parallel weights (``dense`` runs their split
    products), else None.  A view of a ``P`` keeps its split; a ``P`` of a
    plain dict takes the one of an enclosing ``parallel.tp.tensor_parallel``.
    """

    __slots__ = ("d", "prefix", "split")

    def __init__(self, d, prefix: str = "", split=None):
        if isinstance(d, P):
            prefix = d.prefix + prefix
            split = d.split if split is None else split
            d = d.d
        elif split is None:
            split = _tp.active()
        self.d = d
        self.prefix = prefix
        self.split = split

    def __getitem__(self, key: str) -> torch.Tensor:
        return self.d[self.prefix + key]

    def get(self, key: str, default=None):
        return self.d.get(self.prefix + key, default)

    def full(self, key: str) -> str:
        """The flat name of ``key`` (LoRA adapters are keyed by it)."""
        return self.prefix + key

    def sub(self, key: str) -> "P":
        return P(self, key + ".")


# ---------------------------------------------------------------------------
# Parameter specs (torch-compatible default initializers)
# ---------------------------------------------------------------------------


Init = Callable[[torch.Tensor, torch.Generator], None]


def _uniform(bound: float) -> Init:
    def fill(t, g):
        t.uniform_(-bound, bound, generator=g)
    return fill


def _kaiming_uniform(fan_in: int, a: float = math.sqrt(5)) -> Init:
    gain = math.sqrt(2.0 / (1 + a * a))
    return _uniform(gain * math.sqrt(3.0 / fan_in))


def _const(value: float) -> Init:
    def fill(t, g):
        t.fill_(value)
    return fill


def _normal(t, g):
    t.normal_(generator=g)


class Spec:
    """Ordered ``name -> (shape, initializer)`` table; the port's init_*
    functions fill one with the same names and shapes as the JAX inits."""

    def __init__(self):
        self.entries: Dict[str, Tuple[Tuple[int, ...], Init]] = {}

    def add(self, name: str, shape, init: Init):
        self.entries[name] = (tuple(int(s) for s in shape), init)

    def linear(self, name: str, in_f: int, out_f: int, bias: bool = True):
        self.add(name + ".weight", (out_f, in_f), _kaiming_uniform(in_f))
        if bias:
            self.add(name + ".bias", (out_f,), _uniform(1.0 / math.sqrt(in_f)))

    def conv1d(self, name: str, in_c: int, out_c: int, kernel: int,
               groups: int = 1, bias: bool = True):
        fan_in = (in_c // groups) * kernel
        self.add(name + ".weight", (out_c, in_c // groups, kernel),
                 _kaiming_uniform(fan_in))
        if bias:
            self.add(name + ".bias", (out_c,), _uniform(1.0 / math.sqrt(fan_in)))

    def conv_transpose1d(self, name: str, in_c: int, out_c: int, kernel: int):
        fan_in = out_c * kernel  # torch: weight (in, out, k), fan_in from dim 1
        self.add(name + ".weight", (in_c, out_c, kernel), _kaiming_uniform(fan_in))
        self.add(name + ".bias", (out_c,), _uniform(1.0 / math.sqrt(fan_in)))

    def zeros(self, name: str, shape):
        self.add(name, shape, _const(0.0))

    def norm(self, name: str, dim: int):
        self.add(name + ".weight", (dim,), _const(1.0))
        self.add(name + ".bias", (dim,), _const(0.0))

    def embedding(self, name: str, vocab: int, dim: int):
        self.add(name + ".weight", (vocab, dim), _normal)


class _Slot(nn.Module):
    """Parameter-free placeholder for a numbered part that holds no weights
    (an activation or dropout in the reference's ``nn.Sequential``)."""


def _child(parent: nn.Module, key: str, as_list: bool) -> nn.Module:
    if isinstance(parent, nn.ModuleList):
        i = int(key)
        while len(parent) <= i:
            parent.append(_Slot())
        cur = parent[i]
        if isinstance(cur, _Slot):
            cur = nn.ModuleList() if as_list else nn.Module()
            parent[i] = cur
        return cur
    cur = getattr(parent, key, None)
    if cur is None:
        cur = nn.ModuleList() if as_list else nn.Module()
        parent.add_module(key, cur)
    return cur


class ParamTree(nn.Module):
    """An ``nn.Module`` tree built from a :class:`Spec`: one submodule per
    dotted name component, ``nn.ModuleList`` wherever the children are
    numbered, so ``state_dict()`` keys equal the spec's names.

    ``device="meta"`` allocates nothing (shape checks at full width); any
    other device draws the torch default init from ``generator``."""

    def __init__(self, spec: Spec, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)
        self.add_spec(spec, dev, dtype, generator)

    def add_spec(self, spec: Spec, device, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        """Register (frozen) the parameters of ``spec``, drawn from
        ``generator`` unless ``device`` is meta."""
        dev = torch.device(device)
        for name, (shape, init) in spec.entries.items():
            parts = name.split(".")
            mod: nn.Module = self
            for i, key in enumerate(parts[:-1]):
                mod = _child(mod, key, parts[i + 1].isdigit())
            t = torch.empty(shape, device=dev, dtype=torch.float32)
            if dev.type != "meta":
                init(t, generator)
            mod.register_parameter(
                parts[-1], nn.Parameter(t.to(dtype), requires_grad=False))

    @property
    def p(self) -> P:
        """Flat ``{state_dict name: tensor}`` view the math functions read."""
        return P(dict(self.named_parameters()))


def spec_tensors(spec: Spec, device=None, generator: Optional[torch.Generator] = None
                 ) -> Params:
    """The entries of ``spec`` as a flat dict of f32 tensors on ``device``,
    drawn from ``generator``."""
    dev = resolve_device(device)
    out: Params = {}
    for name, (shape, init) in spec.entries.items():
        t = torch.empty(shape, device=dev, dtype=torch.float32)
        init(t, generator)
        out[name] = t
    return out


# ---------------------------------------------------------------------------
# Weight bridge
# ---------------------------------------------------------------------------


def from_numpy(flat: Dict[str, np.ndarray], device=None,
               dtype=torch.float32) -> Params:
    """Flat numpy dict (e.g. a JAX param dict through ``np.asarray``) ->
    tensors for ``load_state_dict(..., strict=True)``."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dev, dtype)
            for k, v in flat.items()}


def fold_weight_norm(params: Params) -> Params:
    """Fold torch weight_norm factorizations into plain ``.weight`` keys
    (HiFT checkpoints store g/v pairs): ``w = g * v / ||v||`` with the norm
    over every dim but 0.  Handles the parametrize-API names
    (``X.parametrizations.weight.original0/1``) and the legacy
    ``X.weight_g`` / ``X.weight_v``."""
    out: Params = {}
    handled = set()
    for k in params:
        if k.endswith(".parametrizations.weight.original0"):
            base = k[: -len(".parametrizations.weight.original0")]
            vkey = base + ".parametrizations.weight.original1"
        elif k.endswith(".weight_g"):
            base = k[: -len(".weight_g")]
            vkey = base + ".weight_v"
        else:
            continue
        g, v = params[k], params[vkey]
        norm = torch.sqrt(torch.sum(torch.square(v), dim=tuple(range(1, v.ndim)),
                                    keepdim=True))
        out[base + ".weight"] = g * v / torch.clamp(norm, min=1e-12)
        handled.update((k, vkey))
    for k, v in params.items():
        if k not in handled and k not in out:
            out[k] = v
    return out


def load_torch_checkpoint(path: str) -> Params:
    """Read a reference ``.pt`` state_dict into a flat dict of f32 CPU
    tensors (an identity map: the names already match); a Lightning-style
    ``{"state_dict": ...}`` wrapper is unwrapped."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state and all(
            not isinstance(v, torch.Tensor) or k == "state_dict"
            for k, v in state.items()):
        state = state["state_dict"]
    return {k: v.detach().to(torch.float32) for k, v in state.items()
            if isinstance(v, torch.Tensor)}


def save_torch_checkpoint(params: Params, path: str):
    """Save a flat param dict (tensors or arrays) as a plain ``.pt``
    state_dict of CPU tensors, loadable by the reference and by
    :func:`load_torch_checkpoint`."""
    torch.save({k: (v.detach().cpu() if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.array(v))) for k, v in params.items()}, path)


def save_weight_meta(path: str, **meta):
    """Write the ``<path>.meta.json`` provenance sidecar of a weight file
    (the state dict itself stays a plain ``.pt``): e.g. whether a flow
    checkpoint works in normalized mel space (``mel_space: normalized``
    for fine-tune outputs, ``raw`` for pretrained-space weights), which
    ``serve.resolve_finetuned_norm`` reads."""
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f, indent=0, sort_keys=True)


def load_weight_meta(path: str) -> Optional[dict]:
    """The ``<path>.meta.json`` sidecar, or None when absent or unreadable."""
    try:
        with open(path + ".meta.json") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
