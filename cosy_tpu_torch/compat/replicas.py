"""Synthetic full-graph replicas of the two frozen extractor ONNX graphs.

The reference's data prep depends on two external `.onnx` files from the
pretrained model dir that are not in the repository (reference
cosyvoice/cli/frontend.py:54-63): ``campplus.onnx`` (speaker embedding,
fbank-80 -> 192-d) and ``speech_tokenizer_v1.onnx`` (S3: whisper log-mel-128
-> 50 Hz token ids).  Op-level oracle tests cover every dispatcher op, but
the *composition* — real exporter conventions (Shape/Gather/Unsqueeze/
Concat/Reshape chains, ConstantOfShape padding, decomposed GELU), dozens of
nodes deep — only a whole graph exercises.

This module builds torch modules shaped like the two extractors' public
model definitions (docs/onnx_coverage.md op inventories) and serializes
them to ONNX bytes with the same conventions the stock torch exporter
emits, sharing the torch weights.  tests/test_onnx_ingest.py runs the
serialized graphs through the native runtime (compat/onnx.py) against the
torch forward and asserts tools/onnx_coverage.py reports full coverage.

- campplus replica: CAM++-shaped — Conv2d FCM front-end, D-TDNN dense
  blocks (dilated Conv1d + Concat), context-aware mask gating
  (ReduceMean -> bottleneck 1x1 convs -> Sigmoid), Avg/Max segment
  pooling, attentive statistics pooling, Gemm head.  Reduced width
  (the real graph is ~7.2 M params).
- S3 replica: whisper-style — Conv1d stem with stride-2 subsampling and
  erf-decomposed GELU, sliced positional table, pre-LN transformer blocks
  (qkv MatMul + Split + Softmax) with a length mask (Range/Less/Where),
  and a VQ head (squared-distance ArgMin + codebook Gather).

The port's copy of the JAX package's ``compat/replicas.py``: the same
seeds give the same bytes.  The port builds the replica graphs itself
(``chip_smoke.py``, the tests) rather than committing them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .onnx_export import GraphBuilder

F32 = np.float32


# ---------------------------------------------------------------------------
# exporter-convention helpers
# ---------------------------------------------------------------------------


def _dim(g: GraphBuilder, x: str, axis: int) -> str:
    """scalar int64 dim as the exporter emits it: Shape -> Gather(axis)."""
    sh = g.add("Shape", [x])
    return g.add("Gather", [sh, g.const(np.asarray(axis, np.int64))], axis=0)


def _dim1(g: GraphBuilder, x: str, axis: int) -> str:
    """(1,)-shaped int64 dim: Shape -> Gather -> Unsqueeze (Concat fodder)."""
    return g.add("Unsqueeze", [_dim(g, x, axis), g.const(np.asarray([0], np.int64))])


def _reshape_dyn(g: GraphBuilder, x: str, dims: List) -> str:
    """Reshape with the exporter's dynamic-shape chain: each int entry
    becomes a (1,) const, each str entry is a (1,) dim tensor; Concat ->
    Reshape."""
    parts = [d if isinstance(d, str)
             else g.const(np.asarray([d], np.int64)) for d in dims]
    shape = g.add("Concat", parts, axis=0)
    return g.add("Reshape", [x, shape])


def _gelu_erf(g: GraphBuilder, x: str) -> str:
    """The stock exporter's decomposition of F.gelu (exact/erf form):
    x * 0.5 * (1 + Erf(x / sqrt(2)))."""
    h = g.add("Div", [x, g.const(np.asarray(np.sqrt(2.0), F32))])
    h = g.add("Erf", [h])
    h = g.add("Add", [h, g.const(np.asarray(1.0, F32))])
    h = g.add("Mul", [x, h])
    return g.add("Mul", [h, g.const(np.asarray(0.5, F32))])


def _t(x) -> np.ndarray:
    return x.detach().cpu().numpy().astype(F32)


# ---------------------------------------------------------------------------
# campplus replica
# ---------------------------------------------------------------------------


def make_campplus_replica(seed: int = 0, n_mels: int = 80, fcm_ch: int = 32,
                          ch: int = 128, growth: int = 64, emb: int = 192):
    """Returns (torch_module, onnx_bytes).  Input (B, T, n_mels) f32
    (mean-normed kaldi fbank, frontend.py:143-152); output (B, emb)."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as Fn

    torch.manual_seed(seed)

    class CampPlusReplica(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(1, fcm_ch, 3, stride=(2, 1), padding=1)
            self.bn1 = nn.BatchNorm2d(fcm_ch)
            self.conv2 = nn.Conv2d(fcm_ch, fcm_ch, 3, stride=(2, 1), padding=1)
            self.bn2 = nn.BatchNorm2d(fcm_ch)
            flat = fcm_ch * (n_mels // 4)
            self.head = nn.Conv1d(flat, ch, 5, stride=2, padding=2)
            self.head_bn = nn.BatchNorm1d(ch)
            cur = ch
            self.dense, self.dense_bn = nn.ModuleList(), nn.ModuleList()
            for dil in (1, 2, 3):  # D-TDNN dense connections
                self.dense.append(nn.Conv1d(cur, growth, 3, dilation=dil,
                                            padding=dil))
                self.dense_bn.append(nn.BatchNorm1d(growth))
                cur += growth
            self.cur = cur
            # CAM gate (context-aware masking): global ctx -> bottleneck
            self.gate1 = nn.Conv1d(2 * cur, cur // 4, 1)
            self.gate2 = nn.Conv1d(cur // 4, 2 * cur, 1)
            # attentive statistics pooling
            self.att1 = nn.Conv1d(2 * cur, cur // 2, 1)
            self.att2 = nn.Conv1d(cur // 2, 2 * cur, 1)
            self.out = nn.Linear(4 * cur, emb)

        def forward(self, x):  # (B, T, n_mels)
            h = x.transpose(1, 2).unsqueeze(1)  # (B, 1, F, T)
            h = torch.relu(self.bn1(self.conv1(h)))
            h = torch.relu(self.bn2(self.conv2(h)))  # (B, C, F/4, T)
            B = h.shape[0]
            h = h.reshape(B, h.shape[1] * h.shape[2], -1)  # (B, C*F/4, T)
            h = torch.relu(self.head_bn(self.head(h)))  # (B, ch, T2)
            h = Fn.pad(h, (0, 1))  # ConstantOfShape+Concat in the graph
            for conv, bn in zip(self.dense, self.dense_bn):
                h = torch.cat([h, torch.relu(bn(conv(h)))], dim=1)
            # segment pooling branches (stride-2 avg + max), time-aligned
            a = Fn.avg_pool1d(h, 2, stride=2)
            m = Fn.max_pool1d(h, 2, stride=2)
            s = torch.cat([a, m], dim=1)[:, :, 1:]  # Slice: drop seg 0
            ctx = s.mean(dim=2, keepdim=True)  # (B, 2C, 1)
            gate = torch.sigmoid(self.gate2(torch.relu(self.gate1(ctx))))
            s = s * gate
            # attentive stats pooling
            w = torch.softmax(self.att2(torch.tanh(self.att1(s))), dim=2)
            mean = (w * s).sum(dim=2, keepdim=True)  # (B, 2C, 1)
            var = (w * s * s).sum(dim=2, keepdim=True) - mean * mean
            std = torch.sqrt(var + 1e-4)
            stats = torch.cat([mean.flatten(1), std.squeeze(-1)], dim=1)
            return self.out(stats)

    mod = CampPlusReplica().eval()
    with torch.no_grad():
        for bn in [mod.bn1, mod.bn2, mod.head_bn, *mod.dense_bn]:
            bn.running_mean.uniform_(-0.5, 0.5)
            bn.running_var.uniform_(0.5, 2.0)

    # ---- serialize with exporter conventions --------------------------
    g = GraphBuilder()

    def conv(x, m, spatial: int, **kw):
        w = g.const(_t(m.weight), "w")
        b = g.const(_t(m.bias), "b")
        return g.add("Conv", [x, w, b],
                     kernel_shape=list(m.kernel_size) if spatial == 2 else [m.kernel_size[0]],
                     strides=list(m.stride) if spatial == 2 else [m.stride[0]],
                     dilations=list(m.dilation) if spatial == 2 else [m.dilation[0]],
                     pads=(list(m.padding) * 2 if spatial == 2
                           else [m.padding[0]] * 2), **kw)

    def bn(x, m):
        return g.add("BatchNormalization",
                     [x, g.const(_t(m.weight)), g.const(_t(m.bias)),
                      g.const(m.running_mean.numpy().astype(F32)),
                      g.const(m.running_var.numpy().astype(F32))],
                     epsilon=float(m.eps))

    h = g.add("Transpose", ["x"], perm=[0, 2, 1])
    h = g.add("Unsqueeze", [h, g.const(np.asarray([1], np.int64))])
    h = g.add("Relu", [bn(conv(h, mod.conv1, 2), mod.bn1)])
    h = g.add("Relu", [bn(conv(h, mod.conv2, 2), mod.bn2)])
    # (B, C, F/4, T) -> (B, C*F/4, T): dynamic batch dim via Shape/Gather,
    # folded C*F/4 as a const, trailing -1 — the exporter's reshape idiom.
    # A Cast sits on the dim chain like opset-13+ exports carry.
    b_dim = g.add("Cast", [_dim1(g, h, 0)], to=7)  # int64
    h = _reshape_dyn(g, h, [b_dim, fcm_ch * (n_mels // 4), -1])
    h = g.add("Relu", [bn(conv(h, mod.head, 1), mod.head_bn)])
    # F.pad(h, (0, 1)): zeros built by ConstantOfShape over a dim chain
    zshape = g.add("Concat", [_dim1(g, h, 0), _dim1(g, h, 1),
                              g.const(np.asarray([1], np.int64))], axis=0)
    zeros = g.add("ConstantOfShape", [zshape],
                  value=np.zeros((1,), F32))
    h = g.add("Concat", [h, zeros], axis=2)
    for m_conv, m_bn in zip(mod.dense, mod.dense_bn):
        h = g.add("Concat", [h, g.add("Relu", [bn(conv(h, m_conv, 1), m_bn)])],
                  axis=1)
    a = g.add("AveragePool", [h], kernel_shape=[2], strides=[2])
    mx = g.add("MaxPool", [h], kernel_shape=[2], strides=[2])
    s = g.add("Concat", [a, mx], axis=1)
    s = g.add("Slice", [s, g.const(np.asarray([1], np.int64)),
                        g.const(np.asarray([np.iinfo(np.int64).max], np.int64)),
                        g.const(np.asarray([2], np.int64))])
    ctx = g.add("ReduceMean", [s], axes=[2], keepdims=1)
    gate = g.add("Sigmoid", [conv(g.add("Relu", [conv(ctx, mod.gate1, 1)]),
                                  mod.gate2, 1)])
    s = g.add("Mul", [s, gate])
    w_att = g.add("Softmax", [conv(g.add("Tanh", [conv(s, mod.att1, 1)]),
                                   mod.att2, 1)], axis=2)
    mean = g.add("ReduceSum", [g.add("Mul", [w_att, s])], axes=[2], keepdims=1)
    s2 = g.add("Pow", [s, g.const(np.asarray(2.0, F32))])  # s**2
    ex2 = g.add("ReduceSum", [g.add("Mul", [w_att, s2])], axes=[2], keepdims=1)
    var = g.add("Sub", [ex2, g.add("Mul", [mean, mean])])
    # eps via a Constant NODE (exporters emit these alongside initializers)
    eps = g.add("Constant", [], value=np.asarray(1e-4, F32))
    std = g.add("Sqrt", [g.add("Add", [var, eps])])
    stats = g.add("Concat", [g.add("Flatten", [mean], axis=1),
                             g.add("Squeeze", [std, g.const(np.asarray([2], np.int64))])],
                  axis=1)
    g.add("Gemm", [stats, g.const(_t(mod.out.weight)), g.const(_t(mod.out.bias))],
          out_names=["embedding"], transB=1, alpha=1.0, beta=1.0)
    data = g.finish(inputs=[("x", F32, (1, 0, n_mels))],  # dynamic T: dim 0
                    outputs=[("embedding", F32, (1, emb))])
    return mod, data


# ---------------------------------------------------------------------------
# S3 tokenizer replica
# ---------------------------------------------------------------------------


def make_s3_replica(seed: int = 0, n_mels: int = 128, d: int = 128,
                    heads: int = 4, n_layers: int = 2, n_codes: int = 256,
                    dv: int = 64, max_t: int = 512):
    """Returns (torch_module, onnx_bytes).  Inputs: feats (B, n_mels, T)
    f32 whisper log-mel + feats_length (B,) int32 (the real S3 session's
    signature, frontend.py:131-141); output speech_token (B, T//2) int64."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as Fn

    torch.manual_seed(seed + 1)

    class Block(nn.Module):
        def __init__(self):
            super().__init__()
            self.ln1 = nn.LayerNorm(d)
            self.qkv = nn.Linear(d, 3 * d)
            self.proj = nn.Linear(d, d)
            self.ln2 = nn.LayerNorm(d)
            self.fc1 = nn.Linear(d, 4 * d)
            self.fc2 = nn.Linear(4 * d, d)

        def forward(self, x, mask):  # x (B, T, d); mask (B, T) bool valid
            h = self.ln1(x)
            q, k, v = self.qkv(h).split(d, dim=2)
            B, T, _ = h.shape
            dk = d // heads

            def heads_of(t):
                return t.reshape(B, T, heads, dk).permute(0, 2, 1, 3)

            q, k, v = heads_of(q), heads_of(k), heads_of(v)
            scores = (q @ k.transpose(2, 3)) * (dk ** -0.5)
            neg = torch.full_like(scores, -1e9)
            scores = torch.where(mask[:, None, None, :], scores, neg)
            att = torch.softmax(scores, dim=3) @ v  # (B, H, T, dk)
            att = att.permute(0, 2, 1, 3).reshape(B, T, d)
            x = x + self.proj(att)
            h = self.ln2(x)
            return x + self.fc2(Fn.gelu(self.fc1(h)))

    class S3Replica(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv1d(n_mels, d, 3, padding=1)
            self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1)
            self.pos = nn.Parameter(torch.randn(1, max_t, d) * 0.02)
            self.blocks = nn.ModuleList(Block() for _ in range(n_layers))
            self.ln_f = nn.LayerNorm(d)
            self.vq_proj = nn.Linear(d, dv)
            self.codebook = nn.Parameter(torch.randn(n_codes, dv))

        def forward(self, feats, feats_length):
            h = Fn.gelu(self.conv1(feats))
            h = Fn.gelu(self.conv2(h))  # (B, d, T2)
            h = h.transpose(1, 2)  # (B, T2, d)
            T2 = h.shape[1]
            h = h + self.pos[:, :T2]
            lens2 = (feats_length.to(torch.int64) + 1) // 2
            mask = torch.arange(T2)[None, :] < lens2[:, None]
            for blk in self.blocks:
                h = blk(h, mask)
            z = self.vq_proj(self.ln_f(h))  # (B, T2, dv)
            d2 = (z * z).sum(2, keepdim=True) \
                - 2.0 * (z @ self.codebook.t()) \
                + (self.codebook * self.codebook).sum(1)[None, None, :]
            return torch.argmin(d2, dim=2)  # (B, T2) int64

    mod = S3Replica().eval()

    # ---- serialize ----------------------------------------------------
    g = GraphBuilder()

    def linear_ntc(x, m):
        """nn.Linear on (B, T, C): MatMul with transposed weight + Add —
        exactly what the exporter emits for rank-3 inputs."""
        h = g.add("MatMul", [x, g.const(_t(m.weight).T.copy())])
        return g.add("Add", [h, g.const(_t(m.bias))])

    def layer_norm(x, m):
        return g.add("LayerNormalization",
                     [x, g.const(_t(m.weight)), g.const(_t(m.bias))],
                     axis=-1, epsilon=float(m.eps))

    def conv1d(x, m):
        return g.add("Conv", [x, g.const(_t(m.weight)), g.const(_t(m.bias))],
                     kernel_shape=[m.kernel_size[0]], strides=[m.stride[0]],
                     pads=[m.padding[0]] * 2, dilations=[1])

    h = _gelu_erf(g, conv1d("feats", mod.conv1))
    h = _gelu_erf(g, conv1d(h, mod.conv2))
    h = g.add("Transpose", [h], perm=[0, 2, 1])  # (B, T2, d)
    t2 = _dim1(g, h, 1)  # (1,) int64
    # pos table sliced to the dynamic T2 (exporter idiom for pos[:, :T2])
    pos = g.add("Slice", [g.const(_t(mod.pos)),
                          g.const(np.asarray([0], np.int64)), t2,
                          g.const(np.asarray([1], np.int64))])
    h = g.add("Add", [h, pos])
    # valid mask: Range(0, T2) < (len+1)//2  — Range/Cast/Less machinery
    # (len + 1) // 2 as the exporter's Cast/Div/Floor/Cast chain (integer
    # Div on traced tensors would be true division)
    lens64 = g.add("Cast", ["feats_length"], to=7)
    lens_f = g.add("Cast", [g.add("Add", [lens64, g.const(np.asarray(1, np.int64))])],
                   to=1)
    lens2 = g.add("Cast", [g.add("Floor", [g.add(
        "Div", [lens_f, g.const(np.asarray(2.0, F32))])])], to=7)
    rng = g.add("Range", [g.const(np.asarray(0, np.int64)),
                          g.add("Squeeze", [t2, g.const(np.asarray([0], np.int64))]),
                          g.const(np.asarray(1, np.int64))])
    mask = g.add("Less", [g.add("Unsqueeze", [rng, g.const(np.asarray([0], np.int64))]),
                          g.add("Unsqueeze", [lens2, g.const(np.asarray([1], np.int64))])])
    # (B, T2) -> (B, 1, 1, T2) for the score Where
    mask4 = g.add("Unsqueeze", [mask, g.const(np.asarray([1, 2], np.int64))])

    dk = d // heads
    b_dim = _dim1(g, h, 0)
    for blk in mod.blocks:
        x_in = h
        hn = layer_norm(x_in, blk.ln1)
        qkv = linear_ntc(hn, blk.qkv)
        q, k, v = g.add("Split", [qkv, g.const(np.asarray([d, d, d], np.int64))],
                        n_out=3, axis=2)

        def to_heads(t):
            r = _reshape_dyn(g, t, [b_dim, t2, heads, dk])
            return g.add("Transpose", [r], perm=[0, 2, 1, 3])

        qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
        kt = g.add("Transpose", [kh], perm=[0, 1, 3, 2])
        scores = g.add("Mul", [g.add("MatMul", [qh, kt]),
                               g.const(np.asarray(dk ** -0.5, F32))])
        neg = g.add("Expand", [g.const(np.asarray(-1e9, F32).reshape(1, 1, 1, 1)),
                               g.add("Shape", [scores])])
        scores = g.add("Where", [mask4, scores, neg])
        att = g.add("MatMul", [g.add("Softmax", [scores], axis=3), vh])
        att = g.add("Transpose", [att], perm=[0, 2, 1, 3])
        att = _reshape_dyn(g, att, [b_dim, t2, d])
        h = g.add("Add", [x_in, linear_ntc(att, blk.proj)])
        hn = layer_norm(h, blk.ln2)
        ff = linear_ntc(_gelu_erf(g, linear_ntc(hn, blk.fc1)), blk.fc2)
        h = g.add("Add", [h, ff])

    z = linear_ntc(layer_norm(h, mod.ln_f), mod.vq_proj)
    z2 = g.add("ReduceSum", [g.add("Pow", [z, g.const(np.asarray(2.0, F32))])],
               axes=[2], keepdims=1)
    cb = _t(mod.codebook)
    cross = g.add("MatMul", [z, g.const(cb.T.copy())])
    cross = g.add("Mul", [cross, g.const(np.asarray(-2.0, F32))])
    c2 = g.const((cb * cb).sum(1).reshape(1, 1, -1))
    dist = g.add("Add", [g.add("Add", [z2, cross]), c2])
    g.add("ArgMin", [dist], out_names=["speech_token"], axis=2, keepdims=0)
    data = g.finish(
        inputs=[("feats", F32, (1, n_mels, 0)),
                ("feats_length", np.int32, (1,))],
        outputs=[("speech_token", np.int64, (1, 0))])
    return mod, data
