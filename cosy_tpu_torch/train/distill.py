"""Few-step MeanFlow distillation of the CFM mel estimator (the port of the
JAX package's ``train/distill.py``), and its command line.

The student learns the AVERAGE velocity u(y_t, t, s) = (1 / (s - t)) *
integral_t^s v(y_tau, tau) d tau of the teacher's CFG-mixed field
v = (1 + w) v_cond - w v_uncond, so synthesis becomes 1-2 estimator calls
(``models.flow.cfm_solve_mean``).  Convention: t = 0 noise, t = 1 data,
y_t = (1 - (1 - sigma) t) z + t x1.  Two targets:

- ``"integral"``: u_tgt = (y_s - y_t) / (s - t), y_s rolled by m teacher
  Euler sub-steps over [t, s] (s == t anchors on the instantaneous field).
- ``"jvp"``: u_tgt = v + (s - t) du/dt, du/dt = d_y u . v + d_t u.  JAX
  takes it from one ``jax.jvp`` of the student; here ``torch.func.jvp``
  runs a second forward of the student over detached parameters, and the
  target is stop-gradiented either way, so the math is the same.

The student is the teacher's estimator plus a ``time_mlp_s`` branch whose
output projection starts at zero, so at init it equals the teacher.  The
frozen teacher runs at inference (``EVAL``, under ``torch.no_grad``, 2B
rows CFG-batched): on CUDA its transformer blocks are the block kernels
(B1 -> A -> B2).  The student trains under ``Ctx(train=True)`` on the plain
differentiable ops.  Every random number (t, s, z, and CosyVoice2's prompt
draws) can be passed in, so a test feeds both packages JAX's draws.

    python -m cosy_tpu_torch.train.distill --data-dir data [--flow FLOW.pt]
        [--steps 2000] [--lr 1e-5] [--batch-size 4] [--out output/flow_distilled.pt]
        [--target integral|jvp] [--teacher-substeps 4] [--inst-frac 0.25]
        [--cfg-rate W] [--max-feat-len N] [--seed 0] [--tiny] [--cosyvoice2]
        [--device cuda|cpu]

``distill_flow.py``'s flags over the port's parquet reader
(``data/dataset.py``); the export carries the weight-meta sidecar and
loads into ``python -m cosy_tpu_torch.infer --flow OUT --meanflow`` (or
``serve --sampler meanflow --flow-weights OUT``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..config import EstimatorConfig, FlowConfig
from ..ctx import EVAL, Ctx
from ..layers.basic import dense
from ..layers.unet import conditional_decoder, meanflow_branch_spec
from ..models.flow import flow_encode, length_regulator
from ..models.llm import _l2_normalize
from ..ops import masks as M
from ..params import P, Params, Spec, save_torch_checkpoint, save_weight_meta, spec_tensors
from .full_trainer import adamw, clip_by_global_norm

EST = "decoder.estimator."


def add_meanflow_time_branch(params: Params, est_cfg: EstimatorConfig,
                             generator: Optional[torch.Generator] = None,
                             prefix: str = EST) -> Params:
    """Copy of ``params`` with the ``time_mlp_s`` branch under ``prefix``:
    linear_1 at the torch default init from ``generator``, linear_2 zero,
    so the student equals the teacher at init."""
    dev = next(iter(params.values())).device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    branch = spec_tensors(meanflow_branch_spec(Spec(), prefix.rstrip("."), est_cfg), dev,
                          generator)
    return {**params, **branch}


def student_subset(flow_params: Params, prefix: str = EST) -> Params:
    """The trainable subtree: the estimator's weights, ``time_mlp_s`` too."""
    return {k: v for k, v in flow_params.items() if k.startswith(prefix)}


def _draw_ts(B: int, inst_frac: float, generator, device, dtype):
    t = torch.rand((B,), generator=generator, device=device).to(dtype)
    s = t + (1.0 - t) * torch.rand((B,), generator=generator, device=device).to(dtype)
    s = torch.where(torch.rand((B,), generator=generator, device=device) < inst_frac, t, s)
    return t, s


def meanflow_distill_loss(
    student: Params,  # full flow dict with time_mlp_s (its estimator part trainable)
    teacher: Params,  # frozen flow dict
    cfg,  # FlowConfig | Flow2Config
    generator: Optional[torch.Generator],
    x1: torch.Tensor,  # (B, 80, T) target mel
    mask: Optional[torch.Tensor],  # (B, 1, T)
    mu: torch.Tensor,  # (B, 80, T) encoder output at mel rate
    spks: torch.Tensor,  # (B, 80)
    cond: torch.Tensor,  # (B, 80, T)
    cfg_rate: Optional[float] = None,  # None: cfg.cfm.inference_cfg_rate
    inst_frac: float = 0.25,  # probability of s == t
    noise: Optional[tuple] = None,  # (t (B,), s (B,), z (B, 80, T)) override
    adaptive_p: float = 0.75,  # 0 = plain MSE
    target: str = "integral",  # "integral" | "jvp"
    teacher_substeps: int = 4,
    causal: bool = False,
    streaming: bool = False,
    static_chunk_size: int = 50,
) -> torch.Tensor:
    """One distillation step's loss (see the module docstring), with the
    paper's adaptive weighting 1 / (||delta||^2 + 1e-3)^p, stop-gradiented,
    unless ``adaptive_p`` <= 0."""
    B, C, T = x1.shape
    w = cfg.cfm.inference_cfg_rate if cfg_rate is None else cfg_rate
    sigma = cfg.cfm.sigma_min
    est_cfg = dataclasses.replace(cfg.estimator, dropout=0.0)
    dev, dtype = x1.device, x1.dtype
    if noise is not None:
        t, s, z = (torch.as_tensor(a, device=dev).to(dtype) for a in noise)
    else:
        t, s = _draw_ts(B, inst_frac, generator, dev, dtype)
        z = torch.randn(x1.shape, generator=generator, device=dev).to(dtype)
    tb = t[:, None, None]
    y = (1.0 - (1.0 - sigma) * tb) * z + tb * x1
    kw = dict(causal=causal, streaming=streaming, static_chunk_size=static_chunk_size)

    tp = P(teacher, EST)
    mask2 = None if mask is None else torch.cat([mask, mask])
    mu2 = torch.cat([mu, torch.zeros_like(mu)])
    spks2 = torch.cat([spks, torch.zeros_like(spks)])
    cond2 = torch.cat([cond, torch.zeros_like(cond)])

    @torch.no_grad()
    def teacher_v(y_, t_):
        v2 = conditional_decoder(tp, est_cfg, torch.cat([y_, y_]), mask2, mu2,
                                 torch.cat([t_, t_]), spks2, cond2, EVAL, **kw)
        return (1.0 + w) * v2[:B] - w * v2[B:]

    def u_fn(params, y_, t_, s_):
        return conditional_decoder(P(params, EST), est_cfg, y_, mask, mu, t_, spks, cond,
                                   Ctx(train=True), s=s_, **kw)

    if target == "integral":
        dt = (s - t) / teacher_substeps  # zero where s == t
        x_, t_, v0 = y, t, None
        for _ in range(teacher_substeps):
            v_i = teacher_v(x_, t_)
            v0 = v_i if v0 is None else v0
            x_, t_ = x_ + dt[:, None, None] * v_i.to(x_.dtype), t_ + dt
        span = (s - t)[:, None, None]
        u_tgt = torch.where(span > 1e-6, (x_ - y) / torch.clamp(span, min=1e-6), v0)
        u_tgt = u_tgt.detach().to(dtype)
        u = u_fn(student, y, t, s)
    elif target == "jvp":
        v = teacher_v(y, t).to(dtype)
        u = u_fn(student, y, t, s)
        frozen = {k: p.detach() for k, p in student.items()}
        _, du_dt = torch.func.jvp(lambda y_, t_, s_: u_fn(frozen, y_, t_, s_), (y, t, s),
                                  (v, torch.ones_like(t), torch.zeros_like(s)))
        u_tgt = (v + (s - t)[:, None, None] * du_dt).detach()
    else:
        raise ValueError(f"unknown distill target {target!r}")

    diff = (u - u_tgt) if mask is None else (u - u_tgt) * mask
    sq = torch.square(diff.float())
    if adaptive_p <= 0:
        denom = (B * T if mask is None else mask.sum()) * C
        return sq.sum() / torch.clamp(torch.as_tensor(denom, dtype=torch.float32), min=1.0)
    per_valid = (torch.full((B,), float(T), device=dev) if mask is None
                 else mask.float().sum(dim=(1, 2))) * C
    per = sq.sum(dim=(1, 2)) / torch.clamp(per_valid, min=1.0)
    aw = (1.0 / torch.pow(per + 1e-3, adaptive_p)).detach()
    return torch.mean(aw * per)


def flow_distill_loss(student_est: Params, teacher: Params, cfg: FlowConfig,
                      generator: Optional[torch.Generator], batch: Dict[str, torch.Tensor],
                      mel_norm: Tuple[float, float] = (-6.0, 2.0),
                      cfg_rate: Optional[float] = None, inst_frac: float = 0.25,
                      adaptive_p: float = 0.75, target: str = "integral",
                      teacher_substeps: int = 4, noise: Optional[tuple] = None) -> torch.Tensor:
    """CosyVoice-300M batch wrapper: prompt-free conditioning (zero conds,
    the fine-tune's serving path) in normalized mel; the frozen teacher's
    encoder and regulator give mu, shared by teacher and student."""
    mean, std = mel_norm
    feat = (batch["speech_feat"] - mean) / std
    feat_len = batch["speech_feat_len"]
    B, T, _ = feat.shape
    tpv = P(teacher)
    with torch.no_grad():
        spk = dense(tpv, "spk_embed_affine_layer",
                    _l2_normalize(batch["embedding"].to(feat.dtype), dim=1))
        h = flow_encode(tpv, cfg, batch["speech_token"].long(), batch["speech_token_len"])
        h = length_regulator(tpv.sub("length_regulator"), h, feat_len, T, cfg.regulator_stages)
    mask = M.make_non_pad_mask(feat_len, T)[:, None, :].to(h.dtype)
    conds = torch.zeros((B, cfg.output_size, T), dtype=h.dtype, device=h.device)
    return meanflow_distill_loss(
        {**teacher, **student_est}, teacher, cfg, generator, feat.transpose(1, 2), mask,
        h.transpose(1, 2), spk, conds, cfg_rate=cfg_rate, inst_frac=inst_frac, noise=noise,
        adaptive_p=adaptive_p, target=target, teacher_substeps=teacher_substeps)


def flow2_distill_loss(student_est: Params, teacher: Params, cfg,
                       generator: Optional[torch.Generator], batch: Dict[str, torch.Tensor],
                       cfg_rate: Optional[float] = None, inst_frac: float = 0.25,
                       adaptive_p: float = 0.75, target: str = "integral",
                       teacher_substeps: int = 4, streaming: bool = False,
                       noise: Optional[tuple] = None,
                       draws: Optional[dict] = None) -> torch.Tensor:
    """CosyVoice2 wrapper: the causal estimator, raw mel, and the prompt
    conds of ``flow2_forward_train`` (50% dropped, else U(0, 0.3) of the
    length; ``draws`` may give ``drop`` and ``plen_u``), so the student
    covers prompted serving.  ``streaming`` runs the chunked variant."""
    from ..models.flow2 import _fit_frames, flow2_encode, prompt_conds

    draws = draws or {}
    token_len = batch["speech_token_len"].long()
    feat = batch["speech_feat"]
    feat_len = batch["speech_feat_len"].long()
    B, T, _ = feat.shape
    dev = feat.device
    tpv = P(teacher)
    with torch.no_grad():
        spk = dense(tpv, "spk_embed_affine_layer",
                    _l2_normalize(batch["embedding"].to(feat.dtype), dim=1))
        h = _fit_frames(flow2_encode(tpv, cfg, batch["speech_token"].long(), token_len,
                                     streaming=streaming), T)
    drop = (torch.as_tensor(draws["drop"], device=dev) if "drop" in draws
            else torch.rand((B,), generator=generator, device=dev) < 0.5).bool()
    plen_u = (torch.as_tensor(draws["plen_u"], device=dev) if "plen_u" in draws
              else torch.rand((B,), generator=generator, device=dev))
    conds = prompt_conds(feat, feat_len, drop, plen_u).to(h.dtype)
    h_len = token_len * cfg.token_mel_ratio
    mask = M.make_non_pad_mask(torch.minimum(h_len, feat_len), T)[:, None, :].to(h.dtype)
    return meanflow_distill_loss(
        {**teacher, **student_est}, teacher, cfg, generator, feat.transpose(1, 2), mask,
        h.transpose(1, 2), spk, conds, cfg_rate=cfg_rate, inst_frac=inst_frac, noise=noise,
        adaptive_p=adaptive_p, target=target, teacher_substeps=teacher_substeps, causal=True,
        streaming=streaming, static_chunk_size=cfg.decoder_static_chunk_size)


@dataclass
class DistillState:
    student: Params  # the estimator subtree, leaves that require grad
    optimizer: torch.optim.AdamW
    step: int = 0


class FlowDistiller:
    """Distills a flow model into a few-step MeanFlow sampler.  Trains the
    estimator subtree only; the encoder and regulator stay the frozen
    teacher's.  AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4, the
    JAX package's optax defaults) after a clip by global norm 1.0."""

    def __init__(self, cfg, flow_params, lr: float = 1e-5, cfg_rate: Optional[float] = None,
                 inst_frac: float = 0.25, adaptive_p: float = 0.75, target: str = "integral",
                 teacher_substeps: int = 4, family: str = "v1",
                 mel_norm: Tuple[float, float] = (-6.0, 2.0), seed: int = 0):
        if isinstance(flow_params, torch.nn.Module):
            flow_params = dict(flow_params.named_parameters())
        self.cfg = cfg
        self.teacher = {k: v.detach() for k, v in flow_params.items()}
        self.device = next(iter(self.teacher.values())).device
        self.lr = lr
        self.cfg_rate = cfg_rate
        self.inst_frac = inst_frac
        self.adaptive_p = adaptive_p
        self.target = target
        self.teacher_substeps = teacher_substeps
        if family not in ("v1", "cv2"):
            raise ValueError(f"unknown family {family!r} (v1 | cv2)")
        self.family = family
        self.mel_norm = mel_norm
        self.seed = seed
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def init_state(self, student: Optional[Params] = None) -> DistillState:
        """The branched student (or the given estimator subtree) as fresh
        leaves, with a zeroed optimizer."""
        if student is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed + 7)
            student = student_subset(add_meanflow_time_branch(
                self.teacher, self.cfg.estimator, gen))
        student = {k: v.detach().clone().to(self.device).requires_grad_(True)
                   for k, v in student.items()}
        return DistillState(student=student, optimizer=adamw(self.lr)(list(student.values())))

    def loss(self, state: DistillState, batch: Dict[str, torch.Tensor],
             noise: Optional[tuple] = None, draws: Optional[dict] = None) -> torch.Tensor:
        kw = dict(cfg_rate=self.cfg_rate, inst_frac=self.inst_frac, adaptive_p=self.adaptive_p,
                  target=self.target, teacher_substeps=self.teacher_substeps, noise=noise)
        if self.family == "cv2":
            # the 50/50 streaming flag alternates by step, as in JAX: serving
            # runs the student chunked in its streaming windows
            return flow2_distill_loss(state.student, self.teacher, self.cfg, self.generator,
                                      batch, streaming=state.step % 2 == 1, draws=draws, **kw)
        return flow_distill_loss(state.student, self.teacher, self.cfg, self.generator, batch,
                                 self.mel_norm, **kw)

    def step(self, state: DistillState, batch: Dict[str, np.ndarray],
             noise: Optional[tuple] = None, draws: Optional[dict] = None) -> torch.Tensor:
        """One optimizer step; returns the loss as a 0-d tensor on the
        device (nothing here waits for it)."""
        batch = {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in batch.items()}
        state.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(state, batch, noise, draws)
        loss.backward()
        clip_by_global_norm(list(state.student.values()), 1.0)
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    def fit(self, batches: Iterable[Dict[str, np.ndarray]], steps: int,
            log_every: int = 20, state: Optional[DistillState] = None) -> DistillState:
        state = state or self.init_state()
        pending = []
        it = iter(batches)
        while state.step < steps:
            try:
                batch = next(it)
            except StopIteration:
                it = iter(batches)
                try:
                    batch = next(it)
                except StopIteration:
                    raise ValueError(
                        "batches exhausted before reaching the step count and cannot be "
                        "restarted (pass a list or an endless iterable)") from None
            pending.append(self.step(state, batch))
            if state.step % log_every == 0 or state.step == steps:
                vals = torch.stack(pending).cpu().numpy()
                print(f"distill step {state.step}/{steps} loss {float(vals[-1]):.4f} "
                      f"(mean {float(vals.mean()):.4f})", flush=True)
                pending = []
        return state

    def export(self, state: DistillState, path: str) -> Params:
        """The whole flow dict with the distilled estimator merged in, saved
        as a ``.pt`` state dict beside its weight-meta sidecar (CosyVoice-300M
        distils in normalized mel, CosyVoice2 in raw mel)."""
        merged = {**self.teacher, **{k: v.detach() for k, v in state.student.items()}}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        save_torch_checkpoint(merged, path)
        save_weight_meta(path, mel_space="normalized" if self.family == "v1" else "raw",
                         producer="cosy_tpu_torch.distill", sampler="meanflow")
        return merged


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------


FLOW_KEYS = ("speech_token", "speech_token_len", "speech_feat", "speech_feat_len", "embedding")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="MeanFlow few-step flow distillation "
                                             "(PyTorch port)")
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--flow", default=None,
                    help="teacher flow weights (default output/flow_merged_joint.pt, else the "
                         "pretrained flow)")
    ap.add_argument("--pretrained", default="pretrained_models/CosyVoice-300M")
    ap.add_argument("--out", default="output/flow_distilled.pt")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--cfg-rate", type=float, default=None,
                    help="guidance folded into the student (default inference_cfg_rate)")
    ap.add_argument("--inst-frac", type=float, default=0.25,
                    help="fraction of draws with s == t (the instantaneous anchor)")
    ap.add_argument("--target", default="integral", choices=["integral", "jvp"])
    ap.add_argument("--teacher-substeps", type=int, default=4)
    ap.add_argument("--max-feat-len", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="smoke-test topology (toy widths; not checkpoint-compatible)")
    ap.add_argument("--cosyvoice2", action="store_true",
                    help="distil the CosyVoice2 causal flow (Flow2Config)")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def tiny_flow2_config():
    """CosyVoice2's flow graph at toy widths (``distill_flow.py --tiny
    --cosyvoice2``), data-compatible with the preparer (80 mel, 192 spk)."""
    from ..config import EncoderConfig
    from ..models.flow2 import Flow2Config

    return Flow2Config(
        input_size=16, output_size=80, spk_embed_dim=192, vocab_size=128,
        encoder=EncoderConfig(input_size=16, output_size=16, attention_heads=2,
                              linear_units=24, num_blocks=1, static_chunk_size=4),
        num_up_blocks=1,
        estimator=EstimatorConfig(in_channels=320, out_channels=80, channels=(16, 16),
                                  attention_head_dim=4, n_blocks=1, num_mid_blocks=1,
                                  num_heads=2),
        decoder_static_chunk_size=4)


def _batches(args):
    """An endless generator of flow-key batches from ``--data-dir``, or
    None when it holds no records."""
    from ..config import TrainConfig, replace
    from ..data.dataset import DataLoader, FlowFinetuneDataset

    tcfg = TrainConfig(training_mode="flow_only", batch_size=args.batch_size,
                       accumulate_grad_batches=1)
    if args.max_feat_len:
        tcfg = replace(tcfg, max_feat_len=args.max_feat_len)
    dataset = FlowFinetuneDataset(args.data_dir, augmentation=False, seed=args.seed)
    if len(dataset) == 0:
        return None

    def gen():
        loader = DataLoader(dataset, tcfg, seed=args.seed)
        while True:
            for sb in loader:
                yield {k: v[0] for k, v in sb.items() if k in FLOW_KEYS}

    return gen


def flow_config(args):
    """The flow configuration the flags select."""
    from ..config import ModelConfig, tiny_model_config
    from ..models.flow2 import Flow2Config

    if args.cosyvoice2:
        return tiny_flow2_config() if args.tiny else Flow2Config()
    return (tiny_model_config() if args.tiny else ModelConfig()).flow


def _teacher(args, cfg, device):
    """(teacher module, family) from the flags."""
    from ..compat.loader import load_or_init
    from ..config import ModelConfig, tiny_model_config
    from ..models.flow2 import Flow2, init_flow2_params
    from ..params import load_torch_checkpoint

    if args.cosyvoice2:
        pretrained = args.pretrained
        if pretrained == "pretrained_models/CosyVoice-300M":
            pretrained = "pretrained_models/CosyVoice2-0.5B"
        path = args.flow or os.path.join(pretrained, "flow.pt")
        if not args.tiny and os.path.exists(path):
            print(f"teacher: CosyVoice2 flow weights {path}")
            flow = Flow2(cfg, device)
            flow.load_state_dict(load_torch_checkpoint(path), strict=True)
        elif args.flow and not args.tiny:
            raise SystemExit(f"--flow {args.flow}: file not found")
        else:
            print("WARNING: no CosyVoice2 flow weights - random initialization (smoke-test "
                  "mode)")
            flow = init_flow2_params(cfg, device, seed=args.seed)
        return flow, "cv2"
    model_cfg = tiny_model_config() if args.tiny else ModelConfig()
    path = args.flow or os.path.join("output", "flow_merged_joint.pt")
    if os.path.exists(path):
        print(f"teacher: merged flow weights {path}")
        from ..models.flow import Flow

        flow = Flow(model_cfg.flow, device)
        flow.load_state_dict(load_torch_checkpoint(path), strict=True)
    elif args.flow:
        # an explicit teacher that is missing is a typo, not a fallback
        raise SystemExit(f"--flow {args.flow}: file not found")
    else:
        flow = load_or_init(args.pretrained, model_cfg, device, args.seed)["flow"]
        print(f"teacher: base flow weights ({path} not found)")
    return flow, "v1"


def main(argv=None) -> Optional[Tuple[FlowDistiller, DistillState]]:
    from ..config import ModelConfig
    from ..ops.fused_block import require_kernel_widths
    from ..params import resolve_device

    args = parse_args(argv)
    cfg = flow_config(args)
    require_kernel_widths(cfg.estimator, args.device)
    dev = resolve_device(args.device)
    batches = _batches(args)
    if batches is None:
        print(f"no data in {args.data_dir}; run python -m cosy_tpu_torch.data.prepare first")
        return None
    flow, family = _teacher(args, cfg, dev)
    mel = ModelConfig()
    w = cfg.cfm.inference_cfg_rate if args.cfg_rate is None else args.cfg_rate
    print(f"distilling ({family}) on {dev}: steps={args.steps} lr={args.lr} "
          f"bs={args.batch_size} target={args.target} cfg_rate={w} inst_frac={args.inst_frac}")
    distiller = FlowDistiller(cfg, flow, lr=args.lr, cfg_rate=args.cfg_rate,
                              inst_frac=args.inst_frac, target=args.target,
                              teacher_substeps=args.teacher_substeps, family=family,
                              mel_norm=(mel.mel_mean, mel.mel_std), seed=args.seed)
    state = distiller.fit(batches(), steps=args.steps, log_every=args.log_every)
    distiller.export(state, args.out)
    print(f"saved distilled flow -> {args.out}")
    if family == "v1":
        print(f"synthesize with: python -m cosy_tpu_torch.infer --text ... --flow {args.out} "
              "--meanflow")
    else:
        print("serve with: python -m cosy_tpu_torch.serve --cosyvoice2 --sampler meanflow "
              f"--flow-weights {args.out}")
    return distiller, state


if __name__ == "__main__":
    main()
