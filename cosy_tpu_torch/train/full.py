"""Full-parameter training from the command line (the port's counterpart of
``train_full.py``; reference: cosyvoice/bin/train.py with
utils/executor.py and utils/train_utils.py).

    python -m cosy_tpu_torch.train.full --model llm|flow|hifigan
        --train_data data.list --model_dir OUT [--cv_data cv.list]
        [--config cosyvoice.yaml | --tiny] [--checkpoint init.pt]
        [--epochs 1] [--max_steps N] [--lr 1e-4] [--grad_clip 5] [--accum 1]
        [--batch_size 4] [--seq_bucket 32] [--flow_style vendored|finetune]
        [--cosyvoice2 [--cv2_streaming]] [--dpo [--dpo_beta 0.01]] [--resume]
        [--no_zero2] [--tensor_parallel] [--sequence_parallel]
        [--pp_microbatches M] [--mesh_model N] [--mesh_seq N]
        [--device cuda|cpu]

    torchrun --nproc-per-node G -m cosy_tpu_torch.train.full ...

``train_full.py``'s flags over the port's processor chain
(``data/processor.py``): ``FullTrainer`` for ``llm`` (the 300M
TransformerLM, or with ``--cosyvoice2`` Qwen2LM, or with ``--dpo`` its DPO
objective against a frozen copy of the initial weights) and ``flow`` (the
vendored or the fine-tune objective, or with ``--cosyvoice2`` the causal
flow), ``HiFiGanTrainer`` for ``hifigan`` (raw speech rows: resample, crop to
``--gan_truncate``, mel and pitch on the host).  Step checkpoints go to
``--model_dir/ckpt`` (``--resume`` continues from the newest), a
reference-format ``.pt`` export and per-epoch CV loss after every epoch,
TensorBoard scalars to ``--model_dir/tb``.  ``--tiny`` takes the toy widths
of the smoke tests.

Under ``torchrun`` every rank drives one GPU (``cuda:LOCAL_RANK`` over
NCCL; with ``--device cpu`` the CPU over gloo) and the world is laid out
as a (dp, seq, model) mesh, ``--mesh_model`` x ``--mesh_seq`` ranks a
group and dp the rest (the JAX CLI's mesh is all dp, where the size-1
axes make the three flags below no-ops).  Every rank reads the same
batches and runs its dp rows of each; ``--batch_size`` must divide by dp.
ZeRO-2 splits the AdamW moments over dp unless ``--no_zero2``;
``--tensor_parallel`` splits the transformer products over ``model``,
``--sequence_parallel`` the estimator's frames over ``seq``, and
``--pp_microbatches M`` pipelines eligible transformer stacks over
``model``.  Rank 0 logs and writes the checkpoints and exports.  Without
a launcher the run is a world of one.
"""

from __future__ import annotations

import argparse
import os
import random
import time
from typing import Optional

import numpy as np

from ..ctx import Ctx
from ..data import processor as Pr
from ..data.dataset import MEL_PADDING_VALUE
from ..parallel.mesh import finish_distributed, init_distributed, is_main, make_mesh
from ..params import P, load_torch_checkpoint
from ..utils.distributed import joined_loader
from .full_trainer import step_generator

# keys each objective reads; the rest of a batch is dropped before the step
MODEL_KEYS = {
    "llm": ("text_token", "text_token_len", "speech_token", "speech_token_len", "embedding"),
    "llm_dpo": ("text_token", "text_token_len", "speech_token", "speech_token_len",
                "reject_speech_token", "reject_speech_token_len"),
    "flow": ("speech_token", "speech_token_len", "speech_feat", "speech_feat_len",
             "embedding"),
}


def build_loader(list_path: str, args, tokenizer=None, gan: bool = False, device=None):
    """data.list of parquet shards -> padded batch dicts (the processor
    chain); the mel frontend of raw-speech rows runs on ``device``."""
    with open(list_path) as f:
        shards = Pr.shard_list([ln.strip() for ln in f if ln.strip()])

    def rows():
        for row in Pr.parquet_opener(shards):
            # the preparer writes flattened speech_feat with its shape
            if "speech_feat" in row and "speech_feat_shape" in row:
                row["speech_feat"] = np.asarray(row["speech_feat"], np.float32).reshape(
                    [int(d) for d in row["speech_feat_shape"]])
            yield row

    first = next(iter(Pr.parquet_opener(shards[:1])), None)
    if first is None:
        raise SystemExit(f"{list_path}: no rows")
    if tokenizer is None and "text_token" not in first:
        from ..data.tokenizer import TextTokenizer, find_vocab_file

        if find_vocab_file() is not None:
            tokenizer = TextTokenizer()
        elif args.model == "llm":
            raise SystemExit(f"{list_path}: rows lack text_token and no tokenizer vocab was "
                             "found - run the preparer first, or set COSY_TPU_TOKENIZER_VOCAB")
    need_feats = gan or args.model == "flow"
    stages = [(Pr.tokenize, {"tokenizer": tokenizer}), (Pr.filter_stage, {})]
    if need_feats and "speech_feat" not in first:
        if "speech" not in first:
            raise SystemExit(f"{list_path}: rows carry neither speech_feat nor raw speech - "
                             f"cannot train --model {args.model}")
        stages.append((Pr.resample_stage, {}))
        if gan:
            stages.append((Pr.truncate_stage, {"truncate_length": args.gan_truncate}))
        stages.append((Pr.compute_fbank, {"device": device}))
    if gan:
        stages.append((Pr.compute_f0_stage, {}))
    stages += [(Pr.parse_embedding, {}),
               (Pr.shuffle_stage, {"shuffle_size": args.shuffle_size}),
               (Pr.sort_stage, {"sort_size": args.sort_size}),
               (Pr.static_batch, {"batch_size": args.batch_size}),
               (Pr.padding, {"use_spk_embedding": args.use_spk_embedding})]
    return Pr.build_pipeline(rows(), stages)


def stack_accum(batches, accum: int, bucket: int):
    """Group ``accum`` batches of one batch size into an (accum, B, ...)
    super-batch, the time axes padded to the group's longest rounded up to
    ``bucket`` (mel with the mel padding value, the rest with 0).  A partial
    trailing group, or one of another batch size, is dropped (the reference
    drops the last batch)."""
    buf, first_B = [], None
    for b in batches:
        B = b[next(iter(b))].shape[0]
        first_B = B if first_B is None else first_B
        if B != first_B:
            buf = []
            continue
        buf.append(b)
        if len(buf) < accum:
            continue
        out = {}
        for k in buf[0]:
            arrs = [np.asarray(x[k]) for x in buf]
            tgt = list(np.max([a.shape for a in arrs], axis=0))
            if len(tgt) >= 2 and k != "embedding":
                tgt[1] = -(-tgt[1] // bucket) * bucket
            pv = MEL_PADDING_VALUE if k == "speech_feat" else 0
            out[k] = np.stack([np.pad(a, [(0, t - s) for s, t in zip(a.shape, tgt)],
                                      constant_values=pv) for a in arrs])
        yield out
        buf = []


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="full-parameter trainer (PyTorch port; "
                                             "reference: cosyvoice/bin/train.py)")
    ap.add_argument("--model", required=True, choices=["llm", "flow", "hifigan"])
    ap.add_argument("--train_data", required=True, help="data.list of parquet shards")
    ap.add_argument("--cv_data", default=None)
    ap.add_argument("--config", default=None, help="cosyvoice.yaml topology")
    ap.add_argument("--tiny", action="store_true",
                    help="smoke-test topology (toy widths; not checkpoint-compatible)")
    ap.add_argument("--checkpoint", default=None, help="init weights .pt")
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--tensorboard_dir", default=None)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--max_steps", type=int, default=0, help="0 = unlimited")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--grad_clip", type=float, default=5.0)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--seq_bucket", type=int, default=32)
    ap.add_argument("--shuffle_size", type=int, default=1000)
    ap.add_argument("--sort_size", type=int, default=100)
    ap.add_argument("--gan_truncate", type=int, default=24576)
    ap.add_argument("--use_spk_embedding", action="store_true")
    ap.add_argument("--flow_style", choices=["vendored", "finetune"], default="vendored")
    ap.add_argument("--cosyvoice2", action="store_true")
    ap.add_argument("--cv2_streaming", action="store_true")
    ap.add_argument("--dpo", action="store_true")
    ap.add_argument("--dpo_beta", type=float, default=0.01)
    ap.add_argument("--no_zero2", action="store_true")
    ap.add_argument("--tensor_parallel", action="store_true")
    ap.add_argument("--sequence_parallel", action="store_true")
    ap.add_argument("--pp_microbatches", type=int, default=0)
    ap.add_argument("--mesh_model", type=int, default=1,
                    help="ranks on the mesh's model axis (tensor / pipeline parallelism)")
    ap.add_argument("--mesh_seq", type=int, default=1,
                    help="ranks on the mesh's seq axis (sequence parallelism)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1986)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def tiny_qwen2lm_config():
    """Qwen2LM at toy widths (the tests' topology)."""
    from ..layers.qwen2 import Qwen2Config
    from ..models.qwen2lm import Qwen2LMConfig

    return Qwen2LMConfig(llm_input_size=32, llm_output_size=32, speech_token_size=128,
                         qwen=Qwen2Config(hidden_size=32, intermediate_size=64,
                                          num_hidden_layers=2, num_attention_heads=4,
                                          num_key_value_heads=2, head_dim=8, vocab_size=1000))


def configs(args):
    """(ModelConfig, CosyVoice2 (llm, flow, hift) configs or None)."""
    from ..compat.yaml_config import cv2_configs_from_yaml, model_config_from_yaml
    from ..config import ModelConfig, tiny_model_config

    cfg = (model_config_from_yaml(args.config) if args.config
           else tiny_model_config() if args.tiny else ModelConfig())
    if not args.cosyvoice2:
        return cfg, None
    if args.config:
        return cfg, cv2_configs_from_yaml(args.config)[:3]
    from ..infer.pipeline2 import hift24k_config
    from ..models.flow2 import Flow2Config
    from ..models.qwen2lm import Qwen2LMConfig
    from .distill import tiny_flow2_config

    if args.tiny:
        return cfg, (tiny_qwen2lm_config(), tiny_flow2_config(), cfg.hift)
    return cfg, (Qwen2LMConfig(), Flow2Config(), hift24k_config())


def objective(args, cfg, cv2, dev, init):
    """(initial params, loss_fn(params, generator, batch, train=True)) of
    the llm / flow objective the flags select; ``init`` overrides the
    seeded initialization."""
    from ..models import flow as F
    from ..models import llm as L
    from ..models.flow2 import flow2_forward_train, init_flow2_params
    from ..models.qwen2lm import init_qwen2lm_params, qwen2lm_forward_train

    def seeded(init_fn, c):
        """``init``, or the seeded initialization at ``c``."""
        if init is not None:
            return init
        return {k: v.detach() for k, v in init_fn(c, dev, seed=args.seed).named_parameters()}

    if args.model == "llm" and args.dpo:
        from .dpo import make_dpo_loss_fn

        lcfg = cv2[0] if cv2 else (tiny_qwen2lm_config() if args.tiny else None)
        if lcfg is None:
            from ..models.qwen2lm import Qwen2LMConfig

            lcfg = Qwen2LMConfig()
        params = seeded(init_qwen2lm_params, lcfg)
        dpo = make_dpo_loss_fn(lcfg, params, beta=args.dpo_beta)
        return params, lambda p, g, b, train=True: dpo(p, g, b)
    if args.model == "llm" and cv2:
        lcfg = cv2[0]
        params = seeded(init_qwen2lm_params, lcfg)

        def loss_fn(p, g, b, train=True):
            out = qwen2lm_forward_train(P(p), lcfg, b, Ctx(generator=g, train=train),
                                        generator=g)
            return out["loss"], {"acc": out["acc"]}
        return params, loss_fn
    if args.model == "llm":
        params = seeded(L.init_llm_params, cfg.llm)

        def loss_fn(p, g, b, train=True):
            out = L.llm_forward_train(P(p), cfg.llm, b, Ctx(generator=g, train=train))
            return out["loss"], {"acc": out["acc"]}
        return params, loss_fn
    if cv2:
        fcfg, streaming = cv2[1], bool(args.cv2_streaming)
        params = seeded(init_flow2_params, fcfg)

        def loss_fn(p, g, b, train=True):
            return flow2_forward_train(P(p), fcfg, g, b, Ctx(generator=g, train=train),
                                       streaming=streaming), {}
        return params, loss_fn
    params = seeded(F.init_flow_params, cfg.flow)
    vendored = args.flow_style == "vendored"

    def loss_fn(p, g, b, train=True):
        return F.flow_forward_train(P(p), cfg.flow, g, b, Ctx(generator=g, train=train),
                                    vendored_style=vendored, no_prompt=not vendored), {}
    return params, loss_fn


def _log(tb, step, m, epoch, every):
    if step % every == 0 and is_main():
        tb.add_scalars(step, m, prefix="train")
        print(f"epoch {epoch} step {step}: "
              + " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items())), flush=True)


def _require_divisible(batch_size: int, dp: int) -> None:
    if batch_size % dp:
        raise SystemExit(
            f"--batch_size {batch_size} must be divisible by the data-"
            f"parallel mesh size ({dp} devices): each micro batch shards "
            "over dp (reference DDP divides the global batch the same way)")


def _gan(args, cfg, cv2, dev, init, tb, ckpt_dir, mesh) -> int:
    """The hifigan branch: two-optimizer GAN turns (executor.py:88-144)."""
    from ..models.gan import init_discriminator_params
    from ..models.hift import init_hift_params
    from .checkpoint import save_model_pt
    from .gan_trainer import HiFiGanTrainer

    hcfg = cv2[2] if cv2 else cfg.hift
    gen = init if init is not None else init_hift_params(hcfg, dev, seed=args.seed)
    disc = init_discriminator_params(dev, seed=args.seed + 1)
    trainer = HiFiGanTrainer(hcfg, gen, disc, gen_lr=args.lr, disc_lr=args.lr,
                             grad_clip=args.grad_clip, mesh=mesh)
    start = trainer.load_checkpoint(ckpt_dir) if args.resume and \
        os.path.isdir(ckpt_dir) and os.listdir(ckpt_dir) else 0
    step = start
    for epoch in range(args.epochs):
        t0 = time.time()
        for batch in joined_loader(build_loader(args.train_data, args, gan=True, device=dev)):
            step += 1
            _log(tb, step, trainer.step(batch, step_generator(dev, args.seed, 7000 + step)),
                 epoch, args.log_every)
            if args.max_steps and step - start >= args.max_steps:
                break
        trainer.save_checkpoint(ckpt_dir, step=step)
        if is_main():
            save_model_pt(trainer.gen_params,
                          os.path.join(args.model_dir, f"hift_epoch{epoch}.pt"),
                          info={"epoch": epoch, "step": step})
            print(f"== epoch {epoch} done ({time.time() - t0:.1f}s)", flush=True)
        if args.max_steps and step - start >= args.max_steps:
            break
    trainer.close()
    return 0


def main(argv=None) -> int:
    from ..utils.tb import TBWriter
    from .full_trainer import FullTrainer, adamw

    args = parse_args(argv)
    dev = init_distributed(args.device)
    mesh = make_mesh(model=args.mesh_model, seq=args.mesh_seq, device=dev)
    _require_divisible(args.batch_size, mesh.size("dp"))
    random.seed(args.seed)  # every rank shuffles its batches alike
    cfg, cv2 = configs(args)
    os.makedirs(args.model_dir, exist_ok=True)
    ckpt_dir = os.path.join(args.model_dir, "ckpt")
    tb = TBWriter(args.tensorboard_dir or os.path.join(args.model_dir, "tb"),
                  enabled=is_main())
    init = None
    if args.checkpoint:
        init = {k: v.to(dev) for k, v in load_torch_checkpoint(args.checkpoint).items()}
        if is_main():
            print(f"init weights <- {args.checkpoint} ({len(init)} tensors)")

    if args.model == "hifigan":
        code = _gan(args, cfg, cv2, dev, init, tb, ckpt_dir, mesh)
        tb.close()
        finish_distributed()
        return code

    params, loss_fn = objective(args, cfg, cv2, dev, init)
    trainer = FullTrainer(loss_fn, params, adamw(args.lr), mesh=mesh, zero2=not args.no_zero2,
                          grad_clip=args.grad_clip, accum=args.accum,
                          tensor_parallel=args.tensor_parallel,
                          sequence_parallel=args.sequence_parallel,
                          pipeline_parallel_microbatches=args.pp_microbatches)
    if args.resume and os.path.isdir(ckpt_dir) and os.listdir(ckpt_dir):
        step = trainer.load_checkpoint(ckpt_dir)
        if is_main():
            print(f"resumed at step {step}")
    start = trainer.step_count
    keep = MODEL_KEYS["llm_dpo" if args.model == "llm" and args.dpo else args.model]

    def batches(path):
        return ({k: v for k, v in b.items() if k in keep}
                for b in build_loader(path, args, device=dev))

    def run_cv(step) -> Optional[float]:
        """Mean eval-mode (dropout off) loss over the CV list."""
        if not args.cv_data:
            return None
        eval_fn = lambda p, g, b: loss_fn(p, g, b, train=False)  # noqa: E731
        losses = [trainer.evaluate_loss({k: v[0] for k, v in sb.items()}, eval_fn,
                                        step_generator(dev, args.seed, 0))
                  for sb in stack_accum(batches(args.cv_data), 1, args.seq_bucket)]
        if not losses:
            return None
        cv = float(np.mean(losses))
        tb.add_scalars(step, {"loss": cv}, prefix="cv")
        if is_main():
            print(f"CV loss at step {step}: {cv:.4f} ({len(losses)} batches)", flush=True)
        return cv

    for epoch in range(args.epochs):
        t0 = time.time()
        for sb in joined_loader(stack_accum(batches(args.train_data), args.accum,
                                            args.seq_bucket)):
            m = trainer.step(sb, step_generator(dev, args.seed, 9000 + trainer.step_count))
            _log(tb, trainer.step_count, m, epoch, args.log_every)
            if args.max_steps and trainer.step_count - start >= args.max_steps:
                break
        run_cv(trainer.step_count)
        trainer.save_checkpoint(ckpt_dir)
        trainer.save_model(os.path.join(args.model_dir, f"{args.model}_epoch{epoch}.pt"),
                           info={"epoch": epoch})
        if is_main():
            print(f"== epoch {epoch} done ({time.time() - t0:.1f}s, step "
                  f"{trainer.step_count})", flush=True)
        if args.max_steps and trainer.step_count - start >= args.max_steps:
            break
    trainer.close()
    tb.close()
    finish_distributed()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
