"""Training scale-out over gloo ranks on the CPU: data parallelism (with and
without ZeRO-2) in the full-parameter, joint LoRA and GAN trainers,
tensor, sequence and pipeline parallelism, expert parallelism, the
cross-rank agreement, preemption across ranks, and checkpoints that cross
mesh layouts, each held to the single-process run.

One worker program (this file run as a script with ``--worker``) runs
every multi-rank check of a world size and writes its results; the
parametrised cases below read them.  Two launches: 2 ranks and 4 ranks,
each rank on one intra-op thread, the port of ``tests/test_multihost.py``'s
single ``_WORKER``.  Every wait has a timeout and kills the ranks on
expiry.

Tolerances: losses within 1e-5 relative, parameters after the steps
within 1e-4 x max(1, max|p|); tensor parallelism's losses at JAX's
``rtol=2e-4, atol=2e-5`` (tests/test_full_trainer.py:103); sequence
parallelism's loss at 1e-5 and its post-AdamW parameters at
``atol=2e-3, rtol=1e-4`` (tests/test_sp.py:72-78); the pipeline's forward
at 1e-5 (tests/test_pp.py:55-56) and its gradients at 2e-4.  The batches
have ragged lengths, so a per-rank denominator would show.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from cosy_tpu_torch.config import TrainConfig, tiny_model_config  # noqa: E402
from cosy_tpu_torch.ctx import Ctx  # noqa: E402
from cosy_tpu_torch.models import flow as TF  # noqa: E402
from cosy_tpu_torch.models import llm as TLLM  # noqa: E402
from cosy_tpu_torch.params import P  # noqa: E402
from cosy_tpu_torch.train.full_trainer import FullTrainer, adamw  # noqa: E402
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)
from test_torch_tp_serve import DECODES, FLOW_TOL, FLOWS  # noqa: E402

LAUNCH_TIMEOUT = 240  # seconds a launch may take before its ranks are killed
CFG = tiny_model_config()
LR = 1e-3


# ---------------------------------------------------------------------------
# what every rank and the single process build alike
# ---------------------------------------------------------------------------


def flow_params() -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in TF.init_flow_params(CFG.flow, "cpu", seed=3)
            .named_parameters()}


def flow_loss(p, g, b):
    return TF.flow_forward_train(P(p), CFG.flow, g, b, Ctx(generator=g, train=True),
                                 vendored_style=True), {}


def flow_super(seed: int, accum: int = 2, B: int = 4, T: int = 32) -> Dict[str, np.ndarray]:
    """(accum, B, ...) flow rows of ragged token and frame counts."""
    rng = np.random.default_rng(seed)
    return {
        "speech_token": rng.integers(0, 128, (accum, B, 12)).astype(np.int32),
        "speech_token_len": rng.integers(5, 13, (accum, B)).astype(np.int32),
        "speech_feat": (rng.standard_normal((accum, B, T, 80)) * 2 - 6).astype(np.float32),
        "speech_feat_len": rng.integers(T // 2, T + 1, (accum, B)).astype(np.int32),
        "embedding": rng.standard_normal((accum, B, 192)).astype(np.float32),
    }


def step_gen(step: int) -> torch.Generator:
    return torch.Generator().manual_seed(100 + step)


def run_full(mesh, steps: int, **kw):
    """A flow FullTrainer's losses and whole parameters after ``steps``."""
    tr = FullTrainer(flow_loss, flow_params(), adamw(LR), mesh=mesh, accum=2, **kw)
    losses = [tr.step(flow_super(s), step_gen(s))["loss"] for s in range(steps)]
    return tr, losses


def joint_setup():
    cfg = CFG
    tcfg = TrainConfig(training_mode="joint", batch_size=4, accumulate_grad_batches=2,
                       max_feat_len=16, learning_rate=1e-3, warmup_steps=1, bf16=False)
    llm = TLLM.init_llm_params(cfg.llm, "cpu", seed=1)
    flow = TF.init_flow_params(cfg.flow, "cpu", seed=2)
    return cfg, tcfg, llm, flow


def joint_super(seed: int, accum: int = 2, B: int = 4) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "text_token": rng.integers(0, 300, (accum, B, 5)).astype(np.int32),
        "text_token_len": rng.integers(2, 6, (accum, B)).astype(np.int32),
        "speech_token": rng.integers(0, 128, (accum, B, 9)).astype(np.int32),
        "speech_token_len": rng.integers(4, 10, (accum, B)).astype(np.int32),
        "speech_feat": (rng.standard_normal((accum, B, 16, 80)) * 2 - 6).astype(np.float32),
        "speech_feat_len": rng.integers(8, 17, (accum, B)).astype(np.int32),
        "embedding": rng.standard_normal((accum, B, 192)).astype(np.float32),
    }


def run_joint(mesh, out_dir: str, steps: int = 2):
    from cosy_tpu_torch.train.trainer import JointTrainer

    cfg, tcfg, llm, flow = joint_setup()
    tr = JointTrainer(cfg, tcfg, llm, flow, out_dir=out_dir, total_steps=10, mesh=mesh)
    state = tr.init_state(torch.Generator().manual_seed(0))
    losses = [float(tr.step(state, joint_super(s), step_gen(s))["loss"]) for s in range(steps)]
    return losses, {f"{n}.{k}": v.detach().clone() for n, d in state.loras.items()
                    for k, v in d.items()}


def gan_setup():
    from cosy_tpu_torch.models.gan import init_discriminator_params
    from cosy_tpu_torch.models.hift import init_hift_params

    gen = {k: v.detach() for k, v in init_hift_params(CFG.hift, "cpu", seed=2)
           .named_parameters()}
    disc = init_discriminator_params("cpu", seed=1, channels=4,
                                     mpd_channels=(1, 4, 8, 8, 8, 8))
    return gen, disc


def gan_batch(seed: int, B: int = 2, T: int = 8) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {"speech": rng.uniform(-0.5, 0.5, (B, T * 256)).astype(np.float32),
            "speech_feat": (rng.standard_normal((B, T, 80)) * 2 - 6).astype(np.float32),
            "pitch_feat": rng.uniform(100, 200, (B, T)).astype(np.float32)}


def run_gan(mesh, steps: int = 2):
    from cosy_tpu_torch.train.gan_trainer import HiFiGanTrainer

    gen, disc = gan_setup()
    tr = HiFiGanTrainer(CFG.hift, gen, disc, grad_clip=0.5, mesh=mesh)
    ms = [tr.step(gan_batch(s), step_gen(s)) for s in range(steps)]
    params = {**{f"gen.{k}": v.detach().clone() for k, v in tr.gen_params.items()},
              **{f"disc.{k}": v.detach().clone() for k, v in tr.disc_params.items()}}
    return ms, params


def llm_nodrop():
    z = dict(dropout_rate=0.0, positional_dropout_rate=0.0, attention_dropout_rate=0.0)
    return dataclasses.replace(CFG.llm.llm, num_blocks=2, **z)


def llm_pp_cfg():
    return dataclasses.replace(CFG.llm, llm=llm_nodrop())


def llm_loss(p, g, b):
    out = TLLM.llm_forward_train(P(p), llm_pp_cfg(), b, Ctx(generator=g, train=True))
    return out["loss"], {"acc": out["acc"]}


def run_llm_pp(mesh, micro: int, **kw):
    """One FullTrainer step of the LLM whose backbone may pipeline: (loss,
    whole parameters, the number of tp-split leaves)."""
    from cosy_tpu_torch.parallel import tp as TP

    params = {k: v.detach() for k, v in TLLM.init_llm_params(llm_pp_cfg(), "cpu", seed=1)
              .named_parameters()}
    tr = FullTrainer(llm_loss, params, adamw(LR), mesh=mesh,
                     pipeline_parallel_microbatches=micro, **kw)
    sb = {k: v[:1] for k, v in joint_super(5).items() if not k.startswith("speech_feat")}
    m = tr.step(sb, step_gen(0))
    return m["loss"], tr.whole_params(), TP.count_sharded(tr.param_specs)


def pp_inputs():
    """The tiny LLM backbone (2 blocks, dropout-free) and a ragged batch."""
    from cosy_tpu_torch.layers.conformer import init_encoder
    from cosy_tpu_torch.params import Spec, spec_tensors

    cfg = llm_nodrop()
    spec = Spec()
    init_encoder(spec, "", cfg, conformer=False)
    params = spec_tensors(spec, "cpu", torch.Generator().manual_seed(5))
    rng = np.random.default_rng(2)
    xs = torch.from_numpy(rng.standard_normal((4, 10, cfg.input_size)).astype(np.float32))
    lens = torch.tensor([10, 7, 9, 4])
    return cfg, params, xs, lens


def dynamic_chunk_rows(mesh, steps: int = 6):
    """A conformer's training forward with dynamic chunks (and dropout) on
    this rank's rows of a ragged batch, ``steps`` times on the trainers'
    per-step generators: (lo, hi, the outputs).  Every rank seeds its
    generator alike and draws the whole batch's dropout masks
    (``draw_rows``), so every rank draws the same chunk after them."""
    from cosy_tpu_torch.config import EncoderConfig
    from cosy_tpu_torch.layers.conformer import encoder_forward, init_encoder
    from cosy_tpu_torch.parallel import mesh as M
    from cosy_tpu_torch.params import Spec, spec_tensors

    cfg = EncoderConfig(input_size=12, output_size=16, attention_heads=2, linear_units=24,
                        num_blocks=2, use_dynamic_chunk=True, use_dynamic_left_chunk=True)
    spec = Spec()
    init_encoder(spec, "", cfg, conformer=True)
    params = P(spec_tensors(spec, "cpu", torch.Generator().manual_seed(6)))
    xs = torch.randn(4, 40, 12, generator=torch.Generator().manual_seed(7))
    lens = torch.tensor([40, 33, 27, 40])
    lo, hi = (0, 4) if mesh is None else M.dp_rows(mesh, 4)
    outs = []
    for k in range(steps):
        with M.batch_rows(mesh, lo, hi, 4):
            y, _ = encoder_forward(params, cfg, xs[lo:hi], lens[lo:hi],
                                   Ctx(generator=step_gen(k), train=True))
        outs.append(y)
    return lo, hi, outs


def moe_inputs(E: int = 4):
    from cosy_tpu_torch.parallel.tp import stack_experts

    rng = np.random.default_rng(4)
    D, H = 8, 12
    p = {"m.gate.weight": rng.standard_normal((E, D)), "m.gate.bias": rng.standard_normal(E)}
    for i in range(E):
        p[f"m.experts.{i}.w_1.weight"] = rng.standard_normal((H, D)) * 0.3
        p[f"m.experts.{i}.w_1.bias"] = rng.standard_normal(H) * 0.1
        p[f"m.experts.{i}.w_2.weight"] = rng.standard_normal((D, H)) * 0.3
        p[f"m.experts.{i}.w_2.bias"] = rng.standard_normal(D) * 0.1
    p = {k: torch.tensor(v, dtype=torch.float32) for k, v in p.items()}
    x = torch.tensor(rng.standard_normal((2, 5, D)), dtype=torch.float32)
    return stack_experts(p, E), x


def close(a, b, rtol=1e-5, atol=1e-6) -> bool:
    return bool(np.allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol))


def params_close(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                 rel: float = 1e-4) -> float:
    """The largest |got - want| over every leaf, in units of
    max(1, max|want|); asserts equal key sets."""
    assert sorted(got) == sorted(want)
    worst = 0.0
    for k, w in want.items():
        scale = max(1.0, float(w.abs().max()))
        worst = max(worst, float((got[k] - w).abs().max()) / scale)
    return worst


# ---------------------------------------------------------------------------
# the worker: every multi-rank check of one world size
# ---------------------------------------------------------------------------


def _worker(world: int, out_dir: str, cli_list: str) -> None:
    torch.set_num_threads(1)
    from cosy_tpu_torch.parallel import mesh as M
    from cosy_tpu_torch.utils.distributed import all_hosts_agree, joined_loader

    dev = M.init_distributed("cpu")
    assert dev.type == "cpu" and torch.distributed.get_backend() == "gloo"
    rank = M.world_rank()
    res: dict = {"rank": rank}
    if world == 2:
        _worker_two(res, rank, out_dir, M, all_hosts_agree, joined_loader)
    else:
        _worker_four(res, M)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    if world == 2:
        # last, since the CLI leaves the process group when it ends:
        # train.full at model 2 with tensor parallelism and a 2-microbatch
        # pipeline, a step, its checkpoint and one export
        from cosy_tpu_torch.train import full as TFULL

        rc = TFULL.main(["--model", "llm", "--train_data", cli_list, "--model_dir",
                         os.path.join(out_dir, "cli_run"), "--tiny", "--device", "cpu",
                         "--batch_size", "4", "--max_steps", "1", "--log_every", "1",
                         "--shuffle_size", "4", "--sort_size", "4", "--mesh_model", "2",
                         "--tensor_parallel", "--pp_microbatches", "2", "--no_zero2"])
        with open(os.path.join(out_dir, f"cli{rank}.txt"), "w") as f:
            f.write(str(rc))
        return
    torch.distributed.barrier()
    M.finish_distributed()


def _worker_two(res, rank, out_dir, M, all_hosts_agree, joined_loader) -> None:
    from cosy_tpu_torch.parallel import tp as TP

    # agreement (tests/test_multihost.py): 3 and 5 batches stop at 3
    res["joined"] = list(joined_loader(range(3 if rank == 0 else 5)))
    res["agree_dissent"] = all_hosts_agree(rank == 0)
    res["agree_all"] = all_hosts_agree(True)

    dp2 = M.make_mesh(device="cpu")
    res["dp2_shape"] = dict(dp2.shape)
    res["dynamic_chunk"] = dynamic_chunk_rows(dp2)
    ck_z2 = os.path.join(out_dir, "ckpt_zero2")
    tr, losses = run_full(dp2, 2, zero2=True)
    res["zero2_split"] = sum(a is not None for a in tr._zaxis.values())
    tr.save_checkpoint(ck_z2, async_save=False)
    losses.append(tr.step(flow_super(2), step_gen(2))["loss"])
    res["zero2_losses"], res["zero2_params"] = losses, tr.whole_params()
    tr, losses = run_full(dp2, 2, zero2=False)
    res["plain_losses"], res["plain_params"] = losses, tr.whole_params()
    res["joint_losses"], res["joint_loras"] = run_joint(dp2, os.path.join(out_dir, "joint"))
    res["gan_metrics"], res["gan_params"] = run_gan(dp2)
    _preempt_two(res, rank, dp2, out_dir)

    seq2 = M.make_mesh(dp=1, seq=2, device="cpu")
    tr, losses = run_full(seq2, 2, sequence_parallel=True)
    res["sp_losses"], res["sp_params"] = losses, tr.whole_params()

    model2 = M.make_mesh(dp=1, model=2, device="cpu")
    _pipeline_two(res, model2)
    res["pp_step"] = run_llm_pp(model2, 2)
    # tensor and pipeline parallelism together: the pipeline stacks the
    # blocks' tp-split weights gathered whole (parallel/pp.py)
    from cosy_tpu_torch.parallel import pp as PP

    before = PP.engaged()
    res["tp_pp_step"] = run_llm_pp(model2, 2, tensor_parallel=True)
    res["tp_pp_engaged"] = PP.engaged() - before
    _moe_two(res, model2)
    ck_tp = os.path.join(out_dir, "ckpt_tp")
    tr, losses = run_full(model2, 2, tensor_parallel=True)
    res["tp_split"] = TP.count_sharded(tr.param_specs)
    tr.save_checkpoint(ck_tp, async_save=False)
    losses.append(tr.step(flow_super(2), step_gen(2))["loss"])
    res["tp_losses"], res["tp_params"] = losses, tr.whole_params()
    res["ckpt_dirs"] = {"zero2": ck_z2, "tp": ck_tp}
    _tp_serving_two(res, rank, out_dir, model2)

    from cosy_tpu_torch.train import full as TFULL

    try:  # a batch dp does not divide is refused before any data is read
        TFULL.main(["--model", "llm", "--train_data", "unused.list", "--model_dir",
                    os.path.join(out_dir, "cli"), "--tiny", "--device", "cpu",
                    "--batch_size", "3"])
        res["cli_refusal"] = None
    except SystemExit as e:
        res["cli_refusal"] = str(e)


def _tp_serving_two(res, rank, out_dir, mesh) -> None:
    """serve --tp's pieces over model 2, each beside the world of one: the
    decodes and flows of test_torch_tp_serve.py's helpers, then
    ``serve.main --tp 2`` (rank 0 serving, rank 1 following) against a
    world-one server over the same requests."""
    import test_torch_tp_serve as TS

    res["tp_decodes"] = {case: (TS.decode_case(case, mesh), TS.decode_case(case))
                         for case in TS.DECODES}
    z = np.load(os.path.join(out_dir, "tp_flow_z.npy"))
    res["tp_flows"] = {v: (TS.flow_case(v, z, mesh), TS.flow_case(v, z)) for v in TS.FLOWS}
    res["tp_cv2"] = (TS.cv2_case(mesh), TS.cv2_case())
    d = os.path.join(out_dir, "tp_serve")
    if rank == 0:
        write_serve_dir(d)
    torch.distributed.barrier()
    res["tp_serve"] = run_tp_server(rank, d)


def write_serve_dir(d: str) -> None:
    """test_torch_serve.py's tiny CosyVoice as a model dir (seed 40) with
    two voices' adapter files."""
    from cosy_tpu_torch.config import LoRAConfig
    from cosy_tpu_torch.lora import init_lora
    from cosy_tpu_torch.models.hift import init_hift_params
    from cosy_tpu_torch.params import save_torch_checkpoint

    os.makedirs(d)
    mods = {"llm": TLLM.init_llm_params(CFG.llm, "cpu", seed=40),
            "flow": TF.init_flow_params(CFG.flow, "cpu", seed=41),
            "hift": init_hift_params(CFG.hift, "cpu", seed=42)}
    for name, m in mods.items():
        save_torch_checkpoint(m.state_dict(), os.path.join(d, f"{name}.pt"))
    llm = {k: v.detach() for k, v in mods["llm"].state_dict().items()}
    for voice, seed in (("alice", 7), ("bob", 8)):
        lo = init_lora(torch.Generator().manual_seed(seed), llm,
                       LoRAConfig(r=2, alpha=4, dropout=0.0))
        save_torch_checkpoint({**{"llm." + k: (v * 8 if ".lora_B" in k else v).detach()
                                  for k, v in lo.items()},
                               "llm._scaling": torch.tensor(2.0)},
                              os.path.join(d, f"adapters_{voice}.pt"))


SERVE_WAIT = 120  # seconds: the bound of each request and of the server's start


def tts_script(url: str) -> dict:
    """The requests both servers answer, in one order (the seeds are drawn
    in it): a whole request, a voiced stream (a cohort), an engine stream,
    an engine stream closed within its first piece, two concurrent whole
    requests of one text (one batch, or two whose rows take the same
    seeds), an unknown voice.  Bytes as received."""
    import http.client
    import json as _json
    import threading
    import urllib.error
    import urllib.request

    def post(body):
        req = urllib.request.Request(f"{url}/tts", data=_json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=SERVE_WAIT) as r:
            return r.read()

    out = {"whole": post({"text": "hi."}),
           "cohort": post({"text": "hey.", "stream": True, "voice": "alice"}),
           "engine": post({"text": "hi.", "stream": True})}
    host, port = url.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=SERVE_WAIT)
    conn.request("POST", "/tts", _json.dumps({"text": "hello there.", "stream": True}),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    out["closed"] = r.read(44 + 2048)  # the header and 1024 samples of the first piece
    conn.close()
    pair = [None, None]

    def one(i):
        pair[i] = post({"text": "hello."})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=SERVE_WAIT)
    out["pair"] = sorted(pair)
    try:
        post({"text": "hi.", "voice": "carol"})
        out["unknown"] = 200
    except urllib.error.HTTPError as e:
        out["unknown"] = e.code
    deadline = time.time() + SERVE_WAIT
    while True:  # a request is recorded after its handler ends (the closed one's later)
        with urllib.request.urlopen(f"{url}/stats", timeout=SERVE_WAIT) as r:
            out["stats"] = _json.loads(r.read())
        if sum(out["stats"]["requests"].values()) >= 7 or time.time() > deadline:
            return out
        time.sleep(0.05)


def _serve_args(d: str) -> List[str]:
    voices = ",".join(f"{v}={os.path.join(d, f'adapters_{v}.pt')}" for v in ("alice", "bob"))
    return ["--model-dir", d, "--device", "cpu", "--finetuned-norm", "1", "--voices", voices,
            "--engine-slots", "2", "--int8", "--attn-window", "4"]


def run_tp_server(rank: int, d: str) -> dict:
    """``serve.main --tp 2`` on both ranks; rank 0 runs :func:`tts_script`
    against it from a thread, then SIGTERMs itself (the drain), and
    against a world-one server after.  Returns what each rank saw."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import cosy_tpu_torch.api as TAPI
    from cosy_tpu_torch import serve as S
    from cosy_tpu_torch.config import InferenceConfig

    real = TAPI.CosyVoice

    def tiny(model_dir, infer_cfg=None, **kw):  # the tiny topology: no cosyvoice.yaml
        return real(model_dir, model_cfg=CFG, **kw,
                    infer_cfg=infer_cfg or InferenceConfig(max_token_text_ratio=3.0))

    TAPI.CosyVoice = tiny
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    out: dict = {}
    try:
        port = free_port()
        if rank == 0:
            def client():
                url = f"http://127.0.0.1:{port}"
                try:
                    deadline = time.time() + SERVE_WAIT
                    while True:
                        try:
                            urllib.request.urlopen(f"{url}/healthz", timeout=5).read()
                            break
                        except OSError:
                            if time.time() > deadline:
                                raise
                            time.sleep(0.1)
                    out["tp"] = tts_script(url)
                except Exception as e:  # noqa: BLE001 - reported by the test
                    out["client_error"] = repr(e)
                finally:
                    os.kill(os.getpid(), signal.SIGTERM)

            threading.Thread(target=client, daemon=True).start()
        out["main"] = S.main(_serve_args(d) + ["--tp", "2", "--port", str(port)])
        if rank == 0:  # the world-one server over the same requests
            os.environ["WORLD_SIZE"] = "1"
            try:
                server = S.build_server(S.build_parser().parse_args(_serve_args(d)))
            finally:
                os.environ["WORLD_SIZE"] = "2"
            httpd = ThreadingHTTPServer(("127.0.0.1", 0), S.make_handler(server, CFG.sample_rate))
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            try:
                out["one"] = tts_script(f"http://127.0.0.1:{httpd.server_address[1]}")
            finally:
                httpd.shutdown()
                httpd.server_close()
                server.engine.stop(timeout=SERVE_WAIT)
    finally:
        TAPI.CosyVoice = real
        for s, h in handlers.items():
            signal.signal(s, h)
    return out


def _preempt_two(res, rank, mesh, out_dir) -> None:
    """A SIGTERM to rank 1 alone at its loader's item 2: both ranks stop on
    the same step, and rank 0 writes the snapshot."""
    from cosy_tpu_torch.train.trainer import JointTrainer

    cfg, tcfg, llm, flow = joint_setup()
    tcfg = dataclasses.replace(tcfg, training_mode="llm_only", max_epochs=1)
    d = os.path.join(out_dir, "preempt")
    tr = JointTrainer(cfg, tcfg, llm, flow, out_dir=d, total_steps=10, mesh=mesh)

    def loader():
        for i in range(6):
            if rank == 1 and i == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            yield joint_super(i)

    state = tr.fit(loader(), generator=torch.Generator().manual_seed(0), log_every=100)
    res["preempt_step"] = state.step
    res["preempt_snapshot"] = os.path.exists(os.path.join(d, "joint_llm_only_preempt.ckpt.pt"))
    res["preempt_handler_back"] = signal.getsignal(signal.SIGTERM) is signal.SIG_DFL


def _pipeline_two(res, mesh) -> None:
    """An S = 2 GPipe pipeline (2 microbatches) against the sequential stack:
    the forward and the gradients of every parameter and of the input;
    then a FullTrainer step with the pipeline against one without."""
    from cosy_tpu_torch.layers.conformer import encoder_forward
    from cosy_tpu_torch.parallel import pp as PP

    cfg, params, xs, lens = pp_inputs()
    w = torch.randn(10, cfg.output_size, generator=torch.Generator().manual_seed(1))
    out = {}
    for name, pipelined in (("seq", False), ("pp", True)):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        x = xs.clone().requires_grad_(True)
        before = PP.engaged()
        with PP.pipeline_context(mesh, 2) if pipelined else _null():
            h, _ = encoder_forward(P(p), cfg, x, lens, Ctx(train=True), conformer=False)
        (h * w).sum().backward()
        out[name] = (h.detach(), {k: v.grad for k, v in p.items()}, x.grad,
                     PP.engaged() - before)
    res["pp_forward"] = (out["pp"][0], out["seq"][0])
    res["pp_grads"] = (out["pp"][1], out["seq"][1])
    res["pp_dx"] = (out["pp"][2], out["seq"][2])
    res["pp_engaged"] = out["pp"][3]


def _moe_two(res, mesh) -> None:
    """Stacked experts split over model 2 against the replicated layer."""
    from cosy_tpu_torch.layers.basic import ACT
    from cosy_tpu_torch.layers.conformer import moe_ffn
    from cosy_tpu_torch.parallel import tp as TP

    p, x = moe_inputs()
    outs = []
    for split in (False, True):
        layout = {k: TP.tp_spec(k, v.shape, mesh.size("model")) for k, v in p.items()}
        specs = {k: (() if a is None else (None,) * a + ("model",)) for k, a in layout.items()}
        mine = {k: TP.local_shard(v, specs[k], mesh).clone().requires_grad_(True)
                if split else v.clone().requires_grad_(True) for k, v in p.items()}
        xi = x.clone().requires_grad_(True)
        with TP.tensor_parallel(mesh, layout) if split else _null():
            y = moe_ffn(P(mine), "m", xi, 4, 2, ACT["relu"])
        (y * torch.arange(y.numel(), dtype=y.dtype).reshape(y.shape).sin()).sum().backward()
        grads = {k: TP.gather_whole(v.grad, specs[k], mesh) if split else v.grad
                 for k, v in mine.items()}
        outs.append((y.detach(), grads, xi.grad, sum(a is not None for a in layout.values())))
    res["moe"] = outs


def _worker_four(res, M) -> None:
    from cosy_tpu_torch.parallel import tp as TP

    dp_model = M.make_mesh(dp=2, model=2, device="cpu")
    tr, losses = run_full(dp_model, 3, zero2=True, tensor_parallel=True)
    res["tp4_losses"], res["tp4_split"] = losses, TP.count_sharded(tr.param_specs)
    dp_seq = M.make_mesh(dp=2, seq=2, device="cpu")
    tr, losses = run_full(dp_seq, 2, sequence_parallel=True)
    res["sp4_losses"], res["sp4_params"] = losses, tr.whole_params()


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


# ---------------------------------------------------------------------------
# the launches
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv: List[str], world: int, timeout: float = LAUNCH_TIMEOUT,
           extra_env: dict = None) -> List[subprocess.CompletedProcess]:
    """``world`` ranks of ``argv`` with torchrun's environment; kills every
    rank when the wait runs out.  Each rank writes to a file of its own (a
    full pipe would stall a rank, and the others in its next collective)."""
    port = free_port()
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=ROOT)
        env.update(extra_env or {})
        logs.append(tempfile.TemporaryFile("w+"))
        procs.append(subprocess.Popen(argv, cwd=ROOT, env=env, stdout=logs[-1],
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p, log in zip(procs, logs):
            p.wait(timeout=timeout)
            log.seek(0)
            outs.append(subprocess.CompletedProcess(argv, p.returncode, log.read(), None))
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return outs


def tensorboard_stub(tmp: str) -> str:
    """A directory holding a stand-in ``tensorboard`` package that fails to
    import, which keeps the trainers' TB writers off (the real one pulls in
    TensorFlow, seconds a process)."""
    stub = os.path.join(tmp, "stub")
    os.makedirs(os.path.join(stub, "tensorboard"), exist_ok=True)
    with open(os.path.join(stub, "tensorboard", "__init__.py"), "w") as f:
        f.write("raise ImportError('tensorboard is stubbed out in this test')\n")
    return stub


def _run_worker(world: int, out_dir: str, cli_list: str = "") -> List[dict]:
    outs = launch([sys.executable, os.path.abspath(__file__), "--worker", str(world), out_dir,
                   cli_list], world,
                  extra_env={"PYTHONPATH": os.pathsep.join([tensorboard_stub(out_dir), ROOT])})
    for r, o in enumerate(outs):
        assert o.returncode == 0, f"rank {r}:\n{o.stdout[-4000:]}"
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def torchrun(module_argv: List[str], nproc: int, tmp: str,
             timeout: float = LAUNCH_TIMEOUT) -> subprocess.CompletedProcess:
    """``python -m torch.distributed.run --nproc-per-node N -m ...``; the
    whole process group of the launch is killed when the wait runs out."""
    stub = tensorboard_stub(tmp)
    argv = [sys.executable, "-m", "torch.distributed.run", f"--nproc-per-node={nproc}",
            "--master-addr=127.0.0.1", f"--master-port={free_port()}", "-m", *module_argv]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join([stub, ROOT]))
    proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    return subprocess.CompletedProcess(argv, proc.returncode, out, None)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    from test_torch_train_full_cli import write_dataset

    from test_torch_tp_serve import jax_flow_z

    out = str(tmp_path_factory.mktemp("two"))
    np.save(os.path.join(out, "tp_flow_z.npy"), jax_flow_z())
    ranks = _run_worker(2, out, write_dataset(out, "train", n=4))
    for r in ranks:
        with open(os.path.join(out, f"cli{r['rank']}.txt")) as f:
            r["cli_rc"] = int(f.read())
        r["cli_dir"] = os.path.join(out, "cli_run")
    return ranks


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _run_worker(4, str(tmp_path_factory.mktemp("four")))


@pytest.fixture(scope="module")
def world1():
    """The single-process references (no process group: a world of one)."""
    tr, z = run_full(None, 3)
    ref = {"losses": z}
    tr2, _ = run_full(None, 2)
    ref["params2"] = tr2.whole_params()
    ref["params3"] = tr.whole_params()
    return ref


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


def _full_width_leaves():
    """name -> shape of every leaf of the full-width models: ModelConfig()'s
    LLM and flow, Qwen2-0.5B, Flow2Config() and the HiFT vocoder."""
    from cosy_tpu_torch.config import ModelConfig
    from cosy_tpu_torch.models.flow import flow_spec
    from cosy_tpu_torch.models.flow2 import Flow2Config, flow2_spec
    from cosy_tpu_torch.models.hift import hift_spec
    from cosy_tpu_torch.models.llm import llm_spec
    from cosy_tpu_torch.models.qwen2lm import Qwen2LMConfig, qwen2lm_spec

    cfg = ModelConfig()
    leaves = {}
    for tag, spec in (("llm", llm_spec(cfg.llm)), ("flow", flow_spec(cfg.flow)),
                      ("qwen2", qwen2lm_spec(Qwen2LMConfig())),
                      ("flow2", flow2_spec(Flow2Config())), ("hift", hift_spec(cfg.hift))):
        leaves.update({f"{tag}/{k}": shape for k, (shape, _) in spec.entries.items()})
    return leaves


class _Sizes:
    """A mesh's axis sizes, for the pure layout rules (no process group)."""

    def __init__(self, dp=1, seq=1, model=1):
        self.shape = {"dp": dp, "seq": seq, "model": model}

    def size(self, axis):
        return self.shape[axis]


def _jspec(ps) -> tuple:
    spec = list(ps)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


@pytest.fixture(scope="module")
def leaves():
    return _full_width_leaves()


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_spec_equals_jax_on_every_full_width_leaf(leaves, tp):
    from cosy_tpu.parallel import tp as JTP
    from cosy_tpu_torch.parallel import tp as TP

    split = 0
    for name, shape in leaves.items():
        want = _jspec(JTP.tp_spec(name.split("/", 1)[1], shape, tp))
        got = TP.tp_spec(name.split("/", 1)[1], shape, tp)
        assert (() if got is None else (None,) * got + ("model",)) == want, name
        split += got is not None
    assert split > 100


@pytest.mark.parametrize("tp, dp", [(1, 2), (1, 4), (2, 2), (2, 4), (4, 2), (4, 4)])
def test_compose_zero2_and_zero2_sharding_equal_jax(leaves, tp, dp):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from cosy_tpu.parallel import tp as JTP
    from cosy_tpu.train.full_trainer import zero2_sharding as j_zero2
    from cosy_tpu_torch.parallel import tp as TP
    from cosy_tpu_torch.train.full_trainer import zero2_sharding

    devs = jax.devices()
    jmesh = Mesh(np.asarray((devs * 2)[:dp * tp]).reshape(dp, 1, tp), ("dp", "seq", "model"))
    names = {n.split("/", 1)[1]: s for n, s in leaves.items()}
    jparams = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in names.items()}
    tparams = {k: torch.empty(s, device="meta") for k, s in names.items()}
    mesh = _Sizes(dp=dp, model=tp)
    want = JTP.compose_zero2(jmesh, jparams, JTP.tp_param_shardings(jmesh, jparams))
    got = TP.compose_zero2(mesh, tparams, TP.tp_param_shardings(mesh, tparams))
    assert {k: got[k] for k in names} == {k: _jspec(v.spec) for k, v in want.items()}
    if tp == 1:
        want = j_zero2(jmesh, jparams)
        got = zero2_sharding(mesh, tparams)
        assert {k: got[k] for k in names} == {k: _jspec(v.spec) for k, v in want.items()}


def test_stack_experts_equals_jax():
    import jax.numpy as jnp

    from cosy_tpu.parallel import tp as JTP
    from cosy_tpu_torch.parallel.tp import stack_experts

    p, _ = moe_inputs()
    rng = np.random.default_rng(1)
    flat = {f"e.experts.{i}.{w}.{b}": rng.standard_normal((3, 2) if b == "weight" else (3,))
            .astype(np.float32) for i in range(4) for w in ("w_1", "w_2")
            for b in ("weight", "bias")}
    flat["e.gate.weight"] = rng.standard_normal((4, 2)).astype(np.float32)
    want = JTP.stack_experts({k: jnp.asarray(v) for k, v in flat.items()}, 4)
    got = stack_experts({k: torch.from_numpy(v) for k, v in flat.items()}, 4)
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k].numpy(), np.asarray(want[k])) for k in want)
    assert "m.experts_stacked.w_1.weight" in p and p["m.experts_stacked.w_1.weight"].shape[0] == 4


@pytest.mark.parametrize("case", ["one_stage", "blocks", "batch", "dropout", "dynamic_chunk",
                                  "lora"])
def test_maybe_pipeline_declines_ineligible_stacks(case):
    """JAX's rules (cosy_tpu/parallel/pp.py:186-213), each case declined
    before any collective."""
    from cosy_tpu_torch.parallel import pp as PP

    cfg, params, xs, lens = pp_inputs()
    S, ctx = 2, Ctx(train=True)
    if case == "one_stage":
        S = 1
    elif case == "blocks":
        cfg = dataclasses.replace(cfg, num_blocks=3)
    elif case == "batch":
        xs = xs[:3]
    elif case == "dropout":
        cfg = dataclasses.replace(cfg, attention_dropout_rate=0.1)
    elif case == "dynamic_chunk":
        cfg = dataclasses.replace(cfg, use_dynamic_chunk=True)
    else:
        ctx = Ctx(train=True, lora={"x": torch.zeros(1)})
    assert PP.eligible(llm_nodrop(), 4, Ctx(train=True), 2, 2)
    assert not PP.eligible(cfg, xs.shape[0], ctx, S, 2)
    with PP.pipeline_context(_Sizes(model=S), 2):
        assert PP.maybe_pipeline(P(params), cfg, xs, lens[:xs.shape[0]], ctx, True) is None


def test_agreement_stops_every_rank_together(two):
    for r in two:
        assert r["joined"] == [0, 1, 2]
        assert r["agree_dissent"] is False and r["agree_all"] is True


def test_dynamic_chunks_agree_across_dp_ranks(two):
    """Each dp rank's rows of a dynamic-chunk training forward equal the
    world-one forward's: both ranks drew the chunk of the single process."""
    _, _, want = dynamic_chunk_rows(None)
    covered = []
    for r in two:
        lo, hi, outs = r["dynamic_chunk"]
        covered += list(range(lo, hi))
        for got, full in zip(outs, want):
            assert close(got, full[lo:hi])
    assert sorted(covered) == [0, 1, 2, 3]


@pytest.mark.parametrize("zero2", [True, False], ids=["zero2", "no_zero2"])
def test_full_trainer_dp2_equals_world_one(two, world1, zero2):
    key = "zero2" if zero2 else "plain"
    for r in two:
        assert r["dp2_shape"] == {"dp": 2, "seq": 1, "model": 1}
        assert close(r[f"{key}_losses"][:2], world1["losses"][:2])
        assert params_close(r[f"{key}_params"],
                            world1["params3" if zero2 else "params2"]) < 1e-4
    if zero2:
        assert two[0]["zero2_split"] > 20  # the moments really split over dp
        assert close(two[0]["zero2_losses"], world1["losses"])


def test_joint_trainer_dp2_equals_world_one(two, tmp_path):
    losses, loras = run_joint(None, str(tmp_path))
    for r in two:
        assert close(r["joint_losses"], losses)
        assert params_close(r["joint_loras"], loras) < 1e-4


def test_gan_trainer_dp2_equals_world_one(two):
    ms, params = run_gan(None)
    for r in two:
        for got, want in zip(r["gan_metrics"], ms):
            assert sorted(got) == sorted(want)
            assert all(close(got[k], want[k]) for k in want), (got, want)
        assert params_close(r["gan_params"], params) < 1e-4


def test_tensor_parallel_dp2_model2_equals_dp2(two, four):
    """JAX's tolerance (tests/test_full_trainer.py:103) over three steps."""
    want = two[0]["zero2_losses"]
    for r in four:
        assert r["tp4_split"] >= 8
        np.testing.assert_allclose(r["tp4_losses"], want, rtol=2e-4, atol=2e-5)


def test_tensor_parallel_model2_equals_world_one(two, world1):
    for r in two:
        assert r["tp_split"] >= 8
        np.testing.assert_allclose(r["tp_losses"], world1["losses"], rtol=2e-4, atol=2e-5)
        assert params_close(r["tp_params"], world1["params3"]) < 1e-4


@pytest.mark.parametrize("layout", ["seq2", "dp2_seq2"])
def test_sequence_parallel_equals_world_one(two, four, world1, layout):
    """JAX's tolerances (tests/test_sp.py:72-78)."""
    ranks, key = (two, "sp") if layout == "seq2" else (four, "sp4")
    for r in ranks:
        np.testing.assert_allclose(r[f"{key}_losses"], world1["losses"][:2], atol=1e-5,
                                   rtol=1e-5)
        for k, v in world1["params2"].items():
            np.testing.assert_allclose(r[f"{key}_params"][k], v, atol=2e-3, rtol=1e-4,
                                       err_msg=k)


def test_pipeline_equals_the_sequential_stack(two):
    for r in two:
        assert r["pp_engaged"] == 1
        got, want = r["pp_forward"]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        got, want = r["pp_dx"]
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
        got, want = r["pp_grads"]
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=2e-4, rtol=2e-4, err_msg=k)


def test_expert_parallel_equals_replicated(two):
    for r in two:
        (y0, g0, dx0, n0), (y1, g1, dx1, n1) = r["moe"]
        assert n1 == 4 and n0 == 4  # the four stacked leaves split over model
        np.testing.assert_allclose(y1, y0, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(dx1, dx0, atol=1e-5, rtol=1e-5)
        for k in g0:
            np.testing.assert_allclose(g1[k], g0[k], atol=1e-5, rtol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def llm_pp_world1():
    return run_llm_pp(None, 2)


def test_full_trainer_pipeline_step_equals_world_one(two, llm_pp_world1):
    loss, params, _ = llm_pp_world1
    for r in two:
        np.testing.assert_allclose(r["pp_step"][0], loss, rtol=1e-5, atol=1e-6)
        assert params_close(r["pp_step"][1], params) < 1e-4


def test_tensor_and_pipeline_parallel_step_equals_world_one(two, llm_pp_world1):
    """Model 2 with tensor parallelism and a 2-microbatch pipeline: the
    blocks' weights are split over the model axis and the pipeline runs
    over them gathered whole; loss and parameters equal the world-one
    step's."""
    loss, params, _ = llm_pp_world1
    for r in two:
        got_loss, got_params, n_split = r["tp_pp_step"]
        assert r["tp_pp_engaged"] > 0 and n_split > 0
        np.testing.assert_allclose(got_loss, loss, rtol=1e-5, atol=1e-6)
        assert params_close(got_params, params) < 1e-4


def test_full_cli_refuses_a_batch_dp_does_not_divide(two):
    for r in two:
        assert r["cli_refusal"] and "must be divisible by the data-parallel mesh size (2" \
            in r["cli_refusal"].replace("data-\nparallel", "data-parallel")


def test_signal_to_one_rank_stops_both_on_the_same_step(two):
    steps = {r["preempt_step"] for r in two}
    assert len(steps) == 1 and 2 <= steps.pop() <= 4
    assert two[0]["preempt_snapshot"] and all(r["preempt_handler_back"] for r in two)


@pytest.mark.parametrize("layout", ["zero2", "tp"])
def test_checkpoint_crosses_layouts_to_world_one(two, layout):
    """A checkpoint written at dp 2 / ZeRO-2 (or model 2) resumes at a
    world of one: its next step equals the multi-rank run's next step."""
    r = two[0]
    tr = FullTrainer(flow_loss, flow_params(), adamw(LR), accum=2)
    assert tr.load_checkpoint(r["ckpt_dirs"][layout]) == 2
    loss = tr.step(flow_super(2), step_gen(2))["loss"]
    tol = dict(rtol=1e-5, atol=1e-6) if layout == "zero2" else dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(loss, r[f"{layout}_losses"][2], **tol)
    assert params_close(tr.whole_params(), r[f"{layout}_params"]) < 1e-4


def test_joint_cli_under_torchrun_rounds_shards_and_exports_once(tmp_path):
    """``torchrun --nproc-per-node 2 -m cosy_tpu_torch.train --device cpu``:
    batch 3 rounds up to 4; each rank reads its shard of the 16 records
    (8 records at 2 rows x accum 2 a step: 2 steps, where a rank reading
    all 16 would take 4); rank 0 alone logs and writes the exports."""
    from test_torch_data import write_records

    data, out = tmp_path / "data", tmp_path / "out"
    write_records(str(data / "train.parquet"), 16, seed=3, vocab=128)
    res = torchrun(["cosy_tpu_torch.train", "--data-dir", str(data), "--output", str(out),
                    "--tiny", "--device", "cpu", "--batch-size", "3", "--accum", "2",
                    "--max-feat-len", "60", "--epochs", "1",
                    "--pretrained", str(tmp_path / "none")], 2, str(tmp_path))
    assert res.returncode == 0, res.stdout[-4000:]
    assert "batch_size rounded up to 4 for the 2-way dp mesh" in res.stdout
    assert "2 steps in" in res.stdout
    assert res.stdout.count("saved merged llm weights") == 1
    assert res.stdout.count("cosy_tpu_torch joint LLM + Flow LoRA training") == 1
    for name in ("llm_merged_joint.pt", "flow_merged_joint.pt", "adapters_joint.pt",
                 "joint_joint_last.ckpt.pt"):
        assert (out / name).exists(), name


def test_full_cli_over_two_ranks_takes_the_parallel_flags(two):
    """``train.full`` on both ranks of the 2-rank launch (torchrun's
    environment) at model 2 with tensor parallelism and a 2-microbatch
    pipeline: a step, rank 0's checkpoint and one export."""
    assert [r["cli_rc"] for r in two] == [0, 0]
    d = two[0]["cli_dir"]
    assert os.path.exists(os.path.join(d, "llm_epoch0.pt"))
    assert os.path.exists(os.path.join(d, "ckpt", "1", "state.pt"))


@pytest.mark.parametrize("case", DECODES)
def test_tp_decode_over_model2_equals_world_one(two, case):
    """serve --tp's decodes in f64 with the LLM split over 2 ranks (the
    solo, batched, two-voice, int8 and Qwen2 decodes): every rank's tokens
    are the world-one port's, which test_torch_tp_serve.py holds to the JAX
    package's tp decodes."""
    got, want = two[0]["tp_decodes"][case]
    assert got == two[1]["tp_decodes"][case][0] == want
    assert all(len(row) >= 2 for row in want)


@pytest.mark.parametrize("variant", FLOWS)
def test_tp_flow_over_model2_within_tolerance_of_world_one(two, variant):
    """The flow split over 2 ranks (JAX's z injected, f64): Euler, a
    windowed estimator, the MeanFlow sampler and Euler through the fused
    block's chain (each block's split weights all-gathered first), within
    tests/test_tp_decode.py's 2e-4 of the world-one flow of that variant."""
    got, want = two[0]["tp_flows"][variant]
    assert got.shape == want.shape == (1, 80, 13)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FLOW_TOL)
    np.testing.assert_allclose(two[1]["tp_flows"][variant][0].numpy(), got.numpy(), **FLOW_TOL)


def test_tp_cosyvoice2_pipeline_over_model2_equals_world_one(two):
    """``TTS2Pipeline.shard`` over 2 ranks (f32): a whole synthesis, a
    streamed one and a batch of two give the world-one wavs (the same
    lengths, so the same tokens) within 1e-4 x max(1, max|wav|)."""
    got, want = two[0]["tp_cv2"]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.size > 0
        assert np.abs(g - w).max() <= 1e-4 * max(1.0, np.abs(w).max())


def _pcm(body: bytes) -> np.ndarray:
    assert body[:4] == b"RIFF" and len(body) > 44
    return np.frombuffer(body[44:44 + (len(body) - 44) // 2 * 2], "<i2").astype(np.int64)


@pytest.mark.parametrize("what", ["whole", "cohort", "engine", "closed", "pair", "unknown"])
def test_tp_server_answers_as_a_world_one_server(two, what):
    """``serve.main --tp 2 --voices ... --engine-slots 2 --int8
    --attn-window 4`` (rank 0 serving over 127.0.0.1, rank 1 following)
    against a world-one server with those flags over the same requests and
    seeds:
    a whole request, a voiced stream (a cohort), an engine stream, one
    closed within its first piece, two concurrent whole requests, an unknown
    voice (400).  The servers run in f32, so the column split's sums may
    round differently: equal lengths, every PCM16 sample within one step."""
    serve = two[0]["tp_serve"]
    assert "client_error" not in serve, serve.get("client_error")
    tp, one = serve["tp"][what], serve["one"][what]
    if what == "unknown":
        assert tp == one == 400
        return
    for a, b in zip(tp if what == "pair" else [tp], one if what == "pair" else [one]):
        a, b = _pcm(a), _pcm(b)
        assert a.size == b.size > 0
        assert np.abs(a - b).max() <= 1


def test_tp_server_follower_replays_every_section_and_both_exit(two):
    """Rank 1 replayed every device section rank 0 sent, none raised, the
    routes were the world-one server's, and both ranks left ``main`` after
    rank 0's SIGTERM drain (the launch asserts exit code 0)."""
    sent, followed = two[0]["tp_serve"]["main"], two[1]["tp_serve"]["main"]
    assert followed == {"replayed": sent["sent"], "errors": []} and sent["sent"] > 5
    stats = [two[0]["tp_serve"][k]["stats"] for k in ("tp", "one")]
    assert stats[0]["requests"] == stats[1]["requests"] == {
        "batched": 3, "stream_cohort": 1, "stream_engine": 2, "bad_request": 1}


if __name__ == "__main__" and len(sys.argv) == 5 and sys.argv[1] == "--worker":
    _worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
