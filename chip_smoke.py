#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (cosy_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught and passed over):
  1. the card: name, power limit;
  2. build of the CUDA kernels from cosy_tpu_torch/csrc (nvcc, sm_90a) into
     build/cosy_tpu_torch/;
  3. every kernel against its plain PyTorch version on the card, on the same
     inputs, within a stated tolerance, with its time, the plain version's
     time and one library call's time as a yardstick (TF32 off for matmul
     and cuDNN in every comparison; CUDA-event means of back-to-back calls,
     and beside them the kernels' own time on the card from torch.profiler
     (ops/plan_sweep.py device_ms), which leaves out the waits for the host);
     the block's kernels B1 (ln_gemm) and B2 (block_tail) at 312, 624 and
     5116 rows in f32 and bf16 (B1's x with rows at |mean| / std = 24 and
     rows with an outlier in column 0, B2's x with rows whose x1 lies at
     |mean| / std ~10-30 and with an outlier; B1 also at 156 rows in bf16, with f32
     x under bf16 weights and at ragged K and segment rows), the
     block beside the seven-launch chain of
     the kept LayerNorm and GEMM kernels; A, the block, B1 and B2 at the
     streaming path's shapes (206 / 103 frames without a bias, the final
     bucket's 220 / 110 with one; 412, 206, 440 and 220 rows) with the
     plans they pick; A on the fused block's strided views, and A and C
     unsplit and over a cluster of 2; the plans that split return the
     same bits on two calls;
  4. one full-width estimator call on the card (kernels) against the same
     call on the CPU (plain versions);
  5. full-width prompt-free CosyVoice-300M synthesis on random seeded
     weights through TTSPipeline.synthesize, with the launch counters reset
     just before and read just after: every kernel of the path must have
     run, the fused block, B1 and B2 exactly 64 x NFE times (three launches
     a block) and the LayerNorm and GEMM kernels not at all;
  6. where the time goes: one estimator call at the main path's shape under
     torch.profiler (device busy share, device time by kernel);
  7. the windowed long-utterance configuration: full-width synthesis of 1485
     seeded speech tokens (2558 mel frames, NFE 20) through
     TTSPipeline.token2wav with attn_window = 256, counters reset before and
     read after: banded attention (kernel C) exactly 64 x NFE times and no
     fused block; then the same tokens with full attention, both flow times
     and the relative difference of the two mels;
  8. the joint LoRA training step at full width: JointTrainer in joint mode,
     bf16 compute, 3 steps on one seeded super-batch (accumulation 2 x batch
     8, 250 mel frames): finite losses, a gradient, a falling loss, base
     weights bit-identical, no kernel launched, and a merge that changes
     them (phase 11 synthesizes from merged weights);
  9. streaming synthesis at full width: 20 seeded text ids decode exactly
     400 tokens (EOS held off, cap 400) through
     TTSPipeline.synthesize(stream=True): three 120-token windows and a
     bucketed final of 100, chunk lengths as stream_plan says, every chunk
     finite, counters reset before and read after: 64 x NFE 40 fused
     blocks of three launches, no LayerNorm or GEMM launch; the streamed
     tokens equal generate_tokens'; time to the first chunk and seconds per
     chunk;
 10. batched serving: 4 requests of 6-12 ids (120-240 tokens) through
     synthesize_batch, batched tokens against the 4 solo decodes (equal,
     or at the first diverging step a teacher-forced logit gap within
     1e-4 * max(1, max|logit|)), decode tokens/s at B = 4 against B = 1;
     then 6 requests through ContinuousBatchEngine(slots=4), prefetch off
     and on: all finish, one at least admitted mid-flight, each stream its
     solo decode's, every chunk finite and as planned, 64 x the chunks' NFE
     fused blocks, prefetch hits 0 off and > 0 on; (d) the device-resident
     decode: a segment enqueued under set_sync_debug_mode("error") (no host
     read inside a step; host reads within its chunks), request 0's card
     tokens against the CPU decode (the same rule), tokens/s over 100
     steps at B = 1 and 4, f32 and int8, host reads and frozen steps a
     segment;
 11. the training CLI at full width (python -m cosy_tpu_torch.train's
     main() on parquet records when pandas and pyarrow import, else its
     run() on the same records): 32 seeded records at batch 8 x accum 2
     (2 steps), a --resume over 16 more (1 step, the counter at 3), the
     merged and adapter exports, a synthesis from the merged weights;
     seconds a step, the loader's wait a step, peak memory;
 12. CosyVoice2 at full width (Qwen2LMConfig(): Qwen2-0.5B; Flow2Config();
     the 24 kHz HiFT) on seeded weights through TTS2Pipeline, EOS held off
     to 150 attempts: (a) whole utterance with a 50-token / 100-frame flow
     prompt and an LLM prompt, (b) streamed, prompt-free: 25-token hops
     plus 3 lookahead, each window with the static-chunk (2, T, T) bias,
     then the bucketed final, (c) 4 requests decoded as one batch against
     their solo decodes (the phase-10 rule) and synthesize_batch; counters
     reset before and read after each: 64 x NFE 10 x flow calls fused
     blocks; one streaming estimator call against the CPU;
 13. CosyVoice2 serving at full width on phase 12's weights, EOS held off to
     min(15 n, 100) attempts for n text ids, 25-token hops: (a)
     synthesize_stream_batch of 4 requests, (b) ContinuousBatchEngine over a
     TTS2Pipeline, 4 slots and 6 requests (two admitted mid-flight),
     prefetch off and on (hits 0 and > 0), each stream held to its solo
     streamed synthesis (tokens by the phase-10 rule, chunks within 1e-4 *
     max(1, max|wav|)), counters reset before and read after each: 64 x
     NFE 10 x chunks fused blocks; (c) a bistream
     decode over 4 text chunks with a speech prompt, each advance's logits
     against qwen2lm_teacher_forced_logits over the same embeddings
     (1e-4 * max(1, max|logit|)); first-chunk times and tokens/s; (d) a
     Qwen2 decode segment enqueued under set_sync_debug_mode("error") and
     request 1's card tokens against the CPU decode;
 14. the frontend and data prep on the card: mel_spectrogram (22.05 and
     24 kHz) and mel_spectrogram_prepadded against the CPU, the replica
     campplus and S3 graphs through compat.onnx against the CPU run and the
     replica torch module, Frontend(sample_rate=24000).frontend_zero_shot
     of a seeded 16 kHz prompt and TTS2Pipeline.synthesize from its dict
     (64 x NFE 10 fused blocks), and the preparer's CLI on 8 seeded clips
     with the replica graphs, one batch of its shards read back;
 15. the user API, multi-voice LoRA serving and the HTTP server at full
     width (CosyVoice-300M ModelConfig(), seeded weights written as
     llm/flow/hift.pt beside the replica ONNX graphs): (a) CosyVoice(dir)
     on the card, zero-shot (whole and streamed), cross-lingual, instruct
     with an add_zero_shot_spk speaker and vc, every chunk finite and 64 x
     NFE fused blocks a flow call; one prompted flow call against the CPU;
     (b) two voices of seeded adapters (LLM_LORA_DEFAULT /
     FLOW_LORA_DEFAULT, B x 8) through load_voice_adapters and set_voices:
     each voiced request against a pipeline on that voice's merged weights
     (tokens by the phase-10 rule, the wav within 1e-4 * max(1, max|wav|)),
     its flow in unfused blocks (kernel A alone 64 x NFE times, no fused
     block); a mixed batch of 4 whose base rows' tokens equal the unvoiced
     batch's; an unknown voice raises; (c) TTSServer (engine_slots=4,
     voices registered) after warmup() on 127.0.0.1: a whole request, a
     streamed one (the engine), 4 concurrent whole requests (fewer than 4
     batches), a voiced one, the client's tts and tts_stream, /stats and
     /metrics; time to the first chunk, RTF, the wall of the four;
 16. the other training regimes at full width on seeded weights: (a)
     MeanFlow: phase 5's flow branched (add_meanflow_time_branch), three
     integral-target FlowDistiller steps (4 teacher sub-steps) and one
     jvp-target step on B = 2 at 250 / 220 frames, the teacher's launches
     counted a step (exactly 4 x 64 and 64 fused blocks); phase 5's 181
     tokens synthesized with sampler="meanflow" at 1 and 2 steps (64 x
     steps fused blocks, no lone A) and held to the CPU, the flow stage
     against the Euler solve at NFE 15; then the export through
     python -m cosy_tpu_torch.infer --meanflow (in-process) and TTSServer
     --sampler meanflow, whose refusal of Euler on distilled weights is
     checked; two --cosyvoice2 distillation steps at Flow2Config() (the
     second with the streaming estimator; 4 x 64 teacher blocks each) and
     TTS2Pipeline's first streamed MeanFlow window on their export (64 x 2
     fused blocks), its mel held to the CPU; A, B, B1 and B2 at the
     MeanFlow path's and the teacher's shapes; (b) two FullTrainer steps
     (accumulation 2 x batch 4) each for the 300M LLM, the vendored flow,
     Qwen2-0.5B, Flow2Config() and DPO on Qwen2-0.5B: seconds a step, peak memory, no kernel launch, the idle
     share of a profiled step, and a step-2 checkpoint restored into a new
     trainer whose third step equals the uninterrupted run's (1e-6 x
     max|p|); then python -m cosy_tpu_torch.train.full's main() on 32
     seeded parquet records (2 steps, --resume for 1); (c) the native pitch
     tracker against its numpy version on 8 clips, and two HiFiGanTrainer
     turns at HiFTConfig() on 2 clips of 24 576 samples;
 17. training scale-out at a world of one: (a) a one-member NCCL process
     group (a TCP store on 127.0.0.1 at a free port, destroyed after the
     phase) and make_mesh() on the card; two FullTrainer steps each for the
     300M LLM and the vendored FlowConfig() flow with ZeRO-2, tensor and
     sequence parallelism on phase 16 (b)'s super-batches, held to the
     trainer without a mesh on the same inputs (loss within 1e-5 relative,
     parameters within 1e-4 x max(1, max|p|)), seconds a step, idle share,
     peak and launches beside the plain trainer's; (b) JointTrainer at
     TrainConfig() over the mesh, fit SIGTERM'd from its loader after step
     2: the snapshot and its seconds, a fresh trainer resumed from it at
     the same step, and its next step equal to the uninterrupted run's
     (1e-6 x max|p|); (c) no dp, tp, seq or pp size above 1 on one card
     (NCCL takes one rank a device): the multi-rank equalities are held on
     the CPU over gloo (tests/test_torch_parallel.py);
 18. the modules of queue A16's first part at full width on seeded
     weights: (a) TTSPipeline with int8_decode on and off over one
     ModelConfig() LLM: the step view's int8 weights (84: six a block at
     14 blocks) equal to the CPU's quantization, the int8 step logits on
     the card against the CPU int8 decode (1e-4 x max(1, max|logit|)) and
     apart from the f32 decode's, tokens/s over 200 steps at B = 1 for
     both (f32, int8, int8, f32), the int8 decode's idle share under
     torch.profiler, validate_int8_voice on two prompts at a cap of 40
     tokens; (b) flow_inference_like_training at FlowConfig(): 169 tokens
     regulated to 291 frames, a 3 s prompt mel as conditioning, NFE 4, z
     injected: exactly 64 x 4 fused blocks, the mel within 2e-4 x max(1,
     max|mel|) of the CPU; (c) a conformer with the CNN module (kernel 15)
     at the 300M text encoder's widths against the CPU (2e-4 x max(1,
     max|y|)), and maximum_path at (4, 200, 1000) on the host, native
     against numpy;
 19. the exporters, the tools and the registry variants at full width on
     seeded weights: (a) export_flow_estimator_onnx at B = 2, T = 256,
     whose own check runs the graph through compat.onnx on the card against
     the estimator's kernels (exactly 64 fused blocks; the gap within 5e-3,
     printed with the file's size); (b) profiling.trace around one
     estimator call at phase 6's shape (B = 2, T = 312): the trace names
     kernels A, B1 and B2 and the annotated scope; (c) --aot-cache's build
     cache in a fresh 0700 directory: a child process that builds every
     nvcc and g++ library (misses only), a second that loads them all (hits
     only; starting a compiler fails it), each timed and each running one
     estimator call, the two outputs equal; (d) the ASR decoder and
     bi-decoder at DecoderConfig's defaults (encoder 512, vocab 4096), B = 2
     of 200 source frames and 50 target tokens, and the four conv
     subsamplings (80 -> 512) on 1000 mel frames, each within 1e-4 x max(1,
     max|y|) of the CPU; (e) 200 dynamic-chunk draws on the card at T =
     250, each a reference mask; (f) costs.estimator_call_flops of (b)'s
     call over its device busy time, as TFLOP/s beside the f32 peak named
     in ops/costs.py;
 20. serve --tp 2 at full width on phase 15's seeded model dir: two child
     processes, ranks 0 and 1 on the one card over a gloo group with CUDA
     tensors (NCCL refuses two ranks on one device), each splitting the
     LLM and the flow (TTSPipeline.shard): (a) a solo decode to 60 tokens
     against the world-one decode (equal, or the logit gap at the first
     diverging step within 1e-4 x max(1, max|logit|)); (b) a flow call at
     phase 5's shape (T = 311, NFE 15) with z injected: kernel A alone
     exactly 64 x 15 times a rank (no B1 or B2: a split block runs
     unfused), the mel within 1e-4 x max(1, max|y|) of the world-one
     unfused flow; (c) python -m cosy_tpu_torch.serve --tp 2's main() in
     both children (--engine-slots 2, --sampler meanflow on the model
     dir's flow with its time branch: 2 estimator calls a flow), rank 0
     serving over 127.0.0.1 through TTSClient (a whole request, a stream,
     a stream dropped after its first piece), then SIGTERM: both exit 0
     and rank 1 replayed every device section rank 0 sent; (d) each
     rank's weight bytes against the whole model's and the split leaves.
Phase 3 also holds B2 and the GEMM epilogue with exact (erf) GELU beside
tanh, refuses a GELU code the kernels lack, and runs A, the block, B1 and
B2 at CosyVoice2's streaming shapes with the chunk bias; phase 4 repeats
its call with gelu_approximate=False (B1 -> A -> B2-erf in every block)
against the CPU, and checks the early refusal of a tiny estimator on the
card (TTSPipeline and the infer CLI).
It prints a JSON "kernels" line (its times are the on-card ones of phase 3),
the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Without CUDA, or outside a checkout of the
repository, it exits non-zero before printing any result.
"""

import contextlib
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer
from importlib.util import find_spec
from types import SimpleNamespace

import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    sys.exit(1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from cosy_tpu_torch import ops  # noqa: E402
from cosy_tpu_torch.api import CosyVoice  # noqa: E402
from cosy_tpu_torch.client import TTSClient  # noqa: E402
from cosy_tpu_torch.config import (FLOW_LORA_DEFAULT, LLM_LORA_DEFAULT,  # noqa: E402
                                   InferenceConfig, ModelConfig, TrainConfig)
from cosy_tpu_torch.lora import init_lora, merge_lora  # noqa: E402
from cosy_tpu_torch.serve import TTSServer, make_handler, parse_voices, warmup  # noqa: E402
from cosy_tpu_torch.infer.engine import ContinuousBatchEngine  # noqa: E402
from cosy_tpu_torch.infer.pipeline import (StreamState, TTSPipeline,  # noqa: E402
                                           _batch_prefixes, stream_seed)
from cosy_tpu_torch.layers.unet import conditional_decoder  # noqa: E402
from cosy_tpu_torch.models.flow import (Flow, flow_inference,  # noqa: E402
                                        flow_inference_like_training, init_flow_params)
from cosy_tpu_torch.models.hift import init_hift_params  # noqa: E402
from cosy_tpu_torch.models import llm as TLLM  # noqa: E402
from cosy_tpu_torch.models.llm import (TransformerLM, init_llm_params,  # noqa: E402
                                       llm_teacher_forced_logits, quantize_decode_step)
from cosy_tpu_torch.layers.conformer import encoder_forward, init_encoder  # noqa: E402
from cosy_tpu_torch.ops.mas import maximum_path  # noqa: E402
from cosy_tpu_torch.export import export_flow_estimator_onnx, verify_estimator_onnx  # noqa: E402
from cosy_tpu_torch.layers.decoder import (DecoderConfig,  # noqa: E402
                                           bi_transformer_decoder_forward,
                                           init_bi_transformer_decoder,
                                           transformer_decoder_forward)
from cosy_tpu_torch.layers.subsampling import SUBSAMPLE_RATES, init_conv_subsampling  # noqa: E402
from cosy_tpu_torch.ops import costs  # noqa: E402
from cosy_tpu_torch.ops.masks import add_optional_chunk_mask  # noqa: E402
from cosy_tpu_torch.utils import profiling  # noqa: E402
from cosy_tpu_torch.quant import count_quantized, validate_int8_voice  # noqa: E402
from cosy_tpu_torch.ops import _cuda  # noqa: E402
from cosy_tpu_torch.ops.flash_attention import (_attention_plan,  # noqa: E402
                                                banded_attention, banded_attention_ref,
                                                flash_attention, flash_attention_ref)
from cosy_tpu_torch.ops.fused_block import (_TAIL_PLANS, _gemm_plan,  # noqa: E402
                                            _ln_gemm_plan, _tail_plan, block_tail, block_tail_ref,
                                            fused_transformer_block,
                                            fused_transformer_block_ref, gemm, gemm_ref,
                                            layer_norm_rows, layer_norm_rows_ref, ln_gemm,
                                            ln_gemm_ref)
from cosy_tpu_torch.ops.plan_sweep import device_ms  # noqa: E402
from cosy_tpu_torch.ops import audio  # noqa: E402
from cosy_tpu_torch.compat.onnx import OnnxModel  # noqa: E402
from cosy_tpu_torch.compat.replicas import make_campplus_replica, make_s3_replica  # noqa: E402
from cosy_tpu_torch.data.dataset import DataLoader, FlowFinetuneDataset  # noqa: E402
from cosy_tpu_torch.data.frontend import Frontend  # noqa: E402
from cosy_tpu_torch.data.prepare import main as prepare_main  # noqa: E402
from cosy_tpu_torch.params import (P, Spec, load_torch_checkpoint,  # noqa: E402
                                   save_torch_checkpoint, spec_tensors)
from cosy_tpu_torch.train.trainer import JointTrainer  # noqa: E402
from cosy_tpu_torch.train.distill import FlowDistiller, add_meanflow_time_branch  # noqa: E402
from cosy_tpu_torch.ctx import Ctx  # noqa: E402
from cosy_tpu_torch.infer.pipeline2 import (Stream2Cursor, TTS2Pipeline,  # noqa: E402
                                            hift24k_config)
from cosy_tpu_torch.layers.unet import _stream_bias  # noqa: E402
from cosy_tpu_torch.models import qwen2lm as Q  # noqa: E402
from cosy_tpu_torch.models.decode import CHUNK as DECODE_CHUNK  # noqa: E402
from cosy_tpu_torch.models.flow2 import (Flow2, Flow2Config, flow2_inference,  # noqa: E402
                                         init_flow2_params)
from cosy_tpu_torch.models.qwen2lm import (Qwen2LMConfig, init_qwen2lm_params,  # noqa: E402
                                           qwen2lm_teacher_forced_logits)

DEV = torch.device("cuda")
# H100 SXM data-sheet peaks (dense, ops/costs.py): f32 on the CUDA cores,
# bf16 on the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.float32: costs.H100_F32_FLOPS, torch.bfloat16: costs.H100_BF16_FLOPS}
PEAK_BYTES = costs.H100_HBM_BYTES_PER_S
# (atol, rtol) of each kernel against its plain version: f32 sums taken in
# another order; bf16 intermediates that round to a neighbouring value
TOL = {
    ("attention", torch.float32): (1e-5, 1e-5),
    ("attention", torch.bfloat16): (1e-2, 2e-2),
    ("block", torch.float32): (1e-4, 1e-4),
    ("block", torch.bfloat16): (5e-2, 2e-2),
    ("layer_norm", torch.float32): (1e-5, 1e-5),
    ("gemm", torch.float32): (1e-4, 1e-4),
    # both round one f32 sum to bf16; sums taken in another order can land on
    # the neighbouring bf16 value, one ulp (2^-8 relative) away
    ("gemm", torch.bfloat16): (1e-2, 1e-2),
    ("ln_gemm", torch.float32): (1e-4, 1e-4),
    ("ln_gemm", torch.bfloat16): (1e-2, 1e-2),
    ("block_tail", torch.float32): (1e-4, 1e-4),
    ("block_tail", torch.bfloat16): (1e-2, 1e-2),
}


T_START = time.time()


def log(*a):
    """Print and flush; a phase header ("[n] ...") carries the seconds
    since the script started."""
    if a and str(a[0]).startswith("["):
        a = (f"{a[0]} (at {time.time() - T_START:.1f} s)",) + a[1:]
    print(*a, flush=True)


def cuda_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes, dtype):
    """Least time (ms) the card could take: operations over the peak of the
    type, or bytes over the memory rate, whichever is larger."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def tf32x3_ms(flops, dtype):
    """The f32 kernels' own floor: three TF32 passes at the tensor cores'
    TF32 peak (None for bf16)."""
    return 3 * flops / costs.H100_TF32_FLOPS * 1e3 if dtype == torch.float32 else None


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def compare(kind, got, want, dtype):
    atol, rtol = TOL[(kind, dtype)]
    err = (got.float() - want.float()).abs().max().item()
    ok = bool(torch.isfinite(got).all()) and torch.allclose(got.float(), want.float(),
                                                            atol=atol, rtol=rtol)
    tol = f"tol atol={atol:g} rtol={rtol:g}"
    if dtype == torch.bfloat16:
        # the error in bf16 ulps at the output's scale, 2^(e - 7) for
        # max|want| in [2^e, 2^(e+1))
        ulp = 2.0 ** (np.floor(np.log2(max(want.float().abs().max().item(), 2 ** -126))) - 7)
        tol += f"; {err / ulp:.2f} ulp of max|y|"
    return err, ok, tol


# ---------------------------------------------------------------------------
# kernel A: flash attention
# ---------------------------------------------------------------------------


def attention_case(g, B, H, T, S, dtype, masked=True, iters=20, pad_from=None, bias_t=None):
    """``masked``: a padding bias, a fully masked row and a short k_valid;
    else ``pad_from``: the estimator's bias of a masked mel (keys from
    ``pad_from`` on at -1e10 in every row), else ``bias_t`` (a given
    (B, T, S) bias, such as the streaming chunk bias), or no bias at all."""
    q = torch.randn(B, H, T, 64, device=DEV, generator=g).to(dtype)
    k = torch.randn(B, H, S, 64, device=DEV, generator=g).to(dtype)
    v = torch.randn(B, H, S, 64, device=DEV, generator=g).to(dtype)
    bias = torch.zeros(B, T, S, device=DEV)
    kv = None
    if masked:
        bias[-1, :, S - S // 10:] = -1e10  # right padding
        bias[0, min(3, T - 1), :] = -1e10  # one fully masked row
        kv = torch.tensor([S] * (B - 1) + [S - 17], dtype=torch.int32, device=DEV)
    elif pad_from is not None:
        bias[:, :, pad_from:] = -1e10
    else:
        bias = bias_t
    bias = None if bias is None else bias.to(dtype)
    scale = 64 ** -0.5
    got = flash_attention(q, k, v, bias, scale, kv)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, bias, scale, kv)
    err, ok, tol = compare("attention", got, want, dtype)
    mask = bias  # the library call gets the k_valid cut folded into its mask
    if kv is not None:
        mask = bias.masked_fill(torch.arange(S, device=DEV)[None, None, :]
                                >= kv[:, None, None], -1e10)
    mask = None if mask is None else mask[:, None]
    ms = cuda_ms(lambda: flash_attention(q, k, v, bias, scale, kv), iters)
    plain = cuda_ms(lambda: flash_attention_ref(q, k, v, bias, scale, kv), max(2, iters // 4))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale),
                  iters)
    bms, by = bound(4 * B * H * T * S * 64, nbytes(q, k, v, got, bias, kv), dtype)
    return dict(err=err, ok=ok, tol=tol, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by, tf32x3_ms=tf32x3_ms(4 * B * H * T * S * 64, dtype),
                dev_ms=device_ms(lambda: flash_attention(q, k, v, bias, scale, kv)),
                plain_dev_ms=device_ms(lambda: flash_attention_ref(q, k, v, bias, scale, kv), 3),
                lib_dev_ms=device_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale)))


def attention_views_case(g, B, H, T, dtype, iters=20):
    """Kernel A on the fused block's strided views: q, k, v the heads of a
    (B, T, 3, H, d) product, out a (B, H, T, d) view of a (B, T, H, d)
    tensor, with the estimator's bias of a masked mel (the last key at
    -1e10), against ``flash_attention_ref`` on the same views."""
    qkv = torch.randn(B, T, 3, H, 64, device=DEV, generator=g).to(dtype)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    bias = torch.zeros(B, T, T, device=DEV)
    bias[:, :, T - 1:] = -1e10
    bias = bias.to(dtype)
    o = torch.full((B, T, H, 64), float("nan"), device=DEV, dtype=dtype)
    view = o.permute(0, 2, 1, 3)
    scale = 64 ** -0.5
    flash_attention(q, k, v, bias, scale, out=view)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, bias, scale)
    err, ok, tol = compare("attention", view, want, dtype)

    def run():
        flash_attention(q, k, v, bias, scale, out=view)

    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias[:, None],
                                                         scale=scale), iters)
    bms, by = bound(4 * B * H * T * T * 64, nbytes(qkv, o, bias), dtype)
    return dict(err=err, ok=ok, tol=tol, ms=cuda_ms(run, iters),
                plain_ms=cuda_ms(lambda: flash_attention_ref(q, k, v, bias, scale), 5),
                library_ms=lib, bound_ms=bms, bound_by=by,
                tf32x3_ms=tf32x3_ms(4 * B * H * T * T * 64, dtype), dev_ms=device_ms(run),
                lib_dev_ms=device_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=bias[:, None], scale=scale)))


# ---------------------------------------------------------------------------
# kernel C: banded attention
# ---------------------------------------------------------------------------


def banded_case(g, B, H, T, window, dtype, kv=None, iters=10):
    """Kernel C against its plain version on the rows t < k_valid[b] (the
    others have no defined value), with the plain version, SDPA under the
    band as a boolean mask, and kernel A under the band as a bias timed on
    the same inputs.  The bound counts the admitted (t, s) pairs of this
    call's band and k_valid."""
    q, k, v = (torch.randn(B, H, T, 64, device=DEV, generator=g).to(dtype) for _ in range(3))
    k_valid = None if kv is None else torch.tensor(kv, dtype=torch.int32, device=DEV)
    scale = 64 ** -0.5
    got = banded_attention(q, k, v, scale, window, k_valid)
    torch.cuda.synchronize()
    want = banded_attention_ref(q, k, v, scale, window, k_valid)
    pos = torch.arange(T, device=DEV)
    ok = ((pos[:, None] - pos[None, :]).abs() <= window)[None].expand(B, T, T)
    if k_valid is not None:
        rows = (pos[None, :] < k_valid[:, None])[:, None, :, None]
        got_c, want_c = got * rows, want * rows
        ok = ok & (pos[None, None, :] < k_valid[:, None, None])
    else:
        got_c, want_c = got, want
    err, good, tol = compare("attention", got_c, want_c, dtype)
    good = good and bool(torch.isfinite(got).all())
    pairs = int(ok.sum().item())
    bias = torch.where(ok, 0.0, -1e10).to(dtype).contiguous()
    ms = cuda_ms(lambda: banded_attention(q, k, v, scale, window, k_valid), iters)
    plain = cuda_ms(lambda: banded_attention_ref(q, k, v, scale, window, k_valid),
                    max(2, iters // 4))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=ok[:, None],
                                                         scale=scale), iters)
    a_ms = cuda_ms(lambda: flash_attention(q, k, v, bias, scale), iters)
    bms, by = bound(4 * H * pairs * 64, nbytes(q, k, v, got, k_valid), dtype)
    return dict(err=err, ok=good, tol=tol, ms=ms, plain_ms=plain, library_ms=lib,
                kernel_a_ms=a_ms, bound_ms=bms, bound_by=by,
                tf32x3_ms=tf32x3_ms(4 * H * pairs * 64, dtype),
                dev_ms=device_ms(lambda: banded_attention(q, k, v, scale, window, k_valid)),
                plain_dev_ms=device_ms(
                    lambda: banded_attention_ref(q, k, v, scale, window, k_valid), 3),
                lib_dev_ms=device_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=ok[:, None], scale=scale)))


# ---------------------------------------------------------------------------
# kernel B: the transformer block chain (and its LayerNorm and GEMM kernels)
# ---------------------------------------------------------------------------


def block_weights(g, dtype, C=256, inner=512, ff=1024):
    def mk(*s, scale=0.05, one=False):
        w = torch.randn(*s, device=DEV, generator=g) * scale
        return (w + 1.0 if one else w).to(dtype)

    return [mk(C, one=True), mk(C), mk(inner, C), mk(inner, C), mk(inner, C), mk(C, inner),
            mk(C), mk(C, one=True), mk(C), mk(ff, C), mk(ff), mk(C, ff), mk(C)]


def library_block(x, bias, W, heads, gelu="tanh"):
    """The block as a sequence of PyTorch library calls (layer_norm, linear,
    scaled_dot_product_attention, gelu): a yardstick only.  No single
    PyTorch call computes it (nn.TransformerEncoderLayer needs the attention
    width to equal the model width; here it is 512 against 256), so the
    kernels line reports library_ms null for the block."""
    B, T, C = x.shape
    n1w, n1b, wq, wk, wv, wo, bo, n3w, n3b, w1, b1, w2, b2 = W
    wqkv = torch.cat([wq, wk, wv])
    d = wq.shape[0] // heads
    mask = None if bias is None else bias[:, None]

    def run():
        h = F.layer_norm(x, (C,), n1w, n1b, 1e-5)
        q, k, v = F.linear(h, wqkv).view(B, T, 3, heads, d).permute(2, 0, 3, 1, 4)
        a = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        x1 = x + F.linear(a.transpose(1, 2).reshape(B, T, heads * d), wo, bo)
        f = F.gelu(F.linear(F.layer_norm(x1, (C,), n3w, n3b, 1e-5), w1, b1),
                   approximate="tanh" if gelu == "tanh" else "none")
        return x1 + F.linear(f, w2, b2)

    return run


def seven_launch_block(x, bias, W, heads, scale):
    """The block as the seven-launch chain of the port's kept LayerNorm and
    GEMM kernels with kernel A between them (the block's path before B1 and
    B2 existed): a yardstick of the same arithmetic in more launches."""
    B, T, C = x.shape
    n1w, n1b, wq, wk, wv, wo, bo, n3w, n3b, w1, b1, w2, b2 = W
    inner, cd = wq.shape[0], x.dtype
    d = inner // heads

    def run():
        x2 = x.reshape(B * T, C)
        qkv = gemm(layer_norm_rows(x2, n1w, n1b, cd), (wq, wk, wv)).view(B, T, 3, heads, d)
        q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        a = torch.empty((B, T, heads, d), dtype=cd, device=x.device)
        flash_attention(q, k, v, bias, scale, out=a.permute(0, 2, 1, 3))
        x1 = gemm(a.reshape(B * T, inner), (wo,), bias=bo, residual=x2, out_dtype=torch.float32)
        f = gemm(layer_norm_rows(x1, n3w, n3b, cd), (w1,), bias=b1, gelu="tanh")
        return gemm(f, (w2,), bias=b2, residual=x1, out_dtype=cd).view(B, T, C)

    return run


def block_case(g, B, T, dtype, with_bias, iters=20, heads=8, pad_from=None, bias_t=None,
               gelu_approximate=True):
    """The block (B1 -> A -> B2) against its plain version; ``bias_t`` a
    given (B, T, T) bias, ``gelu_approximate`` False the erf GELU."""
    W = block_weights(g, dtype)
    C, inner, ff = 256, 512, 1024
    x = torch.randn(B, T, C, device=DEV, generator=g).to(dtype)
    bias = None if bias_t is None else bias_t.to(dtype)
    ga = gelu_approximate
    if with_bias and bias_t is None:
        bias = torch.zeros(B, T, T, device=DEV)
        if pad_from is None:
            bias[-1, :, T - T // 10:] = -1e10
        else:
            bias[:, :, pad_from:] = -1e10
        bias = bias.to(dtype)
    scale = (inner // heads) ** -0.5

    def run():
        return fused_transformer_block(x, bias, *W, heads=heads, scale=scale, gelu_approximate=ga)

    def run_ref():
        return fused_transformer_block_ref(x, bias, *W, heads=heads, scale=scale,
                                           gelu_approximate=ga)

    got = run()
    torch.cuda.synchronize()
    want = run_ref()
    err, ok, tol = compare("block", got, want, dtype)
    ms = cuda_ms(run, iters)
    plain = cuda_ms(run_ref, max(2, iters // 4))
    lib_block = library_block(x, bias, W, heads, "tanh" if ga else "erf")
    unfused = cuda_ms(lib_block, iters)
    chain7 = seven_launch_block(x, bias, W, heads, scale)
    err7 = (chain7().float() - want.float()).abs().max().item()
    flops = 2 * B * T * (3 * C * inner + inner * C + 2 * C * ff) + 4 * B * heads * T * T * (inner // heads)
    bms, by = bound(flops, nbytes(x, got, bias, *W), dtype)
    return dict(err=err, ok=ok, tol=tol, ms=ms, plain_ms=plain, library_ms=None,
                unfused_ms=unfused, bound_ms=bms, bound_by=by,
                chain7_ms=cuda_ms(chain7, iters), chain7_dev_ms=device_ms(chain7),
                chain7_err=err7, dev_ms=device_ms(run), plain_dev_ms=device_ms(run_ref, 3),
                lib_dev_ms=device_ms(lib_block))


def layer_norm_case(g, rows, C=256, iters=50):
    dtype = torch.float32
    x = torch.randn(rows, C, device=DEV, generator=g)
    w, b = torch.randn(C, device=DEV, generator=g), torch.randn(C, device=DEV, generator=g)
    got = layer_norm_rows(x, w, b, dtype)
    torch.cuda.synchronize()
    err, ok, tol = compare("layer_norm", got, layer_norm_rows_ref(x, w, b, dtype), dtype)
    ms = cuda_ms(lambda: layer_norm_rows(x, w, b, dtype), iters)
    plain = cuda_ms(lambda: layer_norm_rows_ref(x, w, b, dtype), iters)
    lib = cuda_ms(lambda: F.layer_norm(x, (C,), w, b, 1e-5), iters)
    bms, by = bound(8 * rows * C, nbytes(x, w, b, got), dtype)
    return dict(err=err, ok=ok, tol=tol, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by,
                dev_ms=device_ms(lambda: layer_norm_rows(x, w, b, dtype)),
                plain_dev_ms=device_ms(lambda: layer_norm_rows_ref(x, w, b, dtype), 3),
                lib_dev_ms=device_ms(lambda: F.layer_norm(x, (C,), w, b, 1e-5)))


def gemm_case(g, M, K, seg, nseg=1, bias=False, gelu=None, residual=False, iters=50,
              dtype=torch.float32):
    """One of the block's products with its epilogue: ``nseg`` (seg, K)
    weight segments read in place (3 for the QKV product), optional bias,
    tanh GELU and f32 residual, as the block's four launches use them."""
    N = nseg * seg
    a = torch.randn(M, K, device=DEV, generator=g).to(dtype)
    ws = [(torch.randn(seg, K, device=DEV, generator=g) * 0.05).to(dtype) for _ in range(nseg)]
    w_cat = torch.cat(ws)
    b = (torch.randn(N, device=DEV, generator=g) * 0.05).to(dtype) if bias else None
    r = torch.randn(M, N, device=DEV, generator=g) if residual else None

    def run():
        return gemm(a, ws, b, r, gelu=gelu)

    def run_ref():
        return gemm_ref(a, ws, b, r, gelu=gelu)

    def run_lib():
        y = F.linear(a, w_cat, b)
        y = F.gelu(y, approximate="tanh" if gelu == "tanh" else "none") if gelu else y
        return (y + r).to(dtype) if residual else y

    got = run()
    torch.cuda.synchronize()
    err, ok, tol = compare("gemm", got, run_ref(), dtype)
    ms = cuda_ms(run, iters)
    plain = cuda_ms(run_ref, iters)
    lib = cuda_ms(run_lib, iters)
    bms, by = bound(2 * M * N * K, nbytes(a, w_cat, b, r, got), dtype)
    return dict(err=err, ok=ok, tol=tol, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by, plan=_gemm_plan(M, N, K, dtype),
                dev_ms=device_ms(run), plain_dev_ms=device_ms(run_ref, 3),
                lib_dev_ms=device_ms(run_lib))


def ln_gemm_x(g, M, C, dtype):
    """B1's x: every fifth row at |mean| / std = 24 and every eleventh with
    50 std added to its column 0 (a variance that cancels, or statistics
    shifted by one of the row's values, would show)."""
    x = torch.randn(M, C, device=DEV, generator=g)
    x[::5] = x[::5] * 0.5 + 12.0
    x[3::11, 0] += 50.0
    return x.to(dtype)


def ln_gemm_case(g, M, dtype, iters=20, C=256, inner=512, x_dtype=None):
    """Kernel B1 on the block's QKV product: LN1 of x (M, C, ``ln_gemm_x``)
    and the three (inner, C) segments read in place, against ln_gemm_ref.
    ``x_dtype`` f32 under bf16 weights takes x as it is and rounds h.  The
    library yardstick is F.layer_norm then one F.linear (two calls: no
    single PyTorch call computes it)."""
    x = ln_gemm_x(g, M, C, x_dtype or dtype)
    w = (torch.randn(C, device=DEV, generator=g) * 0.05 + 1.0).to(dtype)
    b = (torch.randn(C, device=DEV, generator=g) * 0.05).to(dtype)
    ws = [(torch.randn(inner, C, device=DEV, generator=g) * 0.05).to(dtype) for _ in range(3)]
    w_cat = torch.cat(ws)
    plan = _ln_gemm_plan(M, 3 * inner, C, dtype)

    def run():
        return ln_gemm(x, w, b, ws)

    def run_ref():
        return ln_gemm_ref(x, w, b, ws)

    def run_lib():
        return F.linear(F.layer_norm(x, (C,), w.to(x.dtype), b.to(x.dtype), 1e-5).to(dtype), w_cat)

    got = run()
    torch.cuda.synchronize()
    err, ok, tol = compare("ln_gemm", got, run_ref(), dtype)
    bms, by = bound(2 * M * 3 * inner * C + 8 * M * C, nbytes(x, w, b, w_cat, got), dtype)
    return dict(err=err, ok=ok, tol=tol, ms=cuda_ms(run, iters), plain_ms=cuda_ms(run_ref, iters),
                library_ms=None, unfused_ms=cuda_ms(run_lib, iters), bound_ms=bms, bound_by=by,
                plan=plan, dev_ms=device_ms(run), plain_dev_ms=device_ms(run_ref, 3),
                lib_dev_ms=device_ms(run_lib), same=torch.equal(run(), run()))


def ln_gemm_ragged(g):
    """B1 off the main path's shapes, as ``ln_gemm`` accepts them: K of 64,
    128 and 192, one to three segments whose rows end inside a tile, 77
    rows (a ragged row tile), an f32 y under bf16 weights; each against
    ln_gemm_ref in both dtypes."""
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for K, seg, nseg in ((64, 24, 3), (128, 100, 2), (192, 36, 1)):
            x = ln_gemm_x(g, 77, K, dtype)
            w = (torch.randn(K, device=DEV, generator=g) * 0.05 + 1.0).to(dtype)
            b = (torch.randn(K, device=DEV, generator=g) * 0.05).to(dtype)
            ws = [(torch.randn(seg, K, device=DEV, generator=g) * 0.05).to(dtype)
                  for _ in range(nseg)]
            err, ok, tol = compare("ln_gemm", ln_gemm(x, w, b, ws, torch.float32),
                                   ln_gemm_ref(x, w, b, ws, torch.float32), dtype)
            if not ok:
                raise SystemExit(f"chip_smoke: B1 at K = {K}, {nseg} x {seg} rows, {dtype} "
                                 f"disagrees with ln_gemm_ref: max_abs_err {err:.3e} ({tol})")
            worst[str(dtype)[6:]] = max(worst.get(str(dtype)[6:], 0.0), err)
    log("  B1 ragged (77 rows; K 64 / 128 / 192 with 3 x 24, 2 x 100, 1 x 36 weight rows; "
        "y f32): ok, worst max_abs_err " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))


def tail_x(g, M, C, dtype):
    """B2's x: every fifth row shifted to a mean of 12 and every seventh to
    -20, so that their x1 lies at |mean| / std ~10-30, and every eleventh
    with 40 added to column 7 (a cancelling LN3 would show)."""
    x = torch.randn(M, C, device=DEV, generator=g)
    x[::5] = x[::5] * 0.5 + 12.0
    x[1::7] = x[1::7] * 0.4 - 20.0
    x[3::11, 7] += 40.0
    return x.to(dtype)


TAIL_PLANS_RUN = set()  # the B2 plans tail_case held against block_tail_ref


def tail_case(g, M, dtype, iters=20, C=256, inner=512, ff=1024, gelu="tanh"):
    """Kernel B2 on the block's shapes against block_tail_ref with the
    plan's ranks and the same GELU ("tanh" or "erf"), x from ``tail_x``;
    the library yardstick is the unfused sequence F.linear, add,
    F.layer_norm, F.linear, F.gelu, F.linear, add."""
    def mk(*shape, scale=0.05, one=False):
        t = torch.randn(*shape, device=DEV, generator=g) * scale
        return (t + 1.0 if one else t).to(dtype)

    a, x = mk(M, inner, scale=1.0), tail_x(g, M, C, dtype)
    W = (mk(C, inner), mk(C), mk(C, one=True), mk(C), mk(ff, C), mk(ff), mk(C, ff), mk(C))
    wo, bo, n3w, n3b, w1, b1, w2, b2 = W
    plan = _tail_plan(M, C, inner, ff, dtype)
    TAIL_PLANS_RUN.add(plan)

    def run():
        return block_tail(a, x, *W, gelu=gelu)

    def run_ref():
        return block_tail_ref(a, x, *W, gelu=gelu, ranks=plan[1])

    def run_lib():
        x1 = x.float() + F.linear(a, wo, bo)
        f = F.gelu(F.linear(F.layer_norm(x1.to(dtype), (C,), n3w, n3b, 1e-5), w1, b1),
                   approximate="tanh" if gelu == "tanh" else "none")
        return (x1 + F.linear(f, w2, b2)).to(dtype)

    got = run()
    torch.cuda.synchronize()
    err, ok, tol = compare("block_tail", got, run_ref(), dtype)
    bms, by = bound(2 * M * (C * inner + 2 * C * ff), nbytes(a, x, *W, got), dtype)
    return dict(err=err, ok=ok, tol=tol, ms=cuda_ms(run, iters), plain_ms=cuda_ms(run_ref, iters),
                library_ms=None, unfused_ms=cuda_ms(run_lib, iters), bound_ms=bms, bound_by=by,
                plan=plan, dev_ms=device_ms(run), plain_dev_ms=device_ms(run_ref, 3),
                lib_dev_ms=device_ms(run_lib), same=torch.equal(run(), run()))


def attention_splits(g):
    """Kernels A and C unsplit and over a cluster of 2 against their plain
    versions, in both types, where the path's plans would not split.  S =
    310 leaves bias rows off a 16-byte boundary: the producer's lanes copy
    the bias."""
    scale = 64 ** -0.5
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(2, 8, 310, 64, device=DEV, generator=g).to(dtype)
                   for _ in range(3))
        bias = torch.zeros(2, 310, 310, device=DEV)
        bias[1, :, 290:] = -1e10
        bias = bias.to(dtype)
        kv = torch.tensor([310, 300], dtype=torch.int32, device=DEV)
        want_a = flash_attention_ref(q, k, v, bias, scale, kv)
        want_c = banded_attention_ref(q, k, v, scale, 40, kv)
        rows = (torch.arange(310, device=DEV)[None, :] < kv[:, None])[:, None, :, None]
        strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                           *q.stride()[:3])
        code = _cuda.DTYPE_CODE[dtype]
        for splits in (1, 2):
            got_a, got_c = torch.empty_like(q), torch.empty_like(q)
            _cuda.check(_cuda.function("cosy_flash_attention")(
                code, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                kv.data_ptr(), got_a.data_ptr(), 2, 8, 310, 310, 64, strides, scale, splits,
                _cuda.stream_ptr(q)), "flash_attention")
            _cuda.check(_cuda.function("cosy_banded_attention")(
                code, q.data_ptr(), k.data_ptr(), v.data_ptr(), kv.data_ptr(),
                got_c.data_ptr(), 2, 8, 310, 64, strides, scale, 40, splits,
                _cuda.stream_ptr(q)), "banded_attention")
            torch.cuda.synchronize()
            ea, oka, _ = compare("attention", got_a, want_a, dtype)
            ec, okc, _ = compare("attention", got_c * rows, want_c * rows, dtype)
            log(f"  splits {splits} {str(dtype)[6:]}: A (2,8,310,64) + bias, "
                f"k_valid max_abs_err {ea:.3e}; C window 40 {ec:.3e}")
            if not (oka and okc):
                raise SystemExit(f"chip_smoke: A or C over {splits} splits disagrees with "
                                 "its plain version")


def same_twice(g):
    """The plans that split (K of a product over a cluster, the keys of an
    attention call over a cluster) sum in a fixed order: two calls on the
    same inputs must return the same bits."""
    a = torch.randn(312, 1024, device=DEV, generator=g)
    w = [torch.randn(256, 1024, device=DEV, generator=g) * 0.05]
    r = torch.randn(312, 256, device=DEV, generator=g)
    q = torch.randn(2, 8, 128, 64, device=DEV, generator=g)
    k, v = (torch.randn(2, 8, 8320, 64, device=DEV, generator=g) for _ in range(2))
    gp, ap = _gemm_plan(312, 256, 1024, torch.float32), _attention_plan(16, 128, 8320)
    if gp[2] < 2 or ap < 2:
        raise SystemExit(f"chip_smoke: the plans {gp}, {ap} do not split where they should")
    same_g = torch.equal(gemm(a, w, None, r), gemm(a, w, None, r))
    same_a = torch.equal(flash_attention(q, k, v, None, 0.125), flash_attention(q, k, v, None, 0.125))
    log(f"  two calls, same bits: gemm (312,1024)x(256,1024) plan {gp} {same_g}; "
        f"flash_attention (2,8,128,64) S=8320 plan {ap} {same_a}")
    if not (same_g and same_a):
        raise SystemExit("chip_smoke: a split plan's result changed from one call to the next")


def profile_device(fn):
    """Run ``fn`` once under torch.profiler.  Returns (wall ms on the host
    clock around the call and a synchronize, device busy ms as the union of
    the kernels' time ranges, {kernel name: (launches, device ms)}); busy is
    None when the profiler recorded no device events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return wall_ms, None, {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + cur_e - cur_s) / 1e3  # us -> ms
    by_name = {}
    for e in kernels:
        n, tot = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, tot + (e.time_range.end - e.time_range.start) / 1e3)
    return wall_ms, busy, by_name


def log_profile(wall_ms, plain_wall_ms, busy, by_name, top=10):
    if busy is None:
        log(f"  wall {wall_ms:.3f} ms; the profiler recorded no device events")
        return
    log(f"  wall {wall_ms:.3f} ms profiled ({plain_wall_ms:.3f} ms without the profiler), "
        f"device busy {busy:.3f} ms, idle share {1 - busy / plain_wall_ms:.3f} of the "
        f"unprofiled wall, {sum(n for n, _ in by_name.values())} kernel launches")
    for n, (cnt, tot) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"  {tot:9.3f} ms {100 * tot / busy:5.1f}% x{cnt:<5d} {n[:90]}")


def estimator_args(T, masked, seed=7):
    """Inputs of one estimator call at CFG batch 2; ``masked`` marks the
    last frame as padding (mask and (B, T, T) bias, as an odd mel length)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    x, mu, cond = (torch.randn(2, 80, T, device=DEV, generator=gen) for _ in range(3))
    mask = None
    if masked:
        mask = torch.ones(2, 1, T, device=DEV)
        mask[:, :, T - 1:] = 0.0
    return (x, mask, mu, torch.rand(2, device=DEV, generator=gen),
            torch.randn(2, 80, device=DEV, generator=gen), cond)


def where_time_goes(est, ecfg, T, masked=True):
    """Device busy share and device time by kernel for one estimator call
    (B=2, T frames), from torch.profiler's CUDA events; wall time on the
    host clock around the call."""
    args = estimator_args(T, masked)
    with torch.inference_mode():
        conditional_decoder(est, ecfg, *args)
        wall_ms, busy, by_name = profile_device(lambda: conditional_decoder(est, ecfg, *args))
        plain_wall = cuda_ms(lambda: conditional_decoder(est, ecfg, *args), 3)
    log_profile(wall_ms, plain_wall, busy, by_name)


def windowed_synthesis(cfg, llm, flow, hift, n_tokens=1485, window=256):
    """Phase 7.  Returns the launch counts of the windowed run."""
    log(f"[7] windowed long-utterance synthesis: {n_tokens} seeded speech tokens through "
        f"TTSPipeline.token2wav, attn_window = {window} against full attention")
    T_mel = int(n_tokens / cfg.flow.input_frame_rate * 22050 / 256)
    nfe = 20
    if T_mel % 2 or T_mel <= 500:
        raise SystemExit(f"chip_smoke: {T_mel} mel frames would pad (mask, no window) or cut NFE")
    est_w = dataclasses.replace(cfg.flow.estimator, attn_window=window)
    cfg_w = dataclasses.replace(cfg, flow=dataclasses.replace(cfg.flow, estimator=est_w))
    tokens = np.random.default_rng(8).integers(0, cfg.flow.vocab_size, (1, n_tokens))
    spk = np.random.default_rng(9).standard_normal((1, cfg.flow.spk_embed_dim)).astype(np.float32)
    out = {}
    for name, c in (("windowed", cfg_w), ("full", cfg)):
        pipe = TTSPipeline(c, llm, flow, hift, finetuned_norm=True)
        ops.reset_launch_counts()
        with torch.inference_mode():
            wav = pipe.token2wav(tokens, spk, generator=torch.Generator(device=DEV).manual_seed(10))
        out[name] = (ops.launch_counts(), dict(pipe.stage_seconds), wav)
        log(f"  {name}: stages (s) " + ", ".join(f"{k} {v:.3f}" for k, v in pipe.stage_seconds.items())
            + f"; waveform {wav.shape}, finite {bool(np.isfinite(wav).all())}; "
            f"launches {out[name][0]}")
        if wav.shape != (1, 256 * T_mel) or not np.isfinite(wav).all():
            raise SystemExit(f"chip_smoke: {name} synthesis output has the wrong shape or is not finite")
    cw, cf = out["windowed"][0], out["full"][0]
    if cw["banded_attention"] != 64 * nfe or cw["fused_transformer_block"] != 0 \
            or cw["flash_attention"] != 0 or cw["ln_gemm"] != 0 or cw["block_tail"] != 0:
        raise SystemExit(f"chip_smoke: windowed launch counts {cw} off 64 x NFE {nfe} of kernel C")
    if cf["fused_transformer_block"] != 64 * nfe or cf["ln_gemm"] != 64 * nfe \
            or cf["block_tail"] != 64 * nfe or cf["banded_attention"] != 0:
        raise SystemExit(f"chip_smoke: full-attention launch counts {cf} off 64 x NFE {nfe}")
    # the two mels from one initial noise
    z = torch.randn((1, 80, T_mel), device=DEV, generator=torch.Generator(device=DEV).manual_seed(10))
    tok = torch.as_tensor(tokens, dtype=torch.long, device=DEV)
    none_tok = torch.zeros((1, 0), dtype=torch.long, device=DEV)
    none_feat = torch.zeros((1, 0, 80), device=DEV)
    with torch.inference_mode():
        mels = [flow_inference(P(dict(flow.named_parameters())), c.flow, tok, none_tok, none_feat,
                               torch.as_tensor(spk, device=DEV), n_timesteps=nfe,
                               finetuned_norm=True, z=z) for c in (cfg_w, cfg)]
    rel = ((mels[0] - mels[1]).norm() / mels[1].norm()).item()
    fw, ff = out["windowed"][1]["flow"], out["full"][1]["flow"]
    log(f"  flow stage: windowed {fw:.3f} s, full {ff:.3f} s ({ff / fw:.2f}x); relative mel "
        f"difference ||windowed - full|| / ||full|| = {rel:.4f} ({T_mel} frames, NFE {nfe}, "
        f"random seeded weights)")
    if not (np.isfinite(rel) and 0.0 < rel < 1.0):
        raise SystemExit("chip_smoke: the windowed mel equals the full one or is far from it")
    est = P(dict(flow.named_parameters())).sub("decoder.estimator")
    log(f"  one estimator call (B=2, no mask), window {window} against full attention: wall ms "
        "(CUDA events, 3 calls) and device busy ms (torch.profiler, 1 call)")
    with torch.inference_mode():
        for T in (512, 768, 1024, 1280, 1536, 2048, 2558):
            args = estimator_args(T, masked=False)
            row = []
            for ecfg in (est_w, cfg.flow.estimator):
                call = lambda: conditional_decoder(est, ecfg, *args)  # noqa: E731
                row += [cuda_ms(call, 3), profile_device(call)[1]]
            log(f"    T={T:<5d} windowed {row[0]:7.2f} wall {row[1]:7.2f} busy | full "
                f"{row[2]:7.2f} wall {row[3]:7.2f} busy | full / windowed {row[2] / row[0]:.2f}x "
                f"wall {row[3] / row[1]:.2f}x busy")
    log(f"  where the windowed call's time goes (B=2, T={T_mel}, window {window}), torch.profiler")
    where_time_goes(est, est_w, T_mel, masked=False)
    return cw


def training_steps(cfg, llm, flow, hift, steps=3):
    """Phase 8."""
    # the defaults but for the warm-up: with 50 warm-up steps the first
    # three learning rates are 0, 4e-6 and 8e-6, too small to show a falling
    # loss in 3 steps
    tcfg = TrainConfig(warmup_steps=0)
    accum, B, T = tcfg.accumulate_grad_batches, tcfg.batch_size, tcfg.max_feat_len
    n_tok, n_text = tcfg.max_token_len, 30
    log(f"[8] joint LoRA training, full width, bf16 {tcfg.bf16}: {steps} steps on one seeded "
        f"super-batch (accumulation {accum} x batch {B}, {T} mel frames, {n_tok} speech "
        f"tokens, {n_text} text tokens), lr {tcfg.learning_rate:g} without warm-up")
    rng = np.random.default_rng(12)
    sb = {
        "text_token": rng.integers(0, cfg.llm.text_token_size, (accum, B, n_text)).astype(np.int32),
        "text_token_len": np.full((accum, B), n_text, np.int32),
        "speech_token": rng.integers(0, cfg.llm.speech_token_size, (accum, B, n_tok)).astype(np.int32),
        "speech_token_len": np.full((accum, B), n_tok, np.int32),
        "speech_feat": (rng.standard_normal((accum, B, T, 80)) * 2 - 6).astype(np.float32),
        "speech_feat_len": np.full((accum, B), T, np.int32),
        "embedding": rng.standard_normal((accum, B, 192)).astype(np.float32),
    }
    base = {n: {k: v.clone() for k, v in m.state_dict().items()}
            for n, m in (("llm", llm), ("flow", flow))}
    counts0 = ops.launch_counts()

    def run(mode, n):
        with tempfile.TemporaryDirectory() as tmp:
            tr = JointTrainer(cfg, dataclasses.replace(tcfg, training_mode=mode), llm, flow,
                              out_dir=tmp, total_steps=1000)
            state = tr.init_state(torch.Generator(device=DEV).manual_seed(13))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            hist, secs = [], []
            for _ in range(n):
                t0 = time.perf_counter()
                m = tr.step(state, sb, torch.Generator(device=DEV).manual_seed(14))
                hist.append({k: float(v) for k, v in m.items()})  # waits for the device
                secs.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            merged = None
            if mode == "joint":
                tr.export_merged(state, save=True)
                merged = {n: load_torch_checkpoint(os.path.join(tmp, f"{n}_merged_joint.pt"))
                          for n in ("llm", "flow")}
                with open(os.path.join(tmp, "flow_merged_joint.pt.meta.json")) as f:
                    if json.load(f)["mel_space"] != "normalized":
                        raise SystemExit("chip_smoke: merged flow weights lack their mel-space note")
        return hist, secs, peak, merged, sum(v.numel() for d in state.loras.values() for v in d.values())

    hist, secs, peak, merged, n_lora = run("joint", steps)
    for i, m in enumerate(hist):
        log(f"  step {i + 1}: " + " ".join(f"{k}={v:.5f}" for k, v in sorted(m.items()))
            + f" ({secs[i]:.3f} s)")
    log(f"  {n_lora / 1e6:.2f} M adapter params; seconds per step after the first: "
        f"{np.mean(secs[1:]):.3f}; peak device memory {peak:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    if not all(np.isfinite(v) for m in hist for v in m.values()):
        raise SystemExit("chip_smoke: a training metric is not finite")
    if not hist[0]["grad_norm"] > 0:
        raise SystemExit("chip_smoke: no gradient reached the adapters")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise SystemExit(f"chip_smoke: the loss did not fall on the repeated batch: "
                         f"{[m['loss'] for m in hist]}")
    for n, m in (("llm", llm), ("flow", flow)):
        if not all(torch.equal(v, base[n][k]) for k, v in m.state_dict().items()):
            raise SystemExit(f"chip_smoke: training changed the {n} base weights")
    if ops.launch_counts() != counts0:
        raise SystemExit(f"chip_smoke: training launched a kernel: {counts0} -> {ops.launch_counts()}")
    log(f"  base weights bit-identical; kernel launch counts unchanged: {counts0}")
    del base

    # the merge changed the weights; phase 11 loads the CLI's merged weights
    # into TTSPipeline and synthesizes from them
    base_flow = flow.state_dict()
    moved = sum(int(not torch.equal(v, base_flow[k].cpu())) for k, v in merged["flow"].items())
    log(f"  the merge changed {moved} flow tensors")
    if moved == 0:
        raise SystemExit("chip_smoke: the merge did not change the weights")
    del merged
    torch.cuda.empty_cache()

    for mode in ("llm_only", "flow_only"):
        h, sec, pk, _, _ = run(mode, 2)
        log(f"  {mode}: loss {h[0]['loss']:.5f} -> {h[1]['loss']:.5f}, second step {sec[1]:.3f} s, "
            f"peak {pk:.2f} GiB")
        if not all(np.isfinite(v) for m in h for v in m.values()):
            raise SystemExit(f"chip_smoke: a {mode} metric is not finite")
    if ops.launch_counts() != counts0:
        raise SystemExit("chip_smoke: training launched a kernel")
    log("  where a joint step's time goes (one more step, torch.profiler)")
    with tempfile.TemporaryDirectory() as tmp:
        tr = JointTrainer(cfg, tcfg, llm, flow, out_dir=tmp, total_steps=1000)
        state = tr.init_state(torch.Generator(device=DEV).manual_seed(13))

        def one():
            float(tr.step(state, sb, torch.Generator(device=DEV).manual_seed(14))["loss"])

        one()
        wall_ms, busy, by_name = profile_device(one)
        t0 = time.perf_counter()
        one()
        log_profile(wall_ms, (time.perf_counter() - t0) * 1e3, busy, by_name, top=8)


def expect_blocks(counts, nfe, what):
    """Fail unless ``counts`` show 64 x ``nfe`` fused blocks of three
    launches and no LayerNorm, GEMM or banded launch."""
    blocks = 64 * nfe
    if counts["fused_transformer_block"] != blocks or counts["ln_gemm"] != blocks \
            or counts["block_tail"] != blocks or counts["flash_attention"] != blocks \
            or counts["gemm"] != 0 or counts["layer_norm_rows"] != 0 \
            or counts["banded_attention"] != 0:
        raise SystemExit(f"chip_smoke: {what} launch counts {counts} off 64 x NFE {nfe} blocks "
                         "of three launches")


def check_same_tokens(pipe, what, got, want, prefix_rows, cpu_p=None):
    """The rule for batched against solo tokens on the card: identical, or
    at the first diverging step j the teacher-forced logits of the row in a
    left-padded batch (``prefix_rows``: the batch's prefixes, this row
    first) and of the solo decode agree within 1e-4 * max(1, max|logit|),
    so the flip is a sampling boundary crossed by a rounding difference.
    With ``cpu_p`` (the LLM's weights on the CPU), ``want`` is the CPU's
    decode and the solo logits are the CPU's."""
    got, want = list(got), list(want)
    if got == want:
        return
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
    p, cfg = pipe.llm_p, pipe.cfg.llm
    prefix, valid, _, _ = _batch_prefixes(prefix_rows)
    n = min(len(want), j)
    rows = [want[:n]] + [[0] * n for _ in prefix_rows[1:]]
    ref_p, ref_prefix = (p, prefix_rows[0][0]) if cpu_p is None else \
        (cpu_p, prefix_rows[0][0].cpu())
    with torch.inference_mode():
        batched = llm_teacher_forced_logits(p, cfg, prefix, valid, rows)[0, n].float().cpu()
        solo = llm_teacher_forced_logits(ref_p, cfg, ref_prefix, [ref_prefix.shape[1]],
                                         [want[:n]])[0, n].float().cpu()
    gap = (batched - solo).abs().max().item()
    tol = 1e-4 * max(1.0, solo.abs().max().item())
    log(f"  {what}: tokens diverge from the solo decode at step {j} of {len(want)}; "
        f"teacher-forced logit gap there {gap:.3e} (tol {tol:.3e})")
    if not gap <= tol:
        raise SystemExit(f"chip_smoke: {what} diverges from its solo decode beyond rounding")


def streaming_synthesis(cfg, llm, flow, hift, n_ids=20, cap=400, seed=18):
    """Phase 9."""
    icfg = InferenceConfig(min_token_text_ratio=20.0)
    pipe = TTSPipeline(cfg, llm, flow, hift, icfg, finetuned_norm=True)
    plan = pipe.stream_plan(cap)
    nfe = sum(pipe._select_nfe(pipe._mel_len(b - a)) for a, b, _ in plan)
    log(f"[9] streaming synthesis, full width: {n_ids} seeded text ids, EOS held off to {cap} "
        f"tokens and the decode capped there; windows {[(a, b) for a, b, _ in plan]} "
        f"(the last bucketed to {pipe._final_tok_bucket} tokens), NFE {nfe} in all")
    if [b - a for a, b, _ in plan] != [120, 120, 120, 100] or nfe != 40:
        raise SystemExit(f"chip_smoke: the streaming plan {plan} is not 3 x 120 + 100 tokens")
    ids = np.random.default_rng(17).integers(0, 256, (1, n_ids)).astype(np.int64)
    spk = np.zeros((1, cfg.llm.spk_embed_dim), np.float32)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    chunks, at = [], []
    for out in pipe.synthesize(ids, spk_embedding=spk, max_len_cap=cap, seed=seed, stream=True):
        chunks.append(out["tts_speech"])
        at.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    audio_s = sum(c.shape[1] for c in chunks) / cfg.sample_rate
    log(f"  time to the first chunk {at[0]:.3f} s ({chunks[0].shape[1] / cfg.sample_rate:.3f} s "
        f"of audio); chunks at {', '.join(f'{x:.3f}' for x in at)} s; seconds per later chunk "
        f"{', '.join(f'{b - a:.3f}' for a, b in zip(at, at[1:]))}; {audio_s:.2f} s of audio "
        f"in {at[-1]:.3f} s (RTF {at[-1] / audio_s:.3f})")
    log(f"  launches: {counts}")
    if [c.shape[1] for c in chunks] != [s for _, _, s in plan] \
            or not all(np.isfinite(c).all() for c in chunks):
        raise SystemExit(f"chip_smoke: streamed chunks {[c.shape for c in chunks]} off the plan "
                         f"{plan} or not finite")
    expect_blocks(counts, nfe, "streaming")
    with torch.inference_mode():
        whole = pipe.generate_tokens(ids, spk, cap, torch.Generator().manual_seed(
            stream_seed(seed, 0, 0)))[0]
        segs = list(pipe.generate_tokens_stream(ids, spk, cap, torch.Generator().manual_seed(
            stream_seed(seed, 0, 0))))
    log(f"  decode segments of {[s.shape[1] for s, _ in segs]} tokens; streamed tokens equal "
        f"generate_tokens: {np.array_equal(segs[-1][0][0], whole)}")
    if len(whole) != cap or not np.array_equal(segs[-1][0][0], whole):
        raise SystemExit("chip_smoke: the streamed tokens differ from generate_tokens")
    log("  where a window's time goes: token2wav of the first 120-token window (fresh carries), "
        "torch.profiler")

    def window():
        pipe.token2wav(whole[None, :120], spk, stream_state=StreamState(), finalize=False,
                       generator=torch.Generator(device=DEV).manual_seed(seed))

    with torch.inference_mode():
        window()
        wall_ms, busy, by_name = profile_device(window)
        plain_wall = cuda_ms(window, 3)
    log_profile(wall_ms, plain_wall, busy, by_name, top=6)


def enqueue_without_sync(state, steps, what):
    """Enqueue one decode segment of ``steps`` steps under
    torch.cuda.set_sync_debug_mode("error"), so that a host read inside a
    step (a blocking copy, .item(), a synchronize) raises and fails the run,
    then read it back; its host reads must not exceed its chunks."""
    torch.cuda.synchronize()
    reads, frozen = state.host_reads, state.frozen_steps
    torch.cuda.set_sync_debug_mode("error")
    try:
        seg = state.launch(state.i + steps)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    seg.wait()
    reads, frozen, chunks = (state.host_reads - reads, state.frozen_steps - frozen,
                             -(-steps // DECODE_CHUNK))
    log(f"  {what}: a segment of {steps} steps enqueued under set_sync_debug_mode('error') "
        f"(no host read inside a step); {reads} host reads for its {chunks} chunks of "
        f"{DECODE_CHUNK} steps, {frozen} frozen steps")
    if reads > chunks:
        raise SystemExit(f"chip_smoke: {what}: {reads} host reads for one segment")


def cpu_weights(p):
    """The weights of ``p`` copied to the CPU (the reference decode's)."""
    return P({k: v.detach().cpu() for k, v in p.d.items()})


def device_decode(pipe, cfg, llm, flow, hift, texts, built, spk, solo, seed):
    """Phase 10 (d): the device-resident decode (models/decode.py): a
    segment enqueued with no host read, request 0's card tokens against the
    CPU decode with the same generator, and tokens/s over 100 steps (EOS
    held off) at B = 1 and 4, f32 and int8, with the host reads and frozen
    steps a segment."""
    with torch.inference_mode():
        st = pipe._decode_batch(texts[:4], [spk] * 4, 2048, seed)
        enqueue_without_sync(st, 20, "(d) 300M decode, B = 4")
        cpu_p = cpu_weights(pipe.llm_p)
        prefix, mn, mx = built[0]
        t0 = time.perf_counter()
        want = TLLM.llm_decode_start(cpu_p, cfg.llm, prefix.cpu(), [prefix.shape[1]], [mn], [mx],
                                     [torch.Generator().manual_seed(stream_seed(seed, 0, 0))],
                                     **pipe._sampling()).run().tokens[0]
        t_cpu = time.perf_counter() - t0
    log(f"  (d) request 0 decoded on the CPU ({len(want)} tokens in {t_cpu:.1f} s): card tokens "
        f"identical {list(solo[0]) == want}")
    check_same_tokens(pipe, "card decode of request 0 against the CPU", solo[0], want, [built[0]],
                      cpu_p=cpu_p)
    pipes = {False: pipe, True: TTSPipeline(cfg, llm, flow, hift,
                                            InferenceConfig(int8_decode=True,
                                                            min_token_text_ratio=20.0),
                                            finetuned_norm=True)}
    rates, per_seg = {}, {}
    with torch.inference_mode():
        for q, B, steps in [(False, 1, 30)] + [(q, B, 100) for q in (False, True) for B in (1, 4)]:
            p = pipes[q]
            prefix, valid, _, _ = _batch_prefixes(built[:B])
            st = TLLM.llm_decode_start(p.llm_p, cfg.llm, prefix, valid, [steps + 1] * B,
                                       [steps + 1] * B,
                                       [torch.Generator().manual_seed(b) for b in range(B)],
                                       **p._sampling(), step_p=p.llm_step_p)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            while not all(st.done):
                st.run(st.i + pipe.token_min_hop_len)
            torch.cuda.synchronize()
            rates[q, B] = B * steps / (time.perf_counter() - t0)  # the warm-up's is replaced
            per_seg[q, B] = (st.host_reads - 1) / st.segments_run, st.frozen_steps
    log(f"  (d) decode tokens/s over 100 steps in segments of {pipe.token_min_hop_len} (host "
        f"clock, prefill excluded): f32 B=1 {rates[False, 1]:.1f}, B=4 {rates[False, 4]:.1f}; "
        f"int8 B=1 {rates[True, 1]:.1f}, B=4 {rates[True, 4]:.1f}; host reads a segment "
        + ", ".join(f"{'int8' if q else 'f32'} B={B} {r:.2f} (frozen steps {f})"
                    for (q, B), (r, f) in per_seg.items()))


def batched_serving(cfg, llm, flow, hift, seed=21):
    """Phase 10."""
    icfg = InferenceConfig(min_token_text_ratio=20.0)
    pipe = TTSPipeline(cfg, llm, flow, hift, icfg, finetuned_norm=True)
    spk = np.zeros((1, cfg.llm.spk_embed_dim), np.float32)
    lens = (6, 8, 10, 12, 7, 9)
    texts = [np.random.default_rng(30 + i).integers(0, 256, (1, n)).astype(np.int64)
             for i, n in enumerate(lens)]
    log(f"[10] batched decode and the continuous-batching engine, full width: requests of "
        f"{list(lens)} text ids, EOS held off to 20 tokens an id")
    with torch.inference_mode():
        built = [pipe._build_prefix(x, None, None, spk, 2048) for x in texts]
        solo = []
        for n_req in (4, 6):  # the first four, one by one, are the B = 1 yardstick
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solo += [pipe.generate_tokens(texts[b], spk, 2048, torch.Generator().manual_seed(
                stream_seed(seed, b, 0)))[0] for b in range(len(solo), n_req)]
            if n_req == 4:
                t_solo = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = pipe._decode_batch(texts[:4], [spk] * 4, 2048, seed).run()
        torch.cuda.synchronize()
        t_batch = time.perf_counter() - t0
    n4 = sum(len(s) for s in solo[:4])
    log(f"  decode tokens/s (host clock, prefills included): B=4 {n4 / t_batch:.1f} ({n4} "
        f"tokens in {t_batch:.3f} s, {max(len(s) for s in solo[:4])} steps) against B=1 "
        f"{n4 / t_solo:.1f} (the same four one by one, {t_solo:.3f} s): "
        f"{t_solo / t_batch:.2f}x")
    for b in range(4):
        check_same_tokens(pipe, f"batch row {b}", state.tokens[b], solo[b],
                          [built[b]] + [built[i] for i in range(4) if i != b])
    for B in (1, 4):
        log(f"  where a decode step's time goes, B={B}: 20 steps, torch.profiler")
        with torch.inference_mode():
            st = pipe._decode_batch(texts[:B], [spk] * B, 2048, seed)
            st.run(st.i + 5)
            wall_ms, busy, by_name = profile_device(lambda: st.run(st.i + 20))
            t0 = time.perf_counter()
            st.run(st.i + 20)
            torch.cuda.synchronize()
        log_profile(wall_ms, (time.perf_counter() - t0) * 1e3, busy, by_name, top=4)
    if [len(s) for s in solo] != [20 * n for n in lens]:
        raise SystemExit(f"chip_smoke: solo decodes of {[len(s) for s in solo]} tokens, "
                         f"not {[20 * n for n in lens]}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    wavs = pipe.synthesize_batch(texts[:4], max_len_cap=2048, seed=seed)
    t_sb = time.perf_counter() - t0
    counts = ops.launch_counts()
    nfe = sum(pipe._select_nfe(pipe._mel_len(20 * n)) for n in lens[:4])
    log(f"  synthesize_batch: {t_sb:.3f} s for {sum(w.shape[1] for w in wavs) / 22050:.2f} s "
        f"of audio; launches {counts}")
    if [w.shape[1] for w in wavs] != [256 * pipe._mel_len(20 * n) for n in lens[:4]] \
            or not all(np.isfinite(w).all() for w in wavs):
        raise SystemExit("chip_smoke: synthesize_batch output has the wrong shape or is not finite")
    expect_blocks(counts, nfe, "synthesize_batch")

    plans = [pipe.stream_plan(20 * n) for n in lens]
    nfe = sum(pipe._select_nfe(pipe._mel_len(b - a)) for pl in plans for a, b, _ in pl)
    runs = {}
    for prefetch in (False, True):
        eng = ContinuousBatchEngine(pipe, slots=4, prefetch=prefetch)
        ops.reset_launch_counts()
        try:
            t0 = time.perf_counter()
            reqs = [eng.submit(x, seed=stream_seed(seed, b, 0)) for b, x in enumerate(texts)]
            outs = [list(r.chunks(timeout=600)) for r in reqs]
            t_eng = time.perf_counter() - t0
        finally:
            eng.stop()
        counts = ops.launch_counts()
        log(f"  engine, 4 slots, prefetch {'on' if prefetch else 'off'}: {len(reqs)} requests in "
            f"{t_eng:.3f} s wall, {eng.segments_run} segments, {eng.prefetch_hits} prefetch "
            f"hits; admitted at segments {[r.admitted_segment for r in reqs]}; chunks "
            f"{[len(o) for o in outs]}; launches {counts}")
        for b, (r, o) in enumerate(zip(reqs, outs)):
            if [c.shape[1] for c in o] != [s for _, _, s in plans[b]] \
                    or not all(np.isfinite(c).all() for c in o):
                raise SystemExit(f"chip_smoke: engine request {b} chunks off its plan or not "
                                 "finite")
            check_same_tokens(pipe, f"engine request {b}", r.tokens, solo[b], [built[b]])
        if not any(r.admitted_segment for r in reqs):
            raise SystemExit("chip_smoke: no request was admitted mid-flight")
        expect_blocks(counts, nfe, "engine")
        runs[prefetch] = (t_eng, eng.prefetch_hits, [list(r.tokens) for r in reqs])
    log(f"  engine prefetch on against off: wall {runs[True][0]:.3f} / {runs[False][0]:.3f} s, "
        f"hits {runs[True][1]} / {runs[False][1]}; tokens identical "
        f"{runs[True][2] == runs[False][2]}")
    if not (runs[True][1] > 0 and runs[False][1] == 0):
        raise SystemExit("chip_smoke: the engine's prefetch hits are off")
    device_decode(pipe, cfg, llm, flow, hift, texts, built, spk, solo, seed)


def refuse_missing_gelu():
    """No launch on a GELU code the kernels lack: the wrappers refuse the
    name, and the C entries refuse code 3 (the wrappers' check bypassed)."""
    M, rows = 8, []
    a, x = torch.zeros(M, 512, device=DEV), torch.zeros(M, 256, device=DEV)
    tail_w = [torch.zeros(sh, device=DEV) for sh in ((256, 512), (256,), (256,), (256,),
                                                     (1024, 256), (1024,), (256, 1024), (256,))]
    y = torch.empty(M, 256, device=DEV)
    n0 = (block_tail.launches, gemm.launches)
    for gelu in ("sigmoid", None):
        try:
            block_tail(a, x, *tail_w, gelu=gelu)
        except ValueError as e:
            rows.append(f"block_tail(gelu={gelu!r}): {e}")
        else:
            raise SystemExit(f"chip_smoke: block_tail accepted gelu {gelu!r}")
    code = _cuda.DTYPE_CODE[torch.float32]
    rc_tail = _cuda.function("cosy_block_tail")(
        code, *(t.data_ptr() for t in [a, x] + tail_w + [y]), M, 256, 512, 1024, 1e-5, 3,
        *_tail_plan(M, 256, 512, 1024, torch.float32), _cuda.stream_ptr(x))
    w = torch.zeros(256, 512, device=DEV)
    rc_gemm = _cuda.function("cosy_gemm")(
        code, -1, code, a.data_ptr(), w.data_ptr(), None, None, 256, None, None, y.data_ptr(),
        M, 256, 512, 3, *_gemm_plan(M, 256, 512, torch.float32), _cuda.stream_ptr(a))
    torch.cuda.synchronize()
    log(f"  refused a GELU the kernels lack: {'; '.join(rows)}; C entries with act 3 return "
        f"{rc_tail} (block_tail) and {rc_gemm} (gemm), cudaErrorInvalidValue = 1")
    if rc_tail == 0 or rc_gemm == 0 or (block_tail.launches, gemm.launches) != n0:
        raise SystemExit("chip_smoke: a kernel took a GELU code it lacks")


def erf_estimator(est, ecfg, args, est_cpu, y_tanh):
    """Phase 4, second call: the estimator with gelu_approximate=False on
    the card (B1 -> A -> B2-erf in every block) against the CPU plain path.
    Returns its launch counts."""
    ecfg = dataclasses.replace(ecfg, gelu_approximate=False)
    log("[4] the same call with gelu_approximate=False (exact GELU in B2)")
    with torch.inference_mode():
        ops.reset_launch_counts()
        y = conditional_decoder(est, ecfg, *args)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        ms = cuda_ms(lambda: conditional_decoder(est, ecfg, *args), 5)
        y_cpu = conditional_decoder(est_cpu, ecfg, *(a.cpu() for a in args))
    err = (y.cpu() - y_cpu).abs().max().item()
    scale = y_cpu.abs().max().item()
    gap = (y - y_tanh).abs().max().item()
    log(f"  card {ms:.3f} ms/call; max_abs_err {err:.3e} vs max|y| {scale:.3e} (tol 1e-4 * "
        f"max(1, max|y|)); max |y_erf - y_tanh| {gap:.3e}; launches {counts}")
    if not (torch.isfinite(y).all() and err <= 1e-4 * max(1.0, scale)):
        raise SystemExit("chip_smoke: the erf estimator disagrees with the CPU plain path")
    if counts["fused_transformer_block"] != 64 or counts["block_tail"] != 64 \
            or counts["ln_gemm"] != 64 or gap == 0.0:
        raise SystemExit(f"chip_smoke: the erf estimator did not run 64 erf blocks: {counts}")
    return counts


def refuse_tiny_widths():
    """The early width refusal: TTSPipeline with a tiny estimator on the
    card, and the CLI's --tiny --device cuda, both before any kernel runs."""
    from cosy_tpu_torch.config import tiny_model_config
    from cosy_tpu_torch.infer.__main__ import main as infer_main
    from cosy_tpu_torch.ops.fused_block import KERNEL_WIDTHS

    tiny = tiny_model_config()
    mods = (init_llm_params(tiny.llm, DEV, seed=1), init_flow_params(tiny.flow, DEV, seed=2),
            init_hift_params(tiny.hift, DEV, seed=3))
    ops.reset_launch_counts()
    try:
        TTSPipeline(tiny, *mods)
    except ValueError as e:
        msg = str(e)
    else:
        raise SystemExit("chip_smoke: TTSPipeline took a tiny estimator on the card")
    try:
        infer_main(["--text", "ab", "--tiny", "--device", "cuda", "--output",
                    os.path.join(tempfile.gettempdir(), "refused.wav")])
    except SystemExit as e:
        cli_msg = str(e.code)
    else:
        raise SystemExit("chip_smoke: the CLI ran --tiny on the card")
    log(f"  refused a tiny estimator on the card: TTSPipeline: {msg}; CLI: {cli_msg}")
    if KERNEL_WIDTHS not in msg or KERNEL_WIDTHS not in cli_msg \
            or any(ops.launch_counts().values()):
        raise SystemExit("chip_smoke: the width refusal lacks the widths or launched a kernel")


def _records(n, seed, vocab):
    """``n`` seeded training records at the full configuration's vocabularies:
    100-250 mel frames, ~1/1.72 as many speech tokens, text ids, a 192-dim
    embedding."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        T = int(rng.integers(100, 251))
        out.append({"utt": f"u{seed}_{i}",
                    "speech_feat": (rng.standard_normal((T, 80)) * 2 - 6).astype(np.float32)
                    .reshape(-1).tolist(), "speech_feat_shape": [T, 80],
                    "speech_token": rng.integers(0, vocab, int(T / 1.72)).tolist(),
                    "text_token": rng.integers(0, 256, int(rng.integers(8, 40))).tolist(),
                    "utt_embedding": rng.standard_normal(192).astype(np.float32).tolist()})
    return out


def training_cli(cfg):
    """Phase 11: python -m cosy_tpu_torch.train at full width on seeded
    records: 32 records (batch 8 x accum 2: 2 steps), a checkpoint, a
    --resume over 16 more (1 step), the merged export, and a short
    synthesis from the merged weights."""
    try:
        import pandas  # noqa: F401
        import pyarrow  # noqa: F401
        parquet = True
    except ImportError:
        parquet = False
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as root:
        _training_cli(cfg, parquet, root)


def _training_cli(cfg, parquet, root):
    from cosy_tpu_torch.data.dataset import AugmentConfig, FlowFinetuneDataset
    from cosy_tpu_torch.train import __main__ as train_cli

    out = os.path.join(root, "out")
    vocab = cfg.llm.speech_token_size
    sets = {"train": _records(32, 40, vocab), "resume": _records(16, 41, vocab)}
    how = ("import: parquet records through main()" if parquet
           else "do not import: records handed to run()")
    log(f"[11] the training CLI at full width: pandas and pyarrow {how}")
    torch.cuda.reset_peak_memory_stats()
    results = []
    for name, recs in sets.items():
        argv = ["--data-dir", os.path.join(root, name), "--output", out, "--batch-size", "8",
                "--accum", "2", "--epochs", "1", "--pretrained", os.path.join(root, "none"),
                "--device", DEV.type]
        if name == "resume":
            argv += ["--resume", os.path.join(out, "joint_joint_last.ckpt")]
        if cfg != ModelConfig():
            argv.append("--tiny")  # a rehearsal at the tiny widths
        if parquet:
            import pandas as pd

            os.makedirs(os.path.join(root, name))
            pd.DataFrame(recs).to_parquet(os.path.join(root, name, "part0.parquet"))
            res = train_cli.main(argv)
        else:
            # the dataset main() builds, its parquet read left out
            args = train_cli.parse_args(argv)
            tcfg = train_cli.train_config(args)
            ds = FlowFinetuneDataset.__new__(FlowFinetuneDataset)
            ds.data_dir, ds.samples, ds.aug_cfg = args.data_dir, recs, AugmentConfig()
            ds.leak, ds.rng = tcfg.anti_leakage, np.random.default_rng(tcfg.seed)
            res = train_cli.run(ds, cfg, tcfg, args.pretrained, out, DEV.type, args.resume)
        results.append(res)
        log(f"  {name}: {res.steps} steps to step {res.state.step}; "
            f"{res.seconds / res.steps:.3f} s/step, loader wait {res.loader_wait / res.steps:.4f} "
            f"s/step")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  peak device memory {peak:.2f} GiB")
    if [r.steps for r in results] != [2, 1] or results[1].state.step != 3:
        raise SystemExit(f"chip_smoke: the CLI took {[r.steps for r in results]} steps")
    names = set(os.listdir(out))
    if not {"llm_merged_joint.pt", "flow_merged_joint.pt", "adapters_joint.pt"} <= names:
        raise SystemExit(f"chip_smoke: the CLI's exports are missing from {sorted(names)}")
    with open(os.path.join(out, "flow_merged_joint.pt.meta.json")) as f:
        if json.load(f)["mel_space"] != "normalized":
            raise SystemExit("chip_smoke: merged flow weights lack their mel-space note")
    llm, flow = TransformerLM(cfg.llm, DEV), Flow(cfg.flow, DEV)
    llm.load_state_dict(load_torch_checkpoint(os.path.join(out, "llm_merged_joint.pt")), strict=True)
    flow.load_state_dict(load_torch_checkpoint(os.path.join(out, "flow_merged_joint.pt")),
                         strict=True)
    base = results[-1].trainer.flow_master
    moved = sum(int(not torch.equal(v, base[k])) for k, v in flow.state_dict().items())
    pipe = TTSPipeline(cfg, llm, flow, init_hift_params(cfg.hift, DEV, seed=4))
    ops.reset_launch_counts()
    wav = next(pipe.synthesize(np.arange(1, 9)[None], spk_embedding=np.zeros((1, 192), np.float32),
                               max_len_cap=60, seed=3))["tts_speech"]
    counts = ops.launch_counts()
    log(f"  synthesis from the merged weights ({moved} flow tensors changed by the merge): "
        f"{wav.shape}, finite {bool(np.isfinite(wav).all())}; launches {counts}")
    if not np.isfinite(wav).all() or wav.shape[1] == 0 or counts["block_tail"] == 0 \
            or moved == 0:
        raise SystemExit("chip_smoke: synthesis from the CLI's merged weights failed")


def check_same_tokens_cv2(pipe, what, got, want, rows, cpu_p=None):
    """check_same_tokens for CosyVoice2: ``rows`` are the batch's prefixes
    (built by _build_prefix), this row first; ``cpu_p`` as there."""
    got, want = list(got), list(want)
    if got == want:
        return
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
    prefix, valid, _, _ = _batch_prefixes(rows)
    n = min(len(want), j)
    ref_p, ref_prefix = (pipe.llm_p, rows[0][0]) if cpu_p is None else (cpu_p, rows[0][0].cpu())
    with torch.inference_mode():
        batched = qwen2lm_teacher_forced_logits(
            pipe.llm_p, pipe.lcfg, prefix, valid, [want[:n]] + [[0] * n] * (len(rows) - 1))[0, n]
        solo = qwen2lm_teacher_forced_logits(ref_p, pipe.lcfg, ref_prefix,
                                             [ref_prefix.shape[1]], [want[:n]])[0, n]
    gap = (batched.float().cpu() - solo.float().cpu()).abs().max().item()
    tol = 1e-4 * max(1.0, solo.float().abs().max().item())
    log(f"  {what}: tokens diverge from the solo decode at step {j} of {len(want)}; "
        f"teacher-forced logit gap there {gap:.3e} (tol {tol:.3e})")
    if not gap <= tol:
        raise SystemExit(f"chip_smoke: {what} diverges from its solo decode beyond rounding")


def cv2_synthesis(seed=50):
    """Phase 12: CosyVoice2 at full width on seeded weights.  Returns the
    launch counts of its three runs together."""
    lcfg, fcfg, hcfg = Qwen2LMConfig(), Flow2Config(), hift24k_config()
    t = time.time()
    llm = init_qwen2lm_params(lcfg, DEV, seed=seed)
    flow = init_flow2_params(fcfg, DEV, seed=seed + 1)
    hift = init_hift_params(hcfg, DEV, seed=seed + 2)
    torch.cuda.synchronize()
    log(f"[12] CosyVoice2 at full width: weights on the card in {time.time() - t:.1f} s: qwen2lm "
        f"{sum(p.numel() for p in llm.parameters()) / 1e6:.1f} M, flow2 "
        f"{sum(p.numel() for p in flow.parameters()) / 1e6:.1f} M, hift 24 kHz "
        f"{sum(p.numel() for p in hift.parameters()) / 1e6:.1f} M params")
    cap = 150
    hop = int(np.prod(hcfg.upsample_rates)) * hcfg.istft_hop_len  # 480 samples a frame
    per_tok = fcfg.token_mel_ratio * hop
    # 10 text ids at min ratio 15: EOS held off for all 150 attempts
    pipe = TTS2Pipeline(lcfg, fcfg, hcfg, llm, flow, hift,
                        InferenceConfig(min_token_text_ratio=15.0), hop_samples=hop)
    rng = np.random.default_rng(seed)
    n_text, n_speech = lcfg.qwen.vocab_size, lcfg.speech_token_size
    text = rng.integers(0, n_text, (1, 10))
    prompt = dict(prompt_text=rng.integers(0, n_text, (1, 5)),
                  llm_prompt_speech_token=rng.integers(0, n_speech, (1, 50)),
                  flow_prompt_speech_token=rng.integers(0, n_speech, (1, 50)),
                  prompt_feat=(rng.standard_normal((1, 100, 80)) * 2 - 6).astype(np.float32),
                  flow_embedding=rng.standard_normal((1, fcfg.spk_embed_dim)).astype(np.float32))
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    wav = next(pipe.synthesize(text, max_len_cap=cap, seed=seed, **prompt))["tts_speech"]
    t_a = time.perf_counter() - t0
    counts = ops.launch_counts()
    add(counts)
    n_a = wav.shape[1] // per_tok
    dec = pipe.stage_seconds["decode"]
    log(f"  (a) synthesize(stream=False), 50-token flow prompt (100 frames): {n_a} tokens, T = "
        f"{100 + 2 * n_a} mel frames; {t_a:.3f} s; stages (s) "
        + ", ".join(f"{k} {v:.3f}" for k, v in pipe.stage_seconds.items())
        + f"; decode {n_a / dec:.1f} tokens/s; launches {counts}")
    if wav.shape[1] % per_tok or n_a < 0.9 * cap or not np.isfinite(wav).all():
        raise SystemExit(f"chip_smoke: CosyVoice2 whole-utterance output {wav.shape} is off")
    expect_blocks(counts, 10, "CosyVoice2 whole utterance")

    spk = prompt["flow_embedding"]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    chunks, at = [], []
    for out in pipe.synthesize(text, flow_embedding=spk, max_len_cap=cap, seed=seed, stream=True):
        chunks.append(out["tts_speech"])
        at.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    add(counts)
    n_b = sum(c.shape[1] for c in chunks) // per_tok
    windows = (n_b - 3) // 25
    log(f"  (b) synthesize(stream=True), prompt-free: {n_b} tokens in {windows} windows of 25 + 3 "
        f"lookahead with the chunk bias, then the bucketed final; time to the first chunk "
        f"{at[0]:.3f} s; chunks at {', '.join(f'{x:.3f}' for x in at)} s; stages (s) "
        + ", ".join(f"{k} {v:.3f}" for k, v in pipe.stage_seconds.items())
        + f"; launches {counts}")
    if len(chunks) != windows + 1 or sum(c.shape[1] for c in chunks) % per_tok \
            or not all(np.isfinite(c).all() for c in chunks):
        raise SystemExit("chip_smoke: CosyVoice2 streamed chunks are off")
    expect_blocks(counts, 10 * len(chunks), "CosyVoice2 streaming")

    texts = [rng.integers(0, n_text, (1, n)) for n in (4, 6, 5, 3)]
    with torch.inference_mode():
        built = [pipe._build_prefix(x, None, None, cap) for x in texts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solo = [pipe.generate_tokens(x, max_len_cap=cap, generator=pipe._decode_generator(
            seed, b))[0].tolist() for b, x in enumerate(texts)]
        t_solo = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows = pipe.decode_batch(texts, cap, seed)
        t_batch = time.perf_counter() - t0
    n4 = sum(len(r) for r in solo)
    log(f"  (c) decode tokens/s (host clock, prefills included): B=4 {n4 / t_batch:.1f} against "
        f"B=1 {n4 / t_solo:.1f} ({t_solo / t_batch:.2f}x); tokens {[len(r) for r in solo]}")
    for b in range(4):
        check_same_tokens_cv2(pipe, f"CosyVoice2 batch row {b}", rows[b], solo[b],
                              [built[b]] + [built[i] for i in range(4) if i != b])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    wavs = pipe.synthesize_batch(texts, max_len_cap=cap, seed=seed)
    counts = ops.launch_counts()
    add(counts)
    log(f"  synthesize_batch of 4: {time.perf_counter() - t0:.3f} s, "
        f"{sum(w.shape[1] for w in wavs) / hcfg.sampling_rate:.2f} s of audio; launches {counts}")
    if [w.shape[1] for w in wavs] != [per_tok * len(r) for r in rows] \
            or not all(np.isfinite(w).all() for w in wavs):
        raise SystemExit("chip_smoke: CosyVoice2 synthesize_batch output is off")
    expect_blocks(counts, 40, "CosyVoice2 synthesize_batch")

    # one streaming estimator call (a 100-frame window, the chunk bias at both
    # levels) on the card against the CPU plain path
    est = pipe.flow_p.sub("decoder.estimator")
    gen = torch.Generator(device=DEV).manual_seed(seed)
    x, mu, cond = (torch.randn(2, 80, 100, device=DEV, generator=gen) for _ in range(3))
    args = (x, None, mu, torch.rand(2, device=DEV, generator=gen),
            torch.randn(2, 80, device=DEV, generator=gen), cond)
    kw = dict(causal=True, streaming=True, static_chunk_size=fcfg.decoder_static_chunk_size)
    with torch.inference_mode():
        ops.reset_launch_counts()
        y = conditional_decoder(est, fcfg.estimator, *args, **kw)
        counts = ops.launch_counts()
        est_cpu = P({k: v.cpu() for k, v in est.d.items()}).sub("decoder.estimator")
        y_cpu = conditional_decoder(est_cpu, fcfg.estimator, x.cpu(), None,
                                    *(a.cpu() for a in args[2:]), **kw)
    err, scale = (y.cpu() - y_cpu).abs().max().item(), y_cpu.abs().max().item()
    log(f"  streaming estimator call (2, 80, 100) with the chunk bias: max_abs_err {err:.3e} vs "
        f"max|y| {scale:.3e} (tol 1e-4 * max(1, max|y|)); launches {counts}")
    if not (torch.isfinite(y).all() and err <= 1e-4 * max(1.0, scale)) \
            or counts["fused_transformer_block"] != 64:
        raise SystemExit("chip_smoke: the streaming causal estimator disagrees with the CPU")
    return total, (llm, flow, hift)


def solo_stream2(pipe, text, seed, row, cap):
    """A solo streamed CosyVoice2 synthesis of ``text`` with row ``row``'s
    draws (the reference each batched, engine or admitted stream is held
    to): (tokens, chunks, seconds to the first chunk)."""
    cur = Stream2Cursor(pipe._spk(None), seed, row, pipe.token_hop_len)
    chunks, first = [], None
    t0 = time.perf_counter()
    with torch.inference_mode():
        for tokens, done in pipe.generate_tokens_stream(
                text, max_len_cap=cap, generator=pipe._decode_generator(seed, row)):
            for wav in pipe.stream_chunks(cur, tokens, done):
                chunks.append(wav)
                first = first or time.perf_counter() - t0
    return tokens[0].tolist(), chunks, first


def hold_stream2(pipe, what, tokens, chunks, ref, rows):
    """A CosyVoice2 stream against its solo reference (tokens, chunks): the
    tokens equal, or diverging within rounding (check_same_tokens_cv2, with
    ``rows`` the batch's prefixes, this row first); every chunk whose
    window lies before any divergence within 1e-4 * max(1, max|wav|) of the
    solo chunk.  Returns the number of chunks compared."""
    want_tokens, want_chunks = ref
    check_same_tokens_cv2(pipe, what, tokens, want_tokens, rows)
    j = None if list(tokens) == list(want_tokens) else next(
        (i for i, (a, b) in enumerate(zip(tokens, want_tokens)) if a != b),
        min(len(tokens), len(want_tokens)))
    if j is None and len(chunks) != len(want_chunks):
        raise SystemExit(f"chip_smoke: {what}: {len(chunks)} chunks, solo {len(want_chunks)}")
    hop, la = pipe.token_hop_len, pipe.fcfg.pre_lookahead_len
    n = 0
    for k, (g, w) in enumerate(zip(chunks, want_chunks)):
        if j is not None and (k == len(want_chunks) - 1 or k * hop + hop + la > j):
            break
        err, tol = np.abs(g - w).max(initial=0.0), 1e-4 * max(1.0, np.abs(w).max(initial=0.0))
        if g.shape != w.shape or not np.isfinite(g).all() or not err <= tol:
            raise SystemExit(f"chip_smoke: {what} chunk {k} {g.shape} off the solo stream's "
                             f"{w.shape}: max_abs_err {err:.3e} (tol {tol:.3e})")
        n += 1
    return n


def cv2_serving(lcfg, fcfg, hcfg, llm, flow, hift, cap=100, seed=60):
    """Phase 13: CosyVoice2 serving at full width.  Returns the launch
    counts of (a) and (b) together."""
    hop = int(np.prod(hcfg.upsample_rates)) * hcfg.istft_hop_len
    # EOS held off to ``cap`` attempts (15 per text id against a cap of 100):
    # every stream runs its cap, less any fill tokens
    pipe = TTS2Pipeline(lcfg, fcfg, hcfg, llm, flow, hift,
                        InferenceConfig(min_token_text_ratio=15.0), hop_samples=hop)
    lens = (8, 2, 9, 3, 3, 4)  # caps 100, 40, 100, 60, 60, 80 attempts
    texts = [np.random.default_rng(seed + i).integers(0, lcfg.qwen.vocab_size, (1, n))
             for i, n in enumerate(lens)]
    log(f"[13] CosyVoice2 serving at full width: requests of {list(lens)} text ids, EOS held off "
        f"to min(15 n, {cap}) attempts, 25-token hops + {fcfg.pre_lookahead_len} lookahead")
    with torch.inference_mode():
        built = [pipe._build_prefix(x, None, None, cap) for x in texts]
    # solo streams: row b's draws are those of request b (stream_seed(seed, b, .))
    refs, firsts = [], []
    t0 = time.perf_counter()
    for b, x in enumerate(texts):
        tokens, chunks, first = solo_stream2(pipe, x, seed, b, cap)
        refs.append((tokens, chunks))
        firsts.append(first)
    log(f"  solo streams: {[len(t) for t, _ in refs]} tokens, {[len(c) for _, c in refs]} chunks "
        f"in {time.perf_counter() - t0:.3f} s; time to the first chunk "
        f"{', '.join(f'{f:.3f}' for f in firsts)} s")

    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # (a) batched streaming of the first four
    got = {b: [] for b in range(4)}
    first = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for b, wav, _ in pipe.synthesize_stream_batch(texts[:4], max_len_cap=cap, seed=seed):
            got[b].append(wav)
            first.setdefault(b, time.perf_counter() - t0)
    t_a = time.perf_counter() - t0
    counts = ops.launch_counts()
    add(counts)
    rows = pipe.decode_batch(texts[:4], cap, seed)
    n_tok, dec = sum(len(r) for r in rows), pipe.stage_seconds.get("decode", 0.0)
    log(f"  (a) synthesize_stream_batch of 4: {t_a:.3f} s; time to the first chunk per row "
        + ", ".join(f"{first[b]:.3f}" for b in range(4))
        + f" s; stages (s) " + ", ".join(f"{k} {v:.3f}" for k, v in pipe.stage_seconds.items())
        + f"; aggregate decode {n_tok / dec:.1f} tokens/s (B = 4, {n_tok} tokens); launches "
        f"{counts}")
    compared = [hold_stream2(pipe, f"stream batch row {b}", rows[b], got[b], refs[b],
                             [built[b]] + [built[i] for i in range(4) if i != b])
                for b in range(4)]
    log(f"  rows equal their solo streams: tokens, and {compared} chunks within 1e-4 * "
        f"max(1, max|wav|)")
    expect_blocks(counts, 10 * sum(len(c) for c in got.values()), "CosyVoice2 stream batch")

    # (b) the engine: 4 slots, 6 requests; rows 1 and 3 finish first, so
    # requests 4 and 5 join mid-flight; prefetch off, then on
    runs = {}
    for prefetch in (False, True):
        eng = ContinuousBatchEngine(pipe, slots=4, prefix_len=32, max_len=cap, prefetch=prefetch)
        ops.reset_launch_counts()
        try:
            t0 = time.perf_counter()
            reqs = [eng.submit(x, seed=stream_seed(seed, b, 0)) for b, x in enumerate(texts)]
            outs = [list(r.chunks(timeout=600)) for r in reqs]
            t_eng = time.perf_counter() - t0
        finally:
            eng.stop()
        counts = ops.launch_counts()
        add(counts)
        log(f"  (b) engine, 4 slots, prefetch {'on' if prefetch else 'off'}: {len(reqs)} requests "
            f"in {t_eng:.3f} s wall, {eng.segments_run} segments of {eng.seg} attempts, "
            f"{eng.prefetch_hits} prefetch hits; admitted at segments "
            f"{[r.admitted_segment for r in reqs]}; chunks {[len(o) for o in outs]}; "
            f"launches {counts}")
        if sum(1 for r in reqs if r.admitted_segment) < 2:
            raise SystemExit("chip_smoke: fewer than two CosyVoice2 requests joined mid-flight")
        compared = [hold_stream2(pipe, f"engine request {b}", r.tokens.tolist(), o, refs[b],
                                 [built[b]])
                    for b, (r, o) in enumerate(zip(reqs, outs))]
        log(f"  requests equal their solo streams: tokens, and {compared} chunks")
        expect_blocks(counts, 10 * sum(len(o) for o in outs), "CosyVoice2 engine")
        runs[prefetch] = (t_eng, eng.prefetch_hits, [r.tokens.tolist() for r in reqs])
    log(f"  (b) engine prefetch on against off: wall {runs[True][0]:.3f} / {runs[False][0]:.3f} "
        f"s, hits {runs[True][1]} / {runs[False][1]}; tokens identical "
        f"{runs[True][2] == runs[False][2]}")
    if not (runs[True][1] > 0 and runs[False][1] == 0):
        raise SystemExit("chip_smoke: the CosyVoice2 engine's prefetch hits are off")

    # (c) streaming text: 4 chunks of 8 text ids after a prompt of 4 text ids
    # and 30 speech tokens.  Random weights never sample the fill token, so
    # the 15th attempt is made one; after it the reference's own rule forces
    # a fill every mix_ratio[1] + 1 tokens
    rng = np.random.default_rng(seed + 10)
    chunks = [rng.integers(0, lcfg.qwen.vocab_size, (1, 8)) for _ in range(4)]
    prompt_text = rng.integers(0, lcfg.qwen.vocab_size, (1, 4))
    prompt_speech = rng.integers(0, lcfg.speech_token_size, (1, 30))
    fill = lcfg.speech_token_size + 2
    advances = []

    class Recording(Q.Qwen2StreamDecoder):
        def advance(self, emb):
            logits = super().advance(emb)
            advances.append((emb, logits, self.L))
            return logits

    real_sample, calls = Q.ras_sample, []

    def sample(logp, *a, **k):
        calls.append(1)
        return fill if len(calls) == 15 else real_sample(logp, *a, **k)

    real_decoder = Q.Qwen2StreamDecoder
    Q.Qwen2StreamDecoder, Q.ras_sample = Recording, sample
    try:
        t0 = time.perf_counter()
        with torch.inference_mode():
            toks = list(Q.qwen2lm_inference_bistream(
                pipe.llm_p, lcfg, iter(chunks), prompt_text, prompt_speech, capacity=512,
                max_tokens=100, generator=torch.Generator().manual_seed(seed)))
        torch.cuda.synchronize()
        t_c = time.perf_counter() - t0
    finally:
        Q.Qwen2StreamDecoder, Q.ras_sample = real_decoder, real_sample
    emb = torch.cat([e for e, _, _ in advances], dim=1)
    worst = 0.0
    with torch.inference_mode():
        for e, logits, L in advances:
            want = qwen2lm_teacher_forced_logits(pipe.llm_p, lcfg, emb[:, :L], [L], [[]])[0, 0]
            gap = (logits.float() - want.float()).abs().max().item()
            worst = max(worst, gap / (1e-4 * max(1.0, want.float().abs().max().item())))
    log(f"  (c) bistream, 4 text chunks of 8 after a 4-id / 30-token prompt: {len(toks)} speech "
        f"tokens in {t_c:.3f} s ({len(toks) / t_c:.1f} tokens/s), {len(advances)} advances "
        f"over {emb.shape[1]} positions; each advance's logits against "
        f"qwen2lm_teacher_forced_logits: worst gap {worst:.3f} of 1e-4 * max(1, max|logit|)")
    if not (worst <= 1.0 and len(toks) > 4 * 15 and all(0 <= t < fill - 2 for t in toks)):
        raise SystemExit("chip_smoke: the bistream decode is off")

    # (d) the device-resident Qwen2 decode: a segment with no host read, and
    # request 1's card tokens against the CPU decode
    with torch.inference_mode():
        st = pipe._decode_start(texts[:4], cap, seed)
        enqueue_without_sync(st, 20, "(d) Qwen2-0.5B decode, B = 4")
        cpu_p = cpu_weights(pipe.llm_p)
        prefix, mn, mx = built[1]
        t0 = time.perf_counter()
        want = Q.qwen2lm_decode_start(cpu_p, lcfg, prefix.cpu(), [prefix.shape[1]], [mn], [mx],
                                      [pipe._decode_generator(seed, 1)],
                                      **pipe._sampling()).run().tokens[0]
        t_cpu = time.perf_counter() - t0
    log(f"  (d) request 1 decoded on the CPU ({len(want)} tokens in {t_cpu:.1f} s): card tokens "
        f"identical {refs[1][0] == want}")
    check_same_tokens_cv2(pipe, "card decode of request 1 against the CPU", refs[1][0], want,
                          [built[1]], cpu_p=cpu_p)
    return total


def write_clips(d, n, seed):
    """``n`` seeded int16 clips of 0.6-2.0 s at 16, 22.05 and 24 kHz with
    their texts."""
    rng = np.random.default_rng(seed)
    os.makedirs(d)
    for i in range(n):
        sr = (16000, 22050, 24000)[i % 3]
        t = np.arange(int(sr * (0.6 + 0.2 * i))) / sr
        wav = 0.3 * np.sin(2 * np.pi * (110 + 35 * i) * t) + 0.05 * rng.standard_normal(t.size)
        wavfile.write(os.path.join(d, f"clip{i}.wav"), sr, (wav * 32767).astype(np.int16))
        with open(os.path.join(d, f"clip{i}.txt"), "w", encoding="utf-8") as f:
            f.write(f"Clip number {i} reads {3 * i + 1} words aloud.")


def frontend_and_prep(lcfg, fcfg, hcfg, llm, flow, hift, seed=70):
    """Phase 14: the mel frontend, the ONNX extractors, the inference
    frontend and the data preparer on the card.  Returns the launch counts
    of the synthesis from the frontend's dict."""
    log("[14] frontend and data prep on the card")
    rng = np.random.default_rng(seed)
    for kw in ({}, dict(sr=24000, n_fft=1920, hop=480, win=1920)):
        n_fft, hop = kw.get("n_fft", audio.N_FFT), kw.get("hop", audio.HOP_SIZE)
        sr = kw.get("sr", audio.SAMPLE_RATE)
        y = torch.from_numpy((0.3 * rng.standard_normal((4, 2 * sr + 123))).astype(np.float32))
        pad = (n_fft - hop) // 2
        yp = F.pad(F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0], (0, 5 * hop))
        yd, ypd = y.to(DEV), yp.to(DEV)
        for what, fn, x, xd in (("mel_spectrogram", audio.mel_spectrogram, y, yd),
                                ("mel_spectrogram_prepadded", audio.mel_spectrogram_prepadded,
                                 yp, ypd)):
            got, want = fn(xd, **kw).cpu(), fn(x, **kw)
            err, tol = (got - want).abs().max().item(), 1e-4 * max(1.0, want.abs().max().item())
            ms = cuda_ms(lambda: fn(xd, **kw), 10)
            log(f"  {what} {sr} Hz (n_fft {n_fft}, hop {hop}) of (4, {x.shape[1]}) -> "
                f"{tuple(got.shape)} on the card: {ms:.3f} ms (CUDA events); max_abs_err "
                f"against the CPU {err:.3e} (tol {tol:.3e})")
            if got.shape != want.shape or not err <= tol:
                raise SystemExit(f"chip_smoke: {what} on the card disagrees with the CPU")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_frontend_") as tmp:
        cp_mod, cp_data = make_campplus_replica(seed=seed)
        s3_mod, s3_data = make_s3_replica(seed=seed + 1)
        cp_path, s3_path = (os.path.join(tmp, n) for n in ("campplus.onnx",
                                                           "speech_tokenizer_v1.onnx"))
        for path, data in ((cp_path, cp_data), (s3_path, s3_data)):
            with open(path, "wb") as f:
                f.write(data)
        x = torch.from_numpy(rng.standard_normal((1, 300, 80)).astype(np.float32))
        feats = torch.from_numpy(rng.standard_normal((1, 128, 600)).astype(np.float32))
        lens = torch.tensor([530], dtype=torch.int32)
        with torch.no_grad():
            want_cp, want_s3 = cp_mod(x), s3_mod(feats, lens)
        for name, data, feed, want in (("campplus", cp_data, {"x": x}, want_cp),
                                       ("S3", s3_data, {"feats": feats, "feats_length": lens},
                                        want_s3)):
            m, m_cpu = OnnxModel(data, DEV), OnnxModel(data, "cpu")
            got, cpu = m.run(feed)[0], m_cpu.run(feed)[0]
            ms = cuda_ms(lambda: m.run(feed), 5)
            if name == "S3":
                same = [int((got.cpu() == ref).sum()) for ref in (cpu, want)]
                log(f"  {name} replica ({len(data) / 1e6:.2f} MB, {len(m.graph.nodes)} nodes) "
                    f"through compat.onnx on the card: {ms:.3f} ms a run; token ids equal to "
                    f"the CPU run {same[0]}/{want.numel()}, to the torch module {same[1]}/"
                    f"{want.numel()}")
                ok = got.device.type == DEV.type and same == [want.numel()] * 2
            else:
                errs = [(got.cpu() - ref).abs().max().item() for ref in (cpu, want)]
                tol = 1e-4 * max(1.0, want.abs().max().item())
                log(f"  {name} replica ({len(data) / 1e6:.2f} MB, {len(m.graph.nodes)} nodes) "
                    f"through compat.onnx on the card: {ms:.3f} ms a run; max_abs_err against "
                    f"the CPU run {errs[0]:.3e}, the torch module {errs[1]:.3e} (tol {tol:.3e})")
                ok = got.device.type == DEV.type and max(errs) <= tol
            if not ok:
                raise SystemExit(f"chip_smoke: the {name} replica on the card disagrees")

        hop = int(np.prod(hcfg.upsample_rates)) * hcfg.istft_hop_len
        fe = Frontend(tmp, sample_rate=hcfg.sampling_rate, device=DEV)
        how = "the tiktoken vocabulary" if fe.tokenizer is not None else (
            "the byte fallback (no tiktoken vocabulary in the model dir, the reference's own "
            f"rule; tiktoken {'importable' if find_spec('tiktoken') else 'absent'} here)")
        t = np.arange(24000) / 16000
        prompt16 = (0.3 * np.sin(2 * np.pi * 140 * t) + 0.03 * rng.standard_normal(t.size)) \
            .astype(np.float32)
        t0 = time.perf_counter()
        d = fe.frontend_zero_shot("Hello from the card.", "A prompt voice.", prompt16)
        t_fe = time.perf_counter() - t0
        log(f"  Frontend(sample_rate={hcfg.sampling_rate}, device=cuda).frontend_zero_shot of a "
            f"1.5 s 16 kHz prompt in {t_fe:.3f} s: text tokenizer {how}; "
            + ", ".join(f"{k} {tuple(v.shape)}" for k, v in d.items()))
        pipe = TTS2Pipeline(lcfg, fcfg, hcfg, llm, flow, hift, hop_samples=hop)
        P_tok, T_feat = d["flow_prompt_speech_token"].shape[1], d["prompt_speech_feat"].shape[1]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        wav = next(pipe.synthesize(
            d["text"], prompt_text=d["prompt_text"],
            llm_prompt_speech_token=d["llm_prompt_speech_token"],
            flow_prompt_speech_token=d["flow_prompt_speech_token"],
            prompt_feat=d["prompt_speech_feat"], flow_embedding=d["flow_embedding"],
            max_len_cap=50, seed=seed))["tts_speech"]
        t_syn = time.perf_counter() - t0
        counts = ops.launch_counts()
        frames = wav.shape[1] / hop
        n = (frames + T_feat) / 2 - P_tok  # the flow emits 2 (P + n) - T_feat frames
        log(f"  TTS2Pipeline.synthesize from that dict: {t_syn:.3f} s, {int(n)} tokens, "
            f"{wav.shape[1] / hcfg.sampling_rate:.2f} s of audio, stages (s) "
            + ", ".join(f"{k} {v:.3f}" for k, v in pipe.stage_seconds.items())
            + f"; launches {counts}")
        if not (np.isfinite(wav).all() and n == int(n) and 1 <= n <= 50):
            raise SystemExit("chip_smoke: synthesis from the frontend's dict is off")
        expect_blocks(counts, 10, "synthesis from the frontend")

        raw, out = os.path.join(tmp, "raw"), os.path.join(tmp, "data")
        write_clips(raw, 8, seed)
        t0 = time.perf_counter()
        n_rows = prepare_main(["--input", raw, "--output", out, "--speech-tokenizer-onnx",
                               s3_path, "--campplus-onnx", cp_path, "--samples-per-shard", "3",
                               "--device", DEV.type])
        t_prep = time.perf_counter() - t0
        ds = FlowFinetuneDataset(out, augmentation=False)
        batch = next(iter(DataLoader(ds, TrainConfig(batch_size=4, accumulate_grad_batches=1,
                                                     max_feat_len=256), prefetch_depth=0)))
        toks = [t for r in ds.samples for t in r["speech_token"]]
        log(f"  python -m cosy_tpu_torch.data.prepare (its main()) --device cuda on 8 clips with "
            f"the replica graphs: {n_rows} rows in {t_prep:.3f} s, shards "
            f"{sorted(f for f in os.listdir(out) if f.endswith('.parquet'))}; read back: "
            f"{len(ds)} records, one batch "
            + ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items() if hasattr(v, "shape")))
        if n_rows != 8 or len(ds) != 8 or not np.isfinite(batch["speech_feat"]).all() \
                or not 0 <= min(toks) <= max(toks) < 256:
            raise SystemExit("chip_smoke: the data preparer's shards are off")
    return counts


# ---------------------------------------------------------------------------
# phase 15: the user API, multi-voice LoRA serving and the HTTP server
# ---------------------------------------------------------------------------


def expect_voiced(counts, nfe, what):
    """Fail unless ``counts`` show the unfused blocks of a voiced flow: no
    fused block, kernel A alone 64 x ``nfe`` times."""
    if counts["flash_attention"] != 64 * nfe or counts["fused_transformer_block"] != 0 \
            or counts["ln_gemm"] != 0 or counts["block_tail"] != 0 or counts["gemm"] != 0 \
            or counts["layer_norm_rows"] != 0 or counts["banded_attention"] != 0:
        raise SystemExit(f"chip_smoke: {what} launch counts {counts} are not 64 x NFE {nfe} "
                         "standalone kernel A launches with no fused block")


def expect_mixed(counts, base_nfe, voiced_nfe):
    """A batch's flows: fused blocks for its base rows, kernel A alone for
    its voiced rows (A counts inside B as well)."""
    if counts["fused_transformer_block"] != 64 * base_nfe \
            or counts["flash_attention"] != 64 * (base_nfe + voiced_nfe):
        raise SystemExit(f"chip_smoke: the mixed batch's launch counts {counts} are off 64 x "
                         f"NFE {base_nfe} fused blocks and 64 x NFE {voiced_nfe} lone A")


def record_nfe(pipe):
    """Record every NFE ``pipe`` selects (one a flow solve) in the returned list."""
    nfes, select = [], pipe._select_nfe

    def recorded(mel_len):
        nfes.append(select(mel_len))
        return nfes[-1]

    pipe._select_nfe = recorded
    return nfes


def record_tokens(pipe):
    """Record the tokens of every ``pipe.generate_tokens`` call (a
    synthesize's decode) in the returned list."""
    seen, generate = [], pipe.generate_tokens

    def recorded(*a, **kw):
        seen.append(generate(*a, **kw))
        return seen[-1]

    pipe.generate_tokens = recorded
    return seen


def check_finite_wavs(pipe):
    """Wrap ``pipe.token2wav`` so every wav it makes is checked finite (all
    serving routes end there); returns the list of failures."""
    bad, t2w = [], pipe.token2wav

    def checked(*a, **kw):
        wav = t2w(*a, **kw)
        if not np.isfinite(wav).all():
            bad.append(wav.shape)
        return wav

    pipe.token2wav = checked
    return bad


def write_voice(path, llm_p, flow_p, seed):
    """A voice of seeded adapters at LLM_LORA_DEFAULT / FLOW_LORA_DEFAULT,
    B amplified 8x (so voices differ well above rounding), in the
    trainer's adapter-export format."""
    out = {}
    for name, params, cfg, s in (("llm", llm_p, LLM_LORA_DEFAULT, seed),
                                 ("flow", flow_p, FLOW_LORA_DEFAULT, seed + 100)):
        lo = init_lora(torch.Generator(device=DEV).manual_seed(s), params, cfg)
        out.update({f"{name}.{k}": (v * 8.0 if ".lora_B" in k else v).detach().cpu()
                    for k, v in lo.items()})
        out[f"{name}._scaling"] = torch.tensor(cfg.scaling)
    torch.save(out, path)


def voiced_against_merged(vpipe, mpipe, ids, spk, voice, cap, seed):
    """A voiced request against the merged-weights pipeline, same seed:
    tokens by the phase-10 rule (the voiced teacher-forced logits against
    the merged ones at the first diverging step), and the wav within
    1e-4 * max(1, max|wav|) where the tokens are equal.  Returns the voiced
    call's launch counts and NFE."""
    nfes, m_nfes = record_nfe(vpipe), record_nfe(mpipe)
    v_toks, m_toks = record_tokens(vpipe), record_tokens(mpipe)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = next(vpipe.synthesize(ids, spk_embedding=spk, voice=voice, max_len_cap=cap,
                                seed=seed))["tts_speech"]
    t_v = time.perf_counter() - t0
    counts = ops.launch_counts()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    want = next(mpipe.synthesize(ids, spk_embedding=spk, max_len_cap=cap,
                                 seed=seed))["tts_speech"]
    t_m = time.perf_counter() - t0
    m_counts = ops.launch_counts()
    del vpipe._select_nfe, mpipe._select_nfe, vpipe.generate_tokens, mpipe.generate_tokens
    tok_v, tok_m = v_toks[0][0].tolist(), m_toks[0][0].tolist()
    log(f"  voice {voice!r}: {len(tok_v)} tokens in {t_v:.3f} s (unfused blocks, stages "
        + ", ".join(f"{k} {v:.3f}" for k, v in vpipe.stage_seconds.items())
        + f"); merged weights {len(tok_m)} tokens in {t_m:.3f} s (stages "
        + ", ".join(f"{k} {v:.3f}" for k, v in mpipe.stage_seconds.items())
        + f"); voiced launches {counts}; merged launches {m_counts}")
    if not np.isfinite(got).all():
        raise SystemExit(f"chip_smoke: the voiced wav of {voice!r} is not finite")
    expect_voiced(counts, nfes[0], f"voiced call {voice!r}")
    expect_blocks(m_counts, m_nfes[0], f"merged call {voice!r}")
    if tok_v == tok_m:
        err = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
        tol = 1e-4 * max(1.0, float(np.abs(want).max()))
        log(f"  tokens equal; wav max_abs_err against the merged weights {err:.3e} "
            f"(tol {tol:.3e})")
        if not err <= tol:
            raise SystemExit(f"chip_smoke: voice {voice!r} disagrees with its merged weights")
        return counts, nfes[0]
    j = next((i for i, (a, b) in enumerate(zip(tok_v, tok_m)) if a != b),
             min(len(tok_v), len(tok_m)))
    n = min(len(tok_m), j)
    bank, vid, _ = vpipe._voice(voice)
    with torch.inference_mode():
        pv, _, _ = vpipe._build_prefix(ids, None, None, spk, cap, voice)
        pm, _, _ = mpipe._build_prefix(ids, None, None, spk, cap)
        lv = llm_teacher_forced_logits(vpipe.llm_p, vpipe.cfg.llm, pv, [pv.shape[1]],
                                       [tok_m[:n]], lora=bank, vids=[vid],
                                       lora_scale=vpipe._llm_lora_scale)[0, n].float()
        lm = llm_teacher_forced_logits(mpipe.llm_p, mpipe.cfg.llm, pm, [pm.shape[1]],
                                       [tok_m[:n]])[0, n].float()
    gap, tol = (lv - lm).abs().max().item(), 1e-4 * max(1.0, lm.abs().max().item())
    log(f"  tokens diverge from the merged weights' at step {j} of {len(tok_m)}; "
        f"teacher-forced logit gap there {gap:.3e} (tol {tol:.3e})")
    if not gap <= tol:
        raise SystemExit(f"chip_smoke: voice {voice!r} diverges from its merged weights "
                         "beyond rounding")
    return counts, nfes[0]


def write_model_dir(d, cfg, seed):
    """Seeded llm/flow/hift.pt at ``cfg``'s widths beside the replica ONNX
    graphs: a model dir ``CosyVoice(d)`` loads."""
    for name, init, s in (("llm", init_llm_params, seed), ("flow", init_flow_params, seed + 1),
                          ("hift", init_hift_params, seed + 2)):
        m = init(getattr(cfg, name), DEV, seed=s)
        save_torch_checkpoint(m.state_dict(), os.path.join(d, f"{name}.pt"))
        del m
    for fname, (_, data) in (("campplus.onnx", make_campplus_replica(seed=seed)),
                             ("speech_tokenizer_v1.onnx", make_s3_replica(seed=seed + 1))):
        with open(os.path.join(d, fname), "wb") as f:
            f.write(data)


def api_and_serving(cfg, model_dir, seed=80):
    """Phase 15 on a seeded model dir it writes into ``model_dir`` (phase 20
    reads it again).  Returns the launch counts of (a)'s API calls and of
    (b)'s voiced calls."""
    log("[15] the user API, multi-voice LoRA serving and the HTTP server, full width")
    counts_api = {k: 0 for k in ops.launch_counts()}
    counts_voiced = dict(counts_api)
    rng = np.random.default_rng(seed)
    with contextlib.nullcontext(model_dir) as tmp:
        t0 = time.perf_counter()
        write_model_dir(tmp, cfg, seed)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        # the decode cap at 5 tokens a text id keeps the phase short
        api = CosyVoice(tmp, model_cfg=cfg, infer_cfg=InferenceConfig(max_token_text_ratio=5.0),
                        device=DEV)
        log(f"  seeded llm/flow/hift.pt and the replica ONNX graphs written in {t_write:.1f} s; "
            f"CosyVoice(model_dir) on {api.device} in {time.perf_counter() - t0:.1f} s")
        pipe = api.model
        bad = check_finite_wavs(pipe)
        nfes = record_nfe(pipe)
        t = np.arange(24000) / 16000
        prompt16 = (0.3 * np.sin(2 * np.pi * 150 * t) + 0.03 * rng.standard_normal(t.size)) \
            .astype(np.float32)
        src16 = (0.3 * np.sin(2 * np.pi * 220 * t[:20000])
                 + 0.03 * rng.standard_normal(20000)).astype(np.float32)
        api.add_zero_shot_spk("A prompt voice speaking.", prompt16, "prompt_spk")
        text = "Hello from the card."
        calls = (
            ("zero-shot", lambda: api.inference_zero_shot(text, "A prompt voice speaking.",
                                                          prompt16)),
            ("zero-shot streamed", lambda: api.inference_zero_shot(
                "Hello from the card, streamed in windows while the decode goes on.",
                "A prompt voice speaking.", prompt16, stream=True)),
            ("cross-lingual", lambda: api.inference_cross_lingual(text, prompt16)),
            ("instruct", lambda: api.inference_instruct(text, "prompt_spk",
                                                        "Speak slowly and calmly.")),
            ("vc", lambda: api.inference_vc(src16, prompt16)))
        for what, call in calls:
            nfes.clear()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            chunks = [c["tts_speech"] for c in call()]
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            audio_s = sum(c.shape[1] for c in chunks) / api.sample_rate
            log(f"  {what}: {len(chunks)} chunk(s), {audio_s:.2f} s of audio in {wall:.3f} s "
                f"(RTF {wall / max(audio_s, 1e-9):.3f}), flow NFE {nfes}; launches {counts}")
            if not chunks or not all(c.ndim == 2 and c.shape[1] > 0 and np.isfinite(c).all()
                                     for c in chunks):
                raise SystemExit(f"chip_smoke: the API's {what} chunks are empty or not finite")
            expect_blocks(counts, sum(nfes), f"API {what}")
            for k, v in counts.items():
                counts_api[k] += v
        del pipe._select_nfe

        # one prompted flow call on the card against the CPU, the same z
        d = api.frontend.frontend_zero_shot("Hi.", "A prompt voice speaking.", prompt16)
        tok = torch.from_numpy(rng.integers(0, cfg.flow.vocab_size, (1, 40)))
        ptok = torch.as_tensor(d["flow_prompt_speech_token"], dtype=torch.long)
        pfeat = torch.as_tensor(d["prompt_speech_feat"], dtype=torch.float32)
        spk = torch.as_tensor(d["flow_embedding"], dtype=torch.float32)
        T = pfeat.shape[1] + pipe._mel_len(40)
        z = torch.randn((1, 80, T + T % 2), generator=torch.Generator().manual_seed(seed))
        kw = dict(n_timesteps=5, mel_norm=(cfg.mel_mean, cfg.mel_std))
        with torch.inference_mode():
            mel = flow_inference(pipe.flow_p, cfg.flow, tok.to(DEV), ptok.to(DEV),
                                 pfeat.to(DEV), spk.to(DEV), z=z.to(DEV), **kw).cpu()
            p_cpu = P({k: v.cpu() for k, v in pipe.flow_p.d.items()})
            t0 = time.perf_counter()
            mel_cpu = flow_inference(p_cpu, cfg.flow, tok, ptok, pfeat, spk, z=z, **kw)
            cpu_s = time.perf_counter() - t0
        err, tol = (mel - mel_cpu).abs().max().item(), 1e-4 * max(1.0, mel_cpu.abs().max().item())
        log(f"  prompted flow call ({ptok.shape[1]} prompt tokens, {pfeat.shape[1]} prompt "
            f"frames, 40 tokens, NFE 5) on the card against the CPU ({cpu_s:.1f} s): "
            f"max_abs_err {err:.3e} (tol {tol:.3e})")
        if mel.shape != mel_cpu.shape or not err <= tol:
            raise SystemExit("chip_smoke: the prompted flow call disagrees with the CPU")

        # (b) multi-voice: two voices of seeded adapters, loaded as a server does
        paths = []
        for v, s in (("alice", seed + 10), ("bob", seed + 11)):
            paths.append(f"{v}={os.path.join(tmp, f'adapters_{v}.pt')}")
            write_voice(paths[-1].split("=", 1)[1], pipe.llm_p.d, pipe.flow_p.d, s)
        voices, llm_s, flow_s = parse_voices(",".join(paths))
        t0 = time.perf_counter()
        pipe.set_voices(voices, llm_scale=llm_s, flow_scale=flow_s)
        torch.cuda.synchronize()
        n_ad = sum(v.numel() for v in voices["alice"]["llm"].values()) + \
            sum(v.numel() for v in voices["alice"]["flow"].values())
        log(f"  voices {pipe.voice_names} through load_voice_adapters and set_voices in "
            f"{time.perf_counter() - t0:.3f} s: {n_ad / 1e6:.2f} M adapter parameters a voice, "
            f"scales {llm_s} / {flow_s}")
        zero = np.zeros((1, cfg.llm.spk_embed_dim), np.float32)
        ids = api.frontend.extract_text_token("A voiced request.")
        for voice in ("alice", "bob"):
            mods = {}
            for name, cls, mcfg, scale in (("llm", TransformerLM, cfg.llm, llm_s),
                                           ("flow", Flow, cfg.flow, flow_s)):
                params = getattr(pipe, f"{name}_p").d
                mods[name] = cls(mcfg, DEV)
                mods[name].load_state_dict(merge_lora(params, voices[voice][name], scale))
            # the voice's merged weights beside the API's own HiFT
            mpipe = TTSPipeline(cfg, mods["llm"], mods["flow"], SimpleNamespace(p=pipe.hift_p),
                                pipe.icfg, finetuned_norm=True)
            counts, _ = voiced_against_merged(pipe, mpipe, ids, zero, voice, 100, seed + 20)
            for k, v in counts.items():
                counts_voiced[k] += v
            del mods, mpipe
        # where a voiced flow call's time goes: unfused blocks (kernel A
        # alone) against the base weights' fused chain, one call each
        tok = torch.from_numpy(rng.integers(0, cfg.flow.vocab_size, (1, 85))).to(DEV)
        empty_tok, empty_feat = torch.zeros((1, 0), dtype=torch.long, device=DEV), \
            torch.zeros((1, 0, 80), device=DEV)
        spk0 = torch.zeros((1, cfg.flow.spk_embed_dim), device=DEV)
        for what, lora in (("voiced", pipe._voice("alice")[2]), ("base", None)):
            def flow_call():
                flow_inference(pipe.flow_p, cfg.flow, tok, empty_tok, empty_feat, spk0,
                               n_timesteps=10, finetuned_norm=True,
                               mel_norm=(cfg.mel_mean, cfg.mel_std),
                               generator=torch.Generator(device=DEV).manual_seed(seed),
                               lora=lora, lora_scale=flow_s)
            log(f"  where a {what} flow call's time goes (85 tokens, 146 frames, NFE 10), "
                "torch.profiler")
            with torch.inference_mode():
                flow_call()
                wall_ms, busy, by_name = profile_device(flow_call)
                plain_wall = cuda_ms(flow_call, 3)
            log_profile(wall_ms, plain_wall, busy, by_name, top=5)
        texts = [api.frontend.extract_text_token(s) for s in
                 ("First row speaks.", "Second row here.", "A third one.", "Fourth and last.")]
        mixed = ["alice", None, "bob", None]
        nfes, states, decode_batch = record_nfe(pipe), [], pipe._decode_batch
        pipe._decode_batch = lambda *a, **kw: states.append(decode_batch(*a, **kw)) or states[-1]
        ops.reset_launch_counts()
        wavs = pipe.synthesize_batch(texts, [zero] * 4, max_len_cap=100, seed=seed,
                                     voices=mixed)
        counts = ops.launch_counts()
        del pipe._select_nfe, pipe._decode_batch
        with torch.inference_mode():
            tb = pipe._decode_batch(texts, [zero] * 4, 100, seed).run().tokens
        tv = states[0].tokens
        log(f"  synthesize_batch of 4 (voices {mixed}): tokens {[len(x) for x in tv]}, base rows "
            f"equal to the unvoiced batch's: {[tv[b] == tb[b] for b in (1, 3)]}; NFE {nfes}; "
            f"launches {counts}")
        if tv[1] != tb[1] or tv[3] != tb[3] or tv[0] == tb[0]:
            raise SystemExit("chip_smoke: the mixed batch's base rows differ from the unvoiced "
                             "batch, or its voiced row does not")
        if not all(np.isfinite(w).all() and w.shape[1] > 0 for w in wavs):
            raise SystemExit("chip_smoke: the mixed synthesize_batch's wavs are off")
        expect_mixed(counts, nfes[1] + nfes[3], nfes[0] + nfes[2])
        for k, v in counts.items():
            counts_voiced[k] += v
        try:
            next(pipe.synthesize(ids, spk_embedding=zero, voice="nobody"))
        except KeyError as e:
            log(f"  an unknown voice raises: {e}")
        else:
            raise SystemExit("chip_smoke: an unknown voice did not raise")

        # (c) the server over (a)'s API, voices registered, after the warmup
        server = TTSServer(api, batch_window_ms=100.0, engine_slots=4)
        log(f"  warmup (one request of each route) in {warmup(server):.1f} s")
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server, api.sample_rate))
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        threading.Thread(target=httpd.serve_forever, daemon=True).start()

        def post(body, stream=False):
            req = urllib.request.Request(f"{url}/tts", data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            t0, first = time.perf_counter(), None
            with urllib.request.urlopen(req, timeout=300) as r:
                if r.status != 200:
                    raise SystemExit(f"chip_smoke: /tts answered {r.status}")
                if stream:  # the header, then the first PCM piece
                    data = r.read(44)
                    data += r.read1(8192)
                    first = time.perf_counter() - t0
                data = (data if stream else b"") + r.read()
            n = (len(data) - 44) // 2
            if data[:4] != b"RIFF" or n <= 0:
                raise SystemExit(f"chip_smoke: /tts returned no audio for {body}")
            return n / api.sample_rate, time.perf_counter() - t0, first

        try:
            audio_s, wall, _ = post({"text": "A whole request to the server."})
            log(f"  whole request: {audio_s:.2f} s of audio in {wall:.3f} s (RTF "
                f"{wall / audio_s:.3f})")
            audio_s, wall, first = post({"text": "A streamed request to the server.",
                                         "stream": True}, stream=True)
            log(f"  streamed request (engine route): first audio after {first:.3f} s, "
                f"{audio_s:.2f} s of audio in {wall:.3f} s")
            b0 = server.batches_run
            res, t0 = [None] * 4, time.perf_counter()

            def one(i):
                res[i] = post({"text": f"Concurrent request number {i}."})

            threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
            wall4 = time.perf_counter() - t0
            log(f"  4 concurrent whole requests in {wall4:.3f} s wall, "
                f"{server.batches_run - b0} batch(es); audio {[round(r[0], 2) for r in res if r]}")
            if any(r is None for r in res) or not server.batches_run - b0 < 4:
                raise SystemExit("chip_smoke: the concurrent requests did not share a batch")
            audio_s, wall, _ = post({"text": "A voiced request.", "voice": "alice"})
            log(f"  voiced request: {audio_s:.2f} s of audio in {wall:.3f} s")
            c = TTSClient(url, timeout=300)
            wav, sr = c.tts("The client speaks.")
            chunks = list(c.tts_stream("The client streams."))
            log(f"  TTSClient.tts {wav.size / sr:.2f} s at {sr} Hz, tts_stream "
                f"{len(chunks)} pieces, {sum(x.size for x in chunks) / sr:.2f} s; healthz "
                f"{c.healthz()}")
            if sr != api.sample_rate or wav.size == 0 or not chunks or not c.healthz():
                raise SystemExit("chip_smoke: the client round trips failed")
            with urllib.request.urlopen(f"{url}/stats", timeout=60) as r:
                stats = json.loads(r.read())
            with urllib.request.urlopen(f"{url}/metrics", timeout=60) as r:
                metrics = r.read().decode()
            log(f"  /stats requests {stats['requests']} errors {stats['errors']} rtf "
                f"{stats['rtf']} ttfa_s {stats['ttfa_s']} engine {stats.get('engine')}")
            want = {"batched": 7, "stream_engine": 2}
            if stats["requests"] != want or stats["errors"] or \
                    'cosy_tpu_requests_total{route="batched"} 7' not in metrics:
                raise SystemExit(f"chip_smoke: /stats or /metrics off: {stats['requests']}")
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.engine.stop(timeout=60)
        if bad:
            raise SystemExit(f"chip_smoke: the server synthesized non-finite audio {bad}")
        del api, pipe
        torch.cuda.empty_cache()
    return counts_api, counts_voiced


# ---------------------------------------------------------------------------
# phase 16: the other training regimes
# ---------------------------------------------------------------------------


def _smi_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _reset_peak():
    """Restart the peak counter; returns the bytes allocated now (what the
    earlier phases still hold), which :func:`_peak_gib` leaves out."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak_gib(base):
    """GiB at the peak since :func:`_reset_peak`, beyond its ``base``."""
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def _distill_batch(cfg, T, seed, B=2):
    """B seeded utterances of T and T - 30 mel frames (the second padded)
    with ~1/1.72 as many speech tokens: the distiller's batch."""
    rng = np.random.default_rng(seed)
    lens = [T - 30 * i for i in range(B)]
    toks = [int(n / 1.72) for n in lens]
    return {"speech_token": rng.integers(0, cfg.flow.vocab_size, (B, toks[0])).astype(np.int32),
            "speech_token_len": np.asarray(toks, np.int32),
            "speech_feat": (rng.standard_normal((B, T, 80)) * 2 - 6).astype(np.float32),
            "speech_feat_len": np.asarray(lens, np.int32),
            "embedding": rng.standard_normal((B, 192)).astype(np.float32)}


def _flow_s(fn, iters=10):
    """Median seconds of ``fn`` (a flow solve) over ``iters`` calls after a
    warm-up, host clock around each call and a synchronize (the solves are
    host-bound, so single calls vary with the host)."""
    fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def meanflow_phase(cfg, root, seed=90):
    """Phase 16 (a).  Returns (the launches of every MeanFlow synthesis, the
    teacher's launches over the distillation steps)."""
    smi = _smi_line()
    log(f"[16] the other training regimes at full width ({smi}); (a) MeanFlow: distillation "
        "and the few-step sampler")
    base = _reset_peak()
    teacher = init_flow_params(cfg.flow, DEV, seed=1)  # phase 5's flow
    kw = dict(lr=1e-5, teacher_substeps=4, seed=seed)
    integral = FlowDistiller(cfg.flow, teacher, target="integral", **kw)
    jvp = FlowDistiller(cfg.flow, teacher, target="jvp", **kw)
    state = integral.init_state()
    counts_teacher = {k: 0 for k in ops.launch_counts()}
    for i, dist in enumerate((integral,) * 3 + (jvp,)):
        batch = _distill_batch(cfg, 250, seed + i)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        loss = float(dist.step(state, batch))
        sec = time.perf_counter() - t0
        counts = ops.launch_counts()
        calls = 4 if dist.target == "integral" else 1
        log(f"  step {i + 1} ({dist.target} target, B = 2 at 250 / 220 mel frames): loss "
            f"{loss:.5f}, {sec:.3f} s; teacher launches {counts} ({smi})")
        if not np.isfinite(loss):
            raise SystemExit("chip_smoke: a distillation loss is not finite")
        expect_blocks(counts, calls, f"distillation step {i + 1} (the teacher's {calls} "
                      "CFG-batched calls)")
        for k, v in counts.items():
            counts_teacher[k] += v
    log(f"  peak device memory of the distillation {_peak_gib(base):.2f} GiB (torch.cuda."
        f"max_memory_allocated beyond the {base / 2**30:.2f} GiB held before); the student "
        "trains on plain ops, no kernel")
    path = os.path.join(root, "flow_distilled.pt")
    integral.export(state, path)
    flow_d = Flow(cfg.flow, DEV)
    flow_d.load_state_dict(load_torch_checkpoint(path), strict=True)  # adds the branch

    llm, hift = init_llm_params(cfg.llm, DEV, seed=3), init_hift_params(cfg.hift, DEV, seed=4)
    spk = np.zeros((1, 192), np.float32)
    ids = np.random.default_rng(5).integers(0, 256, (1, 16)).astype(np.int64)
    pipe = TTSPipeline(cfg, llm, teacher, hift, InferenceConfig(min_token_text_ratio=12.0))
    with torch.inference_mode():
        tokens = pipe.generate_tokens(ids, spk, 181,
                                      torch.Generator().manual_seed(stream_seed(6, 0, 0)))
    if tokens.shape != (1, 181):
        raise SystemExit(f"chip_smoke: phase 5's decode gave {tokens.shape} tokens")
    counts_mf = {k: 0 for k in ops.launch_counts()}

    def add(counts):
        for k, v in counts.items():
            counts_mf[k] += v

    dev_tok = torch.as_tensor(tokens, device=DEV)
    empty_t, empty_f = torch.zeros((1, 0), dtype=torch.long, device=DEV), torch.zeros((1, 0, 80),
                                                                                       device=DEV)
    spk_t = torch.zeros((1, 192), device=DEV)
    z = torch.randn((1, 80, 312), generator=torch.Generator().manual_seed(seed)).to(DEV)
    cpu_p = P({k: v.cpu() for k, v in flow_d.p.d.items()})
    times = {}
    for steps in (1, 2):
        mpipe = TTSPipeline(cfg, llm, flow_d, hift,
                            InferenceConfig(sampler="meanflow", meanflow_steps=steps))
        ops.reset_launch_counts()
        with torch.inference_mode():
            wav = mpipe.token2wav(tokens, spk, z=z, generator=torch.Generator(
                device=DEV).manual_seed(seed))
        counts = ops.launch_counts()
        add(counts)
        expect_blocks(counts, steps, f"the {steps}-step MeanFlow utterance")
        if wav.shape != (1, 256 * 311) or not np.isfinite(wav).all():
            raise SystemExit("chip_smoke: the MeanFlow utterance is wrong in shape or not finite")

        with torch.inference_mode():
            mel = flow_inference(flow_d.p, cfg.flow, dev_tok, empty_t, empty_f, spk_t,
                                 n_timesteps=steps, finetuned_norm=True, z=z, sampler="meanflow")
            mel_cpu = flow_inference(cpu_p, cfg.flow, dev_tok.cpu(), empty_t.cpu(),
                                     empty_f.cpu(), spk_t.cpu(), n_timesteps=steps,
                                     finetuned_norm=True, z=z.cpu(), sampler="meanflow")
            times[f"meanflow {steps}"] = _flow_s(lambda: flow_inference(
                flow_d.p, cfg.flow, dev_tok, empty_t, empty_f, spk_t, n_timesteps=steps,
                finetuned_norm=True, z=z, sampler="meanflow"))
        err = (mel.cpu() - mel_cpu).abs().max().item()
        scale = mel_cpu.abs().max().item()
        log(f"  {steps}-step MeanFlow utterance of phase 5's 181 tokens (311 mel frames, padded "
            f"312): launches {counts}; mel against the CPU max_abs_err {err:.3e}, max|mel| "
            f"{scale:.3e} (tol 1e-4 * max(1, max|mel|))")
        if not err <= 1e-4 * max(1.0, scale):
            raise SystemExit("chip_smoke: the MeanFlow flow disagrees with the CPU")
    ops.reset_launch_counts()
    with torch.inference_mode():
        times["euler 15"] = _flow_s(lambda: flow_inference(
            teacher.p, cfg.flow, dev_tok, empty_t, empty_f, spk_t, n_timesteps=15,
            finetuned_norm=True, z=z))
    ops.reset_launch_counts()
    log("  flow stage seconds on the same tokens (median of 10 after a warm-up): "
        + ", ".join(f"{k} {v:.4f} s" for k, v in times.items())
        + f"; Euler NFE 15 / MeanFlow 2 steps = {times['euler 15'] / times['meanflow 2']:.2f}x "
        f"({smi})")

    # the inference CLI and the server on a model dir of these weights
    from cosy_tpu_torch.infer.__main__ import main as infer_main
    from cosy_tpu_torch.serve import build_parser, build_server

    mdir = os.path.join(root, "model")
    os.makedirs(mdir)
    for name, m in (("llm", llm), ("flow", teacher), ("hift", hift)):
        save_torch_checkpoint(m.state_dict(), os.path.join(mdir, f"{name}.pt"))
    del pipe, mpipe
    ops.reset_launch_counts()
    infer_main(["--text", "Hello.", "--device", DEV.type, "--pretrained", mdir, "--flow", path,
                "--meanflow", "--meanflow-steps", "2", "--output", os.path.join(root, "mf.wav"),
                "--seed", "5"] + ([] if cfg == ModelConfig() else ["--tiny"]))
    counts = ops.launch_counts()
    add(counts)
    expect_blocks(counts, 2, "python -m cosy_tpu_torch.infer --meanflow")
    log(f"  python -m cosy_tpu_torch.infer --meanflow --meanflow-steps 2 in-process: launches "
        f"{counts}")
    server = build_server(build_parser().parse_args(
        ["--model-dir", mdir, "--device", DEV.type, "--flow-weights", path, "--sampler",
         "meanflow", "--meanflow-steps", "2", "--finetuned-norm", "1"]))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    chunks = list(server.synthesize("Hello from the distilled voice."))
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    add(counts)
    expect_blocks(counts, 2, "TTSServer --sampler meanflow")
    wav = np.concatenate(chunks)
    if not np.isfinite(wav).all() or wav.size == 0:
        raise SystemExit("chip_smoke: the MeanFlow server's audio is empty or not finite")
    log(f"  TTSServer --sampler meanflow --meanflow-steps 2: one request, {wav.size / 22050:.2f} s "
        f"of audio in {wall:.3f} s; launches {counts}")
    with expect_raise(SystemExit, "MeanFlow-distilled"):
        build_server(build_parser().parse_args(["--model-dir", mdir, "--device", DEV.type,
                                                "--flow-weights", path]))
    del server, llm, hift, flow_d, teacher, integral, jvp, state
    torch.cuda.empty_cache()

    return counts_mf, counts_teacher


def meanflow_cv2(root, seed=93):
    """Phase 16 (a), CosyVoice2: two ``--cosyvoice2`` distillation steps at
    ``Flow2Config()`` (the second with the streaming estimator), then the
    first streamed window of ``TTS2Pipeline`` at two MeanFlow steps on the
    export, its mel held to the CPU's.  Returns (the window's launches,
    the teacher's)."""
    smi = _smi_line()
    fcfg, hcfg = Flow2Config(), hift24k_config()
    teacher = init_flow2_params(fcfg, DEV, seed=seed)
    dist = FlowDistiller(fcfg, teacher, lr=1e-5, teacher_substeps=4, family="cv2", seed=seed)
    state = dist.init_state()
    rng = np.random.default_rng(seed)
    lens = [250, 220]
    batch = {"speech_token": rng.integers(0, fcfg.vocab_size, (2, 125)).astype(np.int32),
             "speech_token_len": np.asarray([n // 2 for n in lens], np.int32),
             "speech_feat": (rng.standard_normal((2, 250, 80)) * 2 - 6).astype(np.float32),
             "speech_feat_len": np.asarray(lens, np.int32),
             "embedding": rng.standard_normal((2, 192)).astype(np.float32)}
    counts_teacher = {k: 0 for k in ops.launch_counts()}
    for i in range(2):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        loss = float(dist.step(state, batch))
        sec = time.perf_counter() - t0
        counts = ops.launch_counts()
        log(f"  CosyVoice2 distillation step {i + 1} (integral, streaming "
            f"{'on' if i else 'off'}, B = 2 at 250 / 220 frames): loss {loss:.5f}, {sec:.3f} s; "
            f"teacher launches {counts} ({smi})")
        if not np.isfinite(loss):
            raise SystemExit("chip_smoke: a CosyVoice2 distillation loss is not finite")
        expect_blocks(counts, 4, f"CosyVoice2 distillation step {i + 1}")
        for k, v in counts.items():
            counts_teacher[k] += v
    merged = dist.export(state, os.path.join(root, "flow2_distilled.pt"))
    flow_d = Flow2(fcfg, DEV)
    flow_d.load_state_dict(merged, strict=True)  # adds the branch
    pipe = TTS2Pipeline(Qwen2LMConfig(), fcfg, hcfg, Q.Qwen2LM(Qwen2LMConfig(), "meta"), flow_d,
                        init_hift_params(hcfg, DEV, seed=seed + 1),
                        InferenceConfig(sampler="meanflow", meanflow_steps=2),
                        hop_samples=int(np.prod(hcfg.upsample_rates)) * hcfg.istft_hop_len)
    n = pipe.token_hop_len + fcfg.pre_lookahead_len  # the first window: 25 tokens + lookahead
    tokens = rng.integers(0, fcfg.vocab_size, (1, n))
    spk = rng.standard_normal((1, 192)).astype(np.float32)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        wav, st = pipe.token2wav(tokens, None, None, spk, 0, stream=True, finalize=False,
                                 generator=torch.Generator(device=DEV).manual_seed(seed))
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    expect_blocks(counts, 2, "the CosyVoice2 MeanFlow window")
    if st is None or wav.shape[0] != 1 or wav.size == 0 or not np.isfinite(wav).all():
        raise SystemExit("chip_smoke: the CosyVoice2 MeanFlow window is empty or not finite")
    args = [torch.as_tensor(tokens), torch.zeros((1, 0), dtype=torch.long),
            torch.zeros((1, 0, 80)), torch.as_tensor(spk)]
    kw = dict(streaming=True, finalize=False, n_timesteps=2, sampler="meanflow")
    with torch.inference_mode():
        mel = flow2_inference(flow_d.p, fcfg, *(a.to(DEV) for a in args), **kw).cpu()
        mel_cpu = flow2_inference(P({k: v.cpu() for k, v in flow_d.p.d.items()}), fcfg, *args,
                                  **kw)
    err = (mel - mel_cpu).abs().max().item()
    scale = mel_cpu.abs().max().item()
    log(f"  TTS2Pipeline MeanFlow window (2 steps, streaming estimator, {n} tokens -> "
        f"{mel.shape[2]} mel frames): {wav.shape[1]} samples in {wall:.3f} s; launches {counts}; "
        f"mel against the CPU max_abs_err {err:.3e}, max|mel| {scale:.3e} (tol 1e-4 * max(1, "
        f"max|mel|)) ({smi})")
    if not err <= 1e-4 * max(1.0, scale):
        raise SystemExit("chip_smoke: the CosyVoice2 MeanFlow flow disagrees with the CPU")
    del pipe, flow_d, teacher, dist, state, merged
    torch.cuda.empty_cache()
    return counts, counts_teacher


class expect_raise:
    """``with expect_raise(exc, text):`` fails unless the block raises
    ``exc`` with ``text`` in its message."""

    def __init__(self, exc, text):
        self.exc, self.text = exc, text

    def __enter__(self):
        return self

    def __exit__(self, typ, val, tb):
        if typ is None or not issubclass(typ, self.exc) or self.text not in str(val):
            raise SystemExit(f"chip_smoke: expected {self.exc.__name__} naming {self.text!r}, "
                             f"got {typ.__name__ if typ else 'none'}: {val}")
        return True


def _lm_super(rng, text_vocab, speech_vocab, accum=2, B=4, n_text=30, n_speech=150,
              reject=False):
    """An (accum, B, ...) super-batch of seeded LM rows."""
    sb = {"text_token": rng.integers(0, text_vocab, (accum, B, n_text)).astype(np.int32),
          "text_token_len": np.full((accum, B), n_text, np.int32),
          "speech_token": rng.integers(0, speech_vocab, (accum, B, n_speech)).astype(np.int32),
          "speech_token_len": np.full((accum, B), n_speech, np.int32),
          "embedding": rng.standard_normal((accum, B, 192)).astype(np.float32)}
    if reject:
        sb["reject_speech_token"] = rng.integers(0, speech_vocab, (accum, B, n_speech)).astype(
            np.int32)
        sb["reject_speech_token_len"] = np.full((accum, B), n_speech - 20, np.int32)
    return sb


def _flow_super(rng, vocab, ratio, accum=2, B=4, T=250):
    """An (accum, B, ...) super-batch of seeded flow rows (the last row of
    each micro-batch 50 frames short)."""
    lens = np.full((accum, B), T, np.int32)
    lens[:, -1] = T - 50
    return {"speech_token": rng.integers(0, vocab, (accum, B, T // ratio)).astype(np.int32),
            "speech_token_len": (lens // ratio).astype(np.int32),
            "speech_feat": (rng.standard_normal((accum, B, T, 80)) * 2 - 6).astype(np.float32),
            "speech_feat_len": lens,
            "embedding": rng.standard_normal((accum, B, 192)).astype(np.float32)}


def full_param_phase(root, cfg, lcfg, fcfg, seed=95):
    """Phase 16 (b): two FullTrainer steps for each model at full width, a
    checkpoint at step 2 restored into a new trainer whose third step must
    equal the uninterrupted run's, then the CLI."""
    from cosy_tpu_torch.models import flow as TFM
    from cosy_tpu_torch.models.flow2 import flow2_forward_train
    from cosy_tpu_torch.models.llm import llm_forward_train
    from cosy_tpu_torch.models.qwen2lm import qwen2lm_forward_train
    from cosy_tpu_torch.train.dpo import make_dpo_loss_fn
    from cosy_tpu_torch.train.full_trainer import FullTrainer, adamw

    smi = _smi_line()
    log(f"[16] (b) full-parameter training at full width ({smi}): FullTrainer, AdamW 1e-4, "
        "clip 5, accumulation 2 x batch 4")
    rng = np.random.default_rng(seed)

    def llm_loss(p, g, b):
        out = llm_forward_train(P(p), cfg.llm, b, Ctx(generator=g, train=True))
        return out["loss"], {"acc": out["acc"]}

    def flow_loss(p, g, b):
        return TFM.flow_forward_train(P(p), cfg.flow, g, b, Ctx(generator=g, train=True),
                                      vendored_style=True), {}

    def qwen_loss(p, g, b):
        out = qwen2lm_forward_train(P(p), lcfg, b, Ctx(generator=g, train=True), generator=g)
        return out["loss"], {"acc": out["acc"]}

    def flow2_loss(p, g, b):
        return flow2_forward_train(P(p), fcfg, g, b, Ctx(generator=g, train=True)), {}

    def dpo_loss_fn():
        ref = {k: v.detach() for k, v in init_qwen2lm_params(lcfg, DEV, seed=seed + 2)
               .named_parameters()}
        return ref, make_dpo_loss_fn(lcfg, ref, beta=0.01)

    cases = [
        ("CosyVoice-300M LLM", lambda: init_llm_params(cfg.llm, DEV, seed=seed), llm_loss,
         lambda: _lm_super(rng, cfg.llm.text_token_size, cfg.llm.speech_token_size)),
        ("CosyVoice-300M flow, vendored", lambda: init_flow_params(cfg.flow, DEV, seed=seed + 1),
         flow_loss, lambda: _flow_super(rng, cfg.flow.vocab_size, 2)),
        ("Qwen2-0.5B LM", lambda: init_qwen2lm_params(lcfg, DEV, seed=seed + 2), qwen_loss,
         lambda: _lm_super(rng, lcfg.qwen.vocab_size, lcfg.speech_token_size)),
        ("Flow2Config() flow", lambda: init_flow2_params(fcfg, DEV, seed=seed + 3), flow2_loss,
         lambda: _flow_super(rng, fcfg.vocab_size, fcfg.token_mel_ratio)),
        ("DPO on Qwen2-0.5B", None, None,
         lambda: _lm_super(rng, lcfg.qwen.vocab_size, lcfg.speech_token_size, reject=True)),
    ]
    for name, make, loss_fn, batches in cases:
        ref = None
        base = _reset_peak()
        if make is None:  # DPO: the policy starts from the frozen reference
            ref, loss_fn = dpo_loss_fn()
            params = ref
        else:
            params = {k: v.detach() for k, v in make().named_parameters()}
        sbs = [batches() for _ in range(3)]
        gens = [lambda i=i: torch.Generator(device=DEV).manual_seed(seed + 10 * i)
                for i in range(6)]
        tr = FullTrainer(loss_fn, params, adamw(1e-4), accum=2)
        del params
        ops.reset_launch_counts()
        hist, secs = [], []
        for s in range(2):
            t0 = time.perf_counter()
            hist.append(tr.step(sbs[s], gens[s]()))
            secs.append(time.perf_counter() - t0)
        launches = sum(ops.launch_counts().values())
        peak = _peak_gib(base)
        d = os.path.join(root, "ckpt_" + name.split()[0])
        tr.save_checkpoint(d, keep=2)
        hist.append(tr.step(sbs[2], gens[2]()))  # the uninterrupted third step
        tr.close()
        back = FullTrainer(loss_fn, tr.params, adamw(1e-4), accum=2)
        if back.load_checkpoint(d) != 2:
            raise SystemExit(f"chip_smoke: {name}: the checkpoint is not at step 2")
        back.step(sbs[2], gens[2]())
        worst = max(((back.params[k] - v).abs().max() / v.abs().max().clamp(min=1e-30)).item()
                    for k, v in tr.params.items())
        wall_ms, busy, by_name = profile_device(lambda: back.step(sbs[0], gens[3]()))
        t0 = time.perf_counter()
        back.step(sbs[1], gens[4]())
        plain_ms = (time.perf_counter() - t0) * 1e3
        n_par = sum(v.numel() for v in tr.params.values())
        log(f"  {name}: {n_par / 1e6:.1f} M params; losses "
            + ", ".join(f"{m['loss']:.4f}" for m in hist)
            + f" (grad_norm {hist[0]['grad_norm']:.3f}, skipped {sum(m['skipped'] for m in hist):.0f});"
            f" {secs[0]:.3f} s then {secs[1]:.3f} s a step; peak {peak:.2f} GiB (beyond the "
            f"{base / 2**30:.2f} GiB held before); kernel launches "
            f"{launches}; resumed step 3 against the uninterrupted one: max |dp| / max|p| "
            f"{worst:.2e} (tol 1e-6)")
        log_profile(wall_ms, plain_ms, busy, by_name, top=4)
        if not all(np.isfinite(v) for m in hist for v in m.values()) or launches:
            raise SystemExit(f"chip_smoke: {name}: a metric is not finite or a kernel launched")
        if not worst <= 1e-6:
            raise SystemExit(f"chip_smoke: {name}: the resumed run left the uninterrupted one")
        del tr, back, ref, loss_fn
        torch.cuda.empty_cache()
    full_cli(root, cfg, seed + 5)


def full_cli(root, cfg, seed):
    """python -m cosy_tpu_torch.train.full's main() at full width on 32
    seeded parquet records (the vendored flow, batch 8 x accum 2: 2 steps),
    then --resume for one more step."""
    import pandas as pd

    from cosy_tpu_torch.train import full as full_cli_mod

    recs = _records(32, seed, cfg.flow.vocab_size)
    d = os.path.join(root, "full_cli")
    os.makedirs(d)
    pd.DataFrame(recs).to_parquet(os.path.join(d, "part0.parquet"))
    with open(os.path.join(d, "data.list"), "w") as f:
        f.write(os.path.join(d, "part0.parquet") + "\n")
    out = os.path.join(d, "out")
    argv = ["--model", "flow", "--train_data", os.path.join(d, "data.list"), "--model_dir", out,
            "--batch_size", "8", "--accum", "2", "--log_every", "1", "--shuffle_size", "32",
            "--sort_size", "8", "--device", DEV.type] + ([] if cfg == ModelConfig() else ["--tiny"])
    for extra, step in ((["--max_steps", "2"], 2), (["--max_steps", "1", "--resume"], 3)):
        t0 = time.perf_counter()
        if full_cli_mod.main(argv + extra) != 0:
            raise SystemExit("chip_smoke: python -m cosy_tpu_torch.train.full failed")
        steps = sorted(int(n) for n in os.listdir(os.path.join(out, "ckpt")) if n.isdigit())
        log(f"  python -m cosy_tpu_torch.train.full --model flow {' '.join(extra)}: "
            f"{time.perf_counter() - t0:.2f} s, checkpoints {steps}")
        if steps[-1] != step:
            raise SystemExit(f"chip_smoke: the CLI stopped at step {steps[-1]}, not {step}")
    export = load_torch_checkpoint(os.path.join(out, "flow_epoch0.pt"))
    if not all(torch.isfinite(v).all() for v in export.values()):
        raise SystemExit("chip_smoke: the CLI's export is not finite")


def gan_phase(cfg, seed=99):
    """Phase 16 (c): two HiFiGanTrainer turns at HiFTConfig() against the
    full-width discriminators on 2 clips of 24 576 samples, and the pitch
    tracker native against numpy on 8 clips."""
    from cosy_tpu_torch.models.gan import init_discriminator_params
    from cosy_tpu_torch.ops.f0 import extract_f0, interpolate_f0
    from cosy_tpu_torch.train.gan_trainer import HiFiGanTrainer

    smi = _smi_line()
    n = 24576
    t = np.arange(n) / 22050
    rng = np.random.default_rng(seed)
    clips = [(0.4 * np.sin(2 * np.pi * (110 + 20 * i) * t * (1 + 0.05 * np.sin(3 * t)))
              + 0.01 * rng.standard_normal(n)).astype(np.float32) for i in range(8)]
    extract_f0(clips[0])  # the native build, before the clock
    t0 = time.perf_counter()
    f0s = [extract_f0(c) for c in clips]
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref = [extract_f0(c, native=False) for c in clips]
    numpy_ms = (time.perf_counter() - t0) * 1e3
    agree = np.mean([((a > 0) == (b > 0)).mean() for a, b in zip(f0s, ref)])
    log(f"[16] (c) HiFi-GAN ({smi}): the pitch tracker on 8 clips of {n} samples: native "
        f"{native_ms:.2f} ms, numpy {numpy_ms:.2f} ms ({numpy_ms / native_ms:.1f}x); voicing "
        f"agrees on {agree:.4f} of frames")
    if agree < 0.99:
        raise SystemExit("chip_smoke: the native pitch tracker disagrees with the numpy one")
    speech = np.stack(clips[:2])
    with torch.inference_mode():
        mel = audio.mel_spectrogram(torch.as_tensor(speech, device=DEV)).transpose(1, 2)
    T = mel.shape[1]
    batch = {"speech": speech, "speech_feat": mel.cpu().numpy(),
             "pitch_feat": np.stack([interpolate_f0(f)[:T] for f in f0s[:2]])}
    base = _reset_peak()
    gen = init_hift_params(cfg.hift, DEV, seed=seed)
    disc = init_discriminator_params(DEV, seed=seed + 1)
    tr = HiFiGanTrainer(cfg.hift, gen, disc)
    del gen, disc
    ops.reset_launch_counts()
    for turn in range(2):
        t0 = time.perf_counter()
        m = tr.step(batch, torch.Generator(device=DEV).manual_seed(seed + turn))
        sec = time.perf_counter() - t0
        log(f"  turn {turn + 1} (B = 2, {T} mel frames): {sec:.3f} s; "
            + " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items())))
        if not all(np.isfinite(v) for v in m.values()):
            raise SystemExit("chip_smoke: a GAN loss is not finite")
    launches = sum(ops.launch_counts().values())
    n_gen, n_disc = (sum(v.numel() for v in d.values()) for d in (tr.gen_params, tr.disc_params))
    log(f"  generator {n_gen / 1e6:.1f} M, discriminators {n_disc / 1e6:.1f} M params; peak "
        f"{_peak_gib(base):.2f} GiB (beyond the {base / 2**30:.2f} GiB held before); kernel "
        f"launches {launches}")
    if launches:
        raise SystemExit("chip_smoke: the GAN turns launched a kernel")
    del tr
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 17: training scale-out at a world of one
# ---------------------------------------------------------------------------


def _free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _timed_steps(tr, sbs, gens, n=2):
    """``n`` steps: (metrics, seconds of each)."""
    hist, secs = [], []
    for s in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist.append(tr.step(sbs[s], gens[s]()))
        secs.append(time.perf_counter() - t0)
    return hist, secs


def _rel_param_gap(got, want):
    """max |got - want| over every leaf, over max(1, max|want|)."""
    return max((got[k] - v).abs().max().item() / max(1.0, v.abs().max().item())
               for k, v in want.items())


def scale_out_phase(root, cfg, seed=95):
    """Phase 17: the scale-out paths at a world of one over a real NCCL
    group.  Returns the kernel launches of the phase (there must be none)."""
    import torch.distributed as dist

    from cosy_tpu_torch.models import flow as TFM
    from cosy_tpu_torch.models.llm import llm_forward_train
    from cosy_tpu_torch.parallel import tp as TPM
    from cosy_tpu_torch.parallel.mesh import make_mesh
    from cosy_tpu_torch.train.full_trainer import FullTrainer, adamw
    from cosy_tpu_torch.utils.distributed import all_hosts_agree

    smi = _smi_line()
    t_phase = time.time()
    port = _free_port()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, device_id=DEV if DEV.index is not None
                            else torch.device("cuda", torch.cuda.current_device()))
    ops.reset_launch_counts()
    try:
        mesh = make_mesh(device=DEV)
        agreed = all_hosts_agree(True)
        log(f"[17] training scale-out at a world of one ({smi}): NCCL group of 1 on "
            f"tcp://127.0.0.1:{port}, {mesh}, all_hosts_agree over NCCL -> {agreed}")
        if mesh.shape != {"dp": 1, "seq": 1, "model": 1} or not agreed:
            raise SystemExit("chip_smoke: the world-1 mesh or its agreement is wrong")

        def llm_loss(p, g, b):
            out = llm_forward_train(P(p), cfg.llm, b, Ctx(generator=g, train=True))
            return out["loss"], {"acc": out["acc"]}

        def flow_loss(p, g, b):
            return TFM.flow_forward_train(P(p), cfg.flow, g, b, Ctx(generator=g, train=True),
                                          vendored_style=True), {}

        # phase 16 (b)'s weights, generators and super-batches (its rng order)
        rng = np.random.default_rng(seed)
        lm_sbs = [_lm_super(rng, cfg.llm.text_token_size, cfg.llm.speech_token_size)
                  for _ in range(3)]
        flow_sbs = [_flow_super(rng, cfg.flow.vocab_size, 2) for _ in range(3)]
        gens = [lambda i=i: torch.Generator(device=DEV).manual_seed(seed + 10 * i)
                for i in range(6)]
        cases = (("CosyVoice-300M LLM", lambda: init_llm_params(cfg.llm, DEV, seed=seed),
                  llm_loss, lm_sbs),
                 ("CosyVoice-300M flow, vendored",
                  lambda: init_flow_params(cfg.flow, DEV, seed=seed + 1), flow_loss, flow_sbs))
        log("  (a) FullTrainer(mesh, zero2, tensor_parallel, sequence_parallel) against "
            "FullTrainer() on the same inputs, 2 steps each, AdamW 1e-4, accumulation 2 x batch 4")
        for name, make, loss_fn, sbs in cases:
            params = {k: v.detach() for k, v in make().named_parameters()}
            row = {}
            for kind, kw in (("no mesh", {}),
                             ("mesh", dict(mesh=mesh, zero2=True, tensor_parallel=True,
                                           sequence_parallel=True))):
                base = _reset_peak()
                tr = FullTrainer(loss_fn, params, adamw(1e-4), accum=2, **kw)
                n0 = sum(ops.launch_counts().values())
                hist, secs = _timed_steps(tr, sbs, gens)
                launches = sum(ops.launch_counts().values()) - n0
                peak = _peak_gib(base)
                wall_ms, busy, by_name = profile_device(lambda: tr.step(sbs[2], gens[2]()))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.step(sbs[0], gens[3]())
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                idle = None if busy is None else 1 - busy / plain_ms
                row[kind] = (hist, tr.whole_params() if kind == "mesh" else
                             {k: v.detach() for k, v in tr.params.items()})
                log(f"  {name}, {kind}: losses " + ", ".join(f"{m['loss']:.6f}" for m in hist)
                    + f"; {secs[0]:.3f} s then {secs[1]:.3f} s a step; a profiled step "
                    f"{wall_ms:.1f} ms, device busy "
                    + ("not measured" if busy is None else f"{busy:.1f} ms")
                    + f", idle share "
                    + ("not measured" if idle is None else f"{idle:.3f}")
                    + f" of {plain_ms:.1f} ms unprofiled; peak {peak:.2f} GiB; "
                    f"{sum(n for n, _ in by_name.values())} device kernels a step; kernel "
                    f"wrapper launches {launches}")
                if kind == "mesh":
                    log(f"    the mesh trainer: {TPM.count_sharded(tr.param_specs)} leaves "
                        f"split over model (size 1), ZeRO-2 slices "
                        f"{sum(a is not None for a in tr._zaxis.values())} (dp 1)")
                if launches:
                    raise SystemExit(f"chip_smoke: {name} ({kind}) launched a kernel")
                del tr
                torch.cuda.empty_cache()
            (h0, p0), (h1, p1) = row["no mesh"], row["mesh"]
            loss_gap = max(abs(a["loss"] - b["loss"]) / max(abs(a["loss"]), 1e-30)
                           for a, b in zip(h1, h0))
            p_gap = _rel_param_gap(p1, p0)
            log(f"  {name}: the mesh trainer against no mesh: loss rel gap {loss_gap:.2e} "
                f"(tol 1e-5), parameters max |dp| / max(1, max|p|) {p_gap:.2e} (tol 1e-4)")
            if not all(np.isfinite(m["loss"]) for m in h0 + h1):
                raise SystemExit(f"chip_smoke: {name}: a loss is not finite")
            if not (loss_gap <= 1e-5 and p_gap <= 1e-4):
                raise SystemExit(f"chip_smoke: {name}: the world-1 mesh left the plain trainer")
            del params, row, p0, p1
            torch.cuda.empty_cache()
        preemption_at_world_one(root, cfg, mesh, seed)
        log("  (c) not run: dp, tp, seq or pp above 1 needs more than one card (this machine "
            f"has {torch.cuda.device_count()}; NCCL takes one rank a device); the multi-rank "
            "equalities are held over gloo on the CPU (tests/test_torch_parallel.py)")
    finally:
        dist.destroy_process_group()
    launches = sum(ops.launch_counts().values())
    log(f"  phase 17 took {time.time() - t_phase:.1f} s; kernel wrapper launches {launches}")
    if launches:
        raise SystemExit("chip_smoke: phase 17 launched a kernel")
    return launches


def preemption_at_world_one(root, cfg, mesh, seed):
    """Phase 17 (b): JointTrainer at TrainConfig() over the mesh, fit
    SIGTERM'd after step 2; a fresh trainer resumed from the snapshot."""
    import signal

    tcfg = TrainConfig(max_epochs=1)
    rng = np.random.default_rng(seed + 7)
    B, A, T = tcfg.batch_size, tcfg.accumulate_grad_batches, tcfg.max_feat_len
    n_tok = tcfg.max_token_len
    sbs = [{"text_token": rng.integers(0, 3000, (A, B, 40)).astype(np.int32),
            "text_token_len": rng.integers(20, 41, (A, B)).astype(np.int32),
            "speech_token": rng.integers(0, cfg.llm.speech_token_size, (A, B, n_tok))
            .astype(np.int32),
            "speech_token_len": rng.integers(n_tok // 2, n_tok + 1, (A, B)).astype(np.int32),
            "speech_feat": (rng.standard_normal((A, B, T, 80)) * 2 - 6).astype(np.float32),
            "speech_feat_len": rng.integers(T // 2, T + 1, (A, B)).astype(np.int32),
            "embedding": rng.standard_normal((A, B, 192)).astype(np.float32)} for _ in range(4)]
    llm = init_llm_params(cfg.llm, DEV, seed=seed + 8)
    flow = init_flow_params(cfg.flow, DEV, seed=seed + 9)

    def loader():
        for i, sb in enumerate(sbs[:3]):
            if i == 2:  # after step 2: the notice arrives while step 3 is fetched
                os.kill(os.getpid(), signal.SIGTERM)
            yield sb

    d = os.path.join(root, "preempt")
    tr = JointTrainer(cfg, tcfg, llm, flow, out_dir=d, total_steps=100, mesh=mesh)
    t0 = time.perf_counter()
    state = tr.fit(loader(), log_every=1000)
    fit_s = time.perf_counter() - t0
    snap = os.path.join(d, f"joint_{tcfg.training_mode}_preempt.ckpt.pt")
    t0 = time.perf_counter()
    tr.save_checkpoint(os.path.join(root, "snapshot_timing.ckpt"), state)
    snap_s = time.perf_counter() - t0
    k = state.step
    log(f"  (b) JointTrainer at TrainConfig() (joint, bf16, batch {B} x accum {A}, {T} mel "
        f"frames) over the mesh: SIGTERM after step 2 -> stopped at step {k} after "
        f"{fit_s:.2f} s; snapshot {os.path.basename(snap)} "
        f"{'written' if os.path.exists(snap) else 'MISSING'} ({os.path.getsize(snap) / 2**20 if os.path.exists(snap) else 0:.1f} MiB, "
        f"{snap_s:.3f} s a write); SIGTERM handler restored: "
        f"{signal.getsignal(signal.SIGTERM) is signal.SIG_DFL}")
    if not (3 <= k <= 4 and os.path.exists(snap)):
        raise SystemExit("chip_smoke: the preempted fit did not stop with a snapshot")
    resumed = JointTrainer(cfg, tcfg, llm, flow, out_dir=os.path.join(root, "resumed"),
                           total_steps=100, mesh=mesh)
    back = resumed.load_checkpoint(snap, resumed.init_state(
        torch.Generator(device=DEV).manual_seed(1)))
    after = resumed.fit([sbs[k]], resume=snap, log_every=1000)
    plain = JointTrainer(cfg, tcfg, llm, flow, out_dir=os.path.join(root, "plain"),
                         total_steps=100, mesh=mesh)
    want = plain.fit(sbs[:k + 1], log_every=1000)
    got_l = {f"{n}.{q}": v for n, dd in after.loras.items() for q, v in dd.items()}
    want_l = {f"{n}.{q}": v for n, dd in want.loras.items() for q, v in dd.items()}
    scale = max(v.abs().max().item() for v in want_l.values())
    gap = max((got_l[q] - v).abs().max().item() for q, v in want_l.items()) / scale
    log(f"  resumed at step {back.step}; its step {after.step} against the uninterrupted "
        f"run's step {want.step}: max |dp| / max|p| {gap:.2e} (tol 1e-6)")
    if back.step != k or after.step != k + 1 or want.step != k + 1 or not gap <= 1e-6:
        raise SystemExit("chip_smoke: the resumed run left the uninterrupted one")
    del tr, resumed, plain, llm, flow
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 18: weight-only int8 decode, train-style flow inference, the CNN
# conformer and monotonic alignment search
# ---------------------------------------------------------------------------


def _decode_rate(pipe, cfg, prefix, steps, seed):
    """(tokens a second over ``steps`` decode steps after the prefill, the
    state) of a solo decode with EOS held off, on the pipeline's step
    weights; host clock around the steps and a synchronize."""
    L0 = prefix.shape[1]
    state = TLLM.llm_decode_start(pipe.llm_p, cfg.llm, prefix, [L0], [steps + 1], [steps + 1],
                                  [torch.Generator().manual_seed(seed)], **pipe._sampling(),
                                  step_p=pipe.llm_step_p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state.run()
    torch.cuda.synchronize()
    return steps / (time.perf_counter() - t0), state


def int8_decode_phase(cfg, llm, flow, hift, seed=110):
    """Phase 18 (a): TTSPipeline with int8_decode on and off over one set of
    full-width weights.  Returns nothing; raises on a failed check."""
    smi = _smi_line()
    log(f"[18] int8 decode, train-style flow inference, the CNN conformer, MAS ({smi})")
    pipes = {q: TTSPipeline(cfg, llm, flow, hift, InferenceConfig(int8_decode=q),
                            finetuned_norm=True) for q in (False, True)}
    step_p = pipes[True].llm_step_p
    n8 = count_quantized(step_p.d)
    int8_mb = sum(v.numel() for v in step_p.d.values() if v.dtype == torch.int8) / 2 ** 20
    log(f"  (a) the int8 step view: {n8} int8 weights ({int8_mb:.1f} MiB; six a block at "
        f"{cfg.llm.llm.num_blocks} blocks); the prefill, positional keys and head read f32")
    if n8 != 6 * cfg.llm.llm.num_blocks:
        raise SystemExit(f"chip_smoke: {n8} int8 weights in the decode step's view")
    cpu_p = P({k: v.detach().cpu() for k, v in pipes[False].llm_p.d.items()})
    cpu_step = quantize_decode_step(cpu_p, cfg.llm)
    same = all(torch.equal(cpu_step.d[k], v.cpu()) for k, v in step_p.d.items()
               if v.dtype == torch.int8 or k.endswith("@scale"))
    ids = np.random.default_rng(seed).integers(0, 256, (1, 16)).astype(np.int64)
    spk = np.zeros((1, 192), np.float32)
    with torch.inference_mode():
        prefix, _, _ = pipes[True]._build_prefix(ids, None, None, spk, 201, None)
        L0 = prefix.shape[1]
        feed = [[17, 42]]
        got = llm_teacher_forced_logits(pipes[True].llm_p, cfg.llm, prefix, [L0], feed,
                                        step_p=step_p)[0].float().cpu()
        full = llm_teacher_forced_logits(pipes[False].llm_p, cfg.llm, prefix, [L0],
                                         feed)[0].float().cpu()
        want = llm_teacher_forced_logits(cpu_p, cfg.llm, prefix.cpu(), [L0], feed,
                                         step_p=cpu_step)[0].float()
    gap = (got - want).abs().max().item()
    tol = 1e-4 * max(1.0, want.abs().max().item())
    vs_full = (got[1:] - full[1:]).abs().max().item()
    log(f"  int8 values and scales equal to the CPU's quantization: {same}; step logits on the "
        f"card against the CPU int8 decode: max gap {gap:.3e} (tol 1e-4 x max(1, max|logit|) "
        f"= {tol:.3e}); the f32 decode's steps differ by {vs_full:.3e}, its prefill by "
        f"{(got[0] - full[0]).abs().max().item():.1e}")
    if not (same and gap <= tol and vs_full > tol):
        raise SystemExit("chip_smoke: the int8 decode disagrees with the CPU's or equals the "
                         "f32 decode")
    rates = {}
    with torch.inference_mode():
        for q in (False, True, True, False):  # f32, int8, int8, f32: warm-up, then the pair
            rates.setdefault(q, []).append(_decode_rate(pipes[q], cfg, prefix, 200, seed)[0])
        _decode_rate(pipes[True], cfg, prefix, 50, seed)
        t0 = time.perf_counter()
        _decode_rate(pipes[True], cfg, prefix, 50, seed)
        plain_ms = (time.perf_counter() - t0) * 1e3
        wall_ms, busy, by_name = profile_device(lambda: _decode_rate(pipes[True], cfg, prefix,
                                                                     50, seed))
    log(f"  tokens/s over 200 steps at B = 1 (two runs each, f32 / int8 / int8 / f32): f32 "
        f"{rates[False][0]:.1f} and {rates[False][1]:.1f}, int8 {rates[True][0]:.1f} and "
        f"{rates[True][1]:.1f} (int8 / f32 {rates[True][1] / rates[False][1]:.3f})")
    log("  the int8 decode (prefill + 50 steps) under torch.profiler:")
    log_profile(wall_ms, plain_ms, busy, by_name, top=6)
    t0 = time.time()
    texts = [np.random.default_rng(seed + i).integers(0, 256, (1, 8)) for i in (1, 2)]
    rep = validate_int8_voice(cfg, llm, flow, hift, InferenceConfig(), texts, seeds=(0,),
                              max_len_cap=40)
    log(f"  validate_int8_voice, 2 prompts, cap 40 tokens: agreement min "
        f"{rep['agreement_min']:.4f} mean {rep['agreement_mean']:.4f}, MCD max "
        f"{rep['mcd_db_max']:.4f} dB, per prompt "
        + ", ".join(f"{r['tokens_full']}/{r['tokens_int8']} tokens {r['agreement']:.3f} "
                    f"{r['mcd_db']:.3f} dB" for r in rep["prompts"])
        + f" ({time.time() - t0:.1f} s)")


def train_style_flow_phase(cfg, flow, seed=112):
    """Phase 18 (b): flow_inference_like_training at FlowConfig() with a 3 s
    prompt mel, z injected, against the CPU.  Returns its launch counts."""
    rng = np.random.default_rng(seed)
    n_tok, nfe, T_prompt = 169, 4, int(3 * 22050 / 256)
    T = int(n_tok / cfg.flow.input_frame_rate * 22050 / 256)
    tok = torch.as_tensor(rng.integers(0, cfg.flow.vocab_size, (1, n_tok)), device=DEV)
    pfeat = torch.as_tensor((rng.standard_normal((1, T_prompt, 80)) * 2 - 6).astype(np.float32),
                            device=DEV)
    spk = torch.as_tensor(rng.standard_normal((1, 192)).astype(np.float32), device=DEV)
    z = torch.randn((1, 80, T + T % 2), generator=torch.Generator(device=DEV).manual_seed(seed),
                    device=DEV)
    args = (cfg.flow, tok, T, spk, pfeat, T_prompt)
    with torch.inference_mode():
        flow_inference_like_training(flow.p, *args, n_timesteps=nfe, z=z)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mel = flow_inference_like_training(flow.p, *args, n_timesteps=nfe, z=z)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        cpu_p = P({k: v.detach().cpu() for k, v in flow.p.d.items()})
        t0 = time.time()
        want = flow_inference_like_training(cpu_p, cfg.flow, tok.cpu(), T, spk.cpu(),
                                            pfeat.cpu(), T_prompt, n_timesteps=nfe, z=z.cpu())
        cpu_s = time.time() - t0
    err = (mel.cpu() - want).abs().max().item()
    tol = 2e-4 * max(1.0, want.abs().max().item())
    log(f"  (b) flow_inference_like_training: {n_tok} tokens regulated to {T} frames (odd: "
        f"padded, masked), the first {T_prompt} (3 s) conditioned on a prompt mel, NFE {nfe}, "
        f"z injected: mel {tuple(mel.shape)} in {secs:.3f} s on the card ({cpu_s:.1f} s on the "
        f"CPU); max gap to the CPU {err:.3e} (tol 2e-4 x max(1, max|mel|) = {tol:.3e}); "
        f"launches {counts}")
    expect_blocks(counts, nfe, "[18]b flow_inference_like_training")
    if mel.shape != (1, 80, T) or not torch.isfinite(mel).all() or err > tol:
        raise SystemExit("chip_smoke: train-style flow inference disagrees with the CPU")
    return counts


def cnn_encoder_and_mas_phase(cfg, seed=114):
    """Phase 18 (c): a conformer with the CNN module at the 300M text
    encoder's widths against the CPU, then monotonic alignment search on
    the host (native against numpy)."""
    ecfg = dataclasses.replace(cfg.llm.text_encoder, use_cnn_module=True, cnn_module_kernel=15)
    spec = Spec()
    init_encoder(spec, "", ecfg, conformer=True)
    params = spec_tensors(spec, DEV, torch.Generator(device=DEV).manual_seed(seed))
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    x = torch.randn((2, 80, ecfg.input_size), generator=gen, device=DEV)
    lens = torch.tensor([80, 53], device=DEV)
    with torch.inference_mode():
        y, _ = encoder_forward(P(params), ecfg, x, lens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, _ = encoder_forward(P(params), ecfg, x, lens)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        want, _ = encoder_forward(P({k: v.cpu() for k, v in params.items()}), ecfg, x.cpu(),
                                  lens.cpu())
    y = y.cpu()
    err = max((y[0] - want[0]).abs().max().item(), (y[1, :53] - want[1, :53]).abs().max().item())
    tol = 2e-4 * max(1.0, want.abs().max().item())
    log(f"  (c) conformer with the CNN module (kernel 15, LayerNorm) at the text encoder's "
        f"widths ({ecfg.input_size} -> {ecfg.output_size}, {ecfg.num_blocks} blocks), B = 2 of "
        f"80 / 53 frames: {ms:.2f} ms on the card, max gap to the CPU over the valid rows "
        f"{err:.3e} (tol 2e-4 x max(1, max|y|) = {tol:.3e})")
    if not (torch.isfinite(y).all() and err <= tol):
        raise SystemExit("chip_smoke: the CNN conformer disagrees with the CPU")
    rng = np.random.default_rng(seed + 2)
    value = rng.standard_normal((4, 200, 1000)).astype(np.float32)
    t_xs, t_ys = np.array([200, 180, 150, 120]), np.array([1000, 900, 800, 700])
    maximum_path(value[:1, :4, :8], t_xs[:1] * 0 + 4, t_ys[:1] * 0 + 8)  # the g++ build
    t0 = time.perf_counter()
    path = maximum_path(value, t_xs, t_ys)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plain = maximum_path(value, t_xs, t_ys, native=False)
    numpy_ms = (time.perf_counter() - t0) * 1e3
    ok = np.array_equal(path, plain) and all(
        (path[b, :, :t_ys[b]].sum(0) == 1).all() for b in range(4))
    log(f"  maximum_path (4, 200, 1000) on the host: native {native_ms:.1f} ms, numpy "
        f"{numpy_ms:.1f} ms ({numpy_ms / native_ms:.0f}x), paths equal {ok}")
    if not ok:
        raise SystemExit("chip_smoke: the native MAS disagrees with the numpy DP")


def new_modules_phase(cfg, seed=110):
    """Phase 18 on one set of seeded full-width weights.  Returns the
    launch counts of (b)."""
    t0 = time.time()
    llm = init_llm_params(cfg.llm, DEV, seed=seed)
    flow = init_flow_params(cfg.flow, DEV, seed=seed + 1)
    hift = init_hift_params(cfg.hift, DEV, seed=seed + 2)
    int8_decode_phase(cfg, llm, flow, hift, seed)
    counts = train_style_flow_phase(cfg, flow, seed + 2)
    del llm, flow, hift
    torch.cuda.empty_cache()
    cnn_encoder_and_mas_phase(cfg, seed + 4)
    log(f"  phase 18 took {time.time() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 19: the estimator's ONNX export, a profiler trace, the library
# cache, the ASR decoders and conv subsamplings, dynamic chunks, the cost
# model's share of the peak
# ---------------------------------------------------------------------------

# a child of phase 19 (c): builds or loads every library in the cache
# directory argv[1] and runs one estimator call, saved to argv[2]; argv[3]
# "warm" makes any compiler start fail
AOT_CHILD = r"""
import json, subprocess, sys, time
t_start = time.time()
cache, out, warm = sys.argv[1], sys.argv[2], sys.argv[3] == "warm"
import torch
from cosy_tpu_torch import native
from cosy_tpu_torch.config import ModelConfig
from cosy_tpu_torch.layers.unet import conditional_decoder
from cosy_tpu_torch.models.flow import init_flow_params
from cosy_tpu_torch.ops import _cuda, launch_counts
from cosy_tpu_torch.utils import aot

if warm:
    def no_compiler(*a, **k):
        raise AssertionError(f"a compiler started on a warm start: {a[:1]}")
    subprocess.Popen = subprocess.run = no_compiler
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
aot.set_cache_dir(cache)
t0 = time.time()
libs = _cuda.build() + [native.build("mas"), native.build("f0")]
build_s = time.time() - t0
cfg = ModelConfig()
est = init_flow_params(cfg.flow, "cuda", seed=int(sys.argv[4])).p.sub("decoder.estimator")
g = torch.Generator(device="cuda").manual_seed(5)
x, mu, cond = (torch.randn(2, 80, 312, device="cuda", generator=g) for _ in range(3))
mask = torch.ones(2, 1, 312, device="cuda")
mask[:, :, 311:] = 0.0
with torch.inference_mode():
    y = conditional_decoder(est, cfg.flow.estimator, x, mask, mu,
                            torch.rand(2, device="cuda", generator=g),
                            torch.randn(2, 80, device="cuda", generator=g), cond)
torch.cuda.synchronize()
torch.save(y.cpu(), out)
print(json.dumps({"build_s": build_s, "stats": dict(aot.AOT_STATS), "wall_s": time.time() - t_start,
                  "libs": [p.name for p in libs],
                  "blocks": launch_counts()["fused_transformer_block"]}))
"""


def onnx_export_phase(cfg, flow, root, B=2, T=256):
    """[19] (a): export_flow_estimator_onnx with its own check on the card
    (the graph through the port's executor against the estimator's kernels).
    Returns the launch counts of the export call."""
    path = os.path.join(root, "estimator.onnx")
    params = dict(flow.named_parameters())
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    export_flow_estimator_onnx(params, cfg, path, B=B, T=T)
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    with open(path, "rb") as f:
        data = f.read()
    est = {k[len("decoder.estimator."):]: v for k, v in params.items()
           if k.startswith("decoder.estimator.")}
    gap = verify_estimator_onnx(data, est, cfg.flow.estimator, B, T, DEV)
    log(f"  (a) export_flow_estimator_onnx at B = {B}, T = {T}: {len(data) / 2 ** 20:.1f} MiB, "
        f"{secs:.2f} s with its check on the card (the graph through compat.onnx against the "
        f"estimator's kernels); max |graph - estimator| {gap:.3e} (tol 5e-3); launches {counts}")
    expect_blocks(counts, 1, "[19]a the export's check")
    if gap > 5e-3:
        raise SystemExit("chip_smoke: the exported estimator graph disagrees with the estimator")
    return counts


def trace_phase(est, ecfg, root, T=312):
    """[19] (b): profiling.trace around one estimator call at phase 6's
    shape; the trace must name kernels A, B1 and B2 and the annotated
    scope.  Then (f): the cost model's flops over the call's device busy
    time."""
    args = estimator_args(T, True)
    log_dir = os.path.join(root, "trace")
    with torch.inference_mode():
        conditional_decoder(est, ecfg, *args)
        ops.reset_launch_counts()
        with profiling.trace(log_dir) as path:
            with profiling.annotate("cosy_estimator_call"):
                conditional_decoder(est, ecfg, *args)
        counts = ops.launch_counts()
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    found = {what: sum(key in n for n in names) for what, key in (
        ("A flash_attention_kernel", "flash_attention_kernel"),
        ("B1 ln_gemm_kernel", "ln_gemm_kernel"),
        ("B2 block_tail_kernel", "block_tail_kernel"),
        ("scope cosy_estimator_call", "cosy_estimator_call"))}
    log(f"  (b) profiling.trace of one estimator call (B = 2, T = {T}, valid {T - 1}): "
        f"{os.path.getsize(path) / 2 ** 20:.2f} MiB, {len(names)} events; events naming "
        + ", ".join(f"{k} {v}" for k, v in found.items()) + f"; launches {counts}")
    expect_blocks(counts, 1, "[19]b the traced call")
    if min(found.values()) == 0:
        raise SystemExit("chip_smoke: the trace does not name kernels A, B1, B2 and the scope")
    with torch.inference_mode():
        _, busy, _ = profile_device(lambda: conditional_decoder(est, ecfg, *args))
    flops = costs.estimator_call_flops(ecfg, 2, T).total
    if busy is None:
        log(f"  (f) {flops / 1e9:.2f} GFLOP a call (costs.estimator_call_flops); device busy "
            "not measured (the profiler recorded no device events)")
        return
    log(f"  (f) costs.estimator_call_flops(B = 2, T = {T}) = {flops / 1e9:.3f} GFLOP over "
        f"{busy:.3f} ms of device busy time: {flops / busy / 1e9:.2f} TFLOP/s achieved, "
        f"{100 * flops / busy / 1e-3 / costs.H100_F32_FLOPS:.1f}% of the H100's f32 peak "
        f"{costs.H100_F32_FLOPS / 1e12:.0f} TFLOP/s (published, not measured; TF32 tensor "
        f"cores {costs.H100_TF32_FLOPS / 1e12:.0f})")


def aot_cache_phase(root, seed=120):
    """[19] (c): serve --aot-cache's build cache in a fresh 0700 directory:
    a child that builds every library (cold), a second that loads them all
    (warm, no compiler), each running one estimator call; the two outputs
    equal."""
    cache = os.path.join(root, "aot")
    os.makedirs(cache, mode=0o700)
    runs = {}
    for kind in ("cold", "warm"):
        out = os.path.join(root, f"aot_{kind}.pt")
        t0 = time.time()
        res = subprocess.run([sys.executable, "-c", AOT_CHILD, cache, out, kind, str(seed)],
                             cwd=os.path.dirname(os.path.abspath(__file__)),
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise SystemExit(f"chip_smoke: the {kind} --aot-cache child failed:\n"
                             f"{res.stdout[-4000:]}{res.stderr[-4000:]}")
        info = json.loads(res.stdout.strip().splitlines()[-1])
        info["seconds"] = time.time() - t0
        runs[kind] = (info, torch.load(out))
        log(f"  (c) {kind} start with --aot-cache: {info['seconds']:.1f} s in all (process start "
            f"to exit), libraries ready in {info['build_s']:.2f} s, {info['stats']}, "
            f"{info['blocks']} fused blocks in its estimator call; {info['libs']}")
    (cold, y_cold), (warm, y_warm) = runs["cold"], runs["warm"]
    same = torch.equal(y_cold, y_warm)
    log(f"  (c) the two estimator outputs are equal: {same}")
    n = len(cold["libs"])
    if not (cold["stats"] == {"hits": 0, "misses": n} and warm["stats"] == {"hits": n, "misses": 0}
            and same and cold["blocks"] == warm["blocks"] == 64):
        raise SystemExit("chip_smoke: --aot-cache did not build cold and load warm")


def asr_and_subsampling_phase(seed=122):
    """[19] (d): the ASR decoder and bi-decoder at DecoderConfig's defaults
    (encoder 512, vocab 4096), B = 2 of 200 source frames and 50 target
    tokens, and the four conv subsamplings (80 -> 512) on 1000 mel frames,
    each against the CPU within 1e-4 x max(1, max|y|)."""
    dcfg = DecoderConfig(vocab_size=4096, encoder_output_size=512)
    spec = init_bi_transformer_decoder(Spec(), dcfg, r_num_blocks=3)
    params = spec_tensors(spec, DEV, torch.Generator(device=DEV).manual_seed(seed))
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    memory = torch.randn(2, 200, 512, device=DEV, generator=gen)
    mlen = torch.tensor([200, 151], device=DEV)
    ys = torch.randint(0, 4096, (2, 50), device=DEV, generator=gen)
    ylen = torch.tensor([50, 37], device=DEV)
    rys = ys.flip(1)
    cpu = P({k: v.cpu() for k, v in params.items()})

    def valid(y):  # the logits of the valid targets
        return torch.cat([y[0], y[1, :37]])

    checks = []
    with torch.inference_mode():
        for what, fn in (
                ("TransformerDecoder (6 blocks), valid rows", lambda p, *a: valid(
                    transformer_decoder_forward(p.sub("left_decoder"), dcfg, *a[:4])[0])),
                ("BiTransformerDecoder (6 + 3 blocks, reverse 0.3), left and right valid rows",
                 lambda p, *a: torch.cat([valid(y) for y in bi_transformer_decoder_forward(
                     p, dcfg, *a, reverse_weight=0.3, r_num_blocks=3)[:2]]))):
            args = (memory, mlen, ys, ylen, rys)
            y = fn(P(params), *args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = fn(P(params), *args)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            want = fn(cpu, *(a.cpu() for a in args))
            checks.append((what, y.cpu(), want, ms, tuple(y.shape)))
        x = torch.randn(2, 1000, 80, device=DEV, generator=gen)
        mask = torch.ones(2, 1, 1000, dtype=torch.bool, device=DEV)
        mask[1, :, 811:] = False
        for kind, (fn, rate, _) in SUBSAMPLE_RATES.items():
            sp = spec_tensors(init_conv_subsampling(Spec(), "", kind, 80, 512), DEV,
                              torch.Generator(device=DEV).manual_seed(seed + 2))
            y, m = fn(P(sp), x, mask)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, m = fn(P(sp), x, mask)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            want, want_m = fn(P({k: v.cpu() for k, v in sp.items()}), x.cpu(), mask.cpu())
            if not torch.equal(m.cpu(), want_m):
                raise SystemExit(f"chip_smoke: the {kind} subsampling's mask differs from the CPU")
            checks.append((f"subsampling {kind} (rate {rate})", y.cpu(), want, ms, tuple(y.shape)))
    for what, got, want, ms, shape in checks:
        err = (got - want).abs().max().item()
        tol = 1e-4 * max(1.0, want.abs().max().item())
        log(f"  (d) {what}: {shape} in {ms:.2f} ms on the card; max gap to the CPU {err:.3e} "
            f"(tol 1e-4 x max(1, max|y|) = {tol:.3e})")
        if not (torch.isfinite(got).all() and err <= tol):
            raise SystemExit(f"chip_smoke: {what} disagrees with the CPU")


def dynamic_chunk_phase(T=250, n=200, seed=124):
    """[19] (e): ``n`` dynamic-chunk draws on the card (T = 250, the
    training crop), each a valid reference mask for its recovered (chunk,
    num_left); the draws visit full context, small chunks and left limits."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    pos = np.arange(T)
    seen = {"full context": 0, "chunk <= 25": 0, "left-limited": 0}
    for _ in range(n):
        m = add_optional_chunk_mask(T, torch.ones(1, 1, T, dtype=torch.bool, device=DEV), True,
                                    True, 0, 0, -1, generator=gen)[0].cpu().numpy()
        if m.all():
            chunk, nleft = T, -1
        else:
            chunk = int(m[0].sum())
            first = int(np.argmax(m[T - 1]))
            nleft = -1 if first == 0 else (T - 1) // chunk - first // chunk
        want = pos[None, :] < ((pos // chunk + 1) * chunk)[:, None]
        if nleft >= 0:
            want &= pos[None, :] >= np.maximum((pos // chunk - nleft) * chunk, 0)[:, None]
        if not np.array_equal(m, want) or (chunk != T and not 1 <= chunk <= 25):
            raise SystemExit(f"chip_smoke: a dynamic-chunk draw ({chunk}, {nleft}) on the card "
                             "is not a reference mask")
        seen["full context" if chunk == T else "chunk <= 25"] += 1
        seen["left-limited"] += nleft >= 0
    log(f"  (e) {n} dynamic-chunk draws on the card at T = {T}: every one a reference mask; "
        f"{seen}")
    if min(seen.values()) == 0:
        raise SystemExit("chip_smoke: the dynamic-chunk draws missed full context, small chunks "
                         "or left limits")


def export_and_tools_phase(cfg, seed=120):
    """Phase 19.  Returns the launch counts of (a)'s export."""
    t0 = time.time()
    log(f"[19] the estimator's ONNX export, a profiler trace, --aot-cache, the ASR decoders and "
        f"conv subsamplings, dynamic chunks, the cost model ({_smi_line()})")
    flow = init_flow_params(cfg.flow, DEV, seed=seed)
    est = P(dict(flow.named_parameters())).sub("decoder.estimator")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as root:
        counts = onnx_export_phase(cfg, flow, root)
        trace_phase(est, cfg.flow.estimator, root)
        del flow, est
        torch.cuda.empty_cache()
        aot_cache_phase(root, seed)
    asr_and_subsampling_phase(seed + 2)
    dynamic_chunk_phase(seed=seed + 4)
    log(f"  phase 19 took {time.time() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 20: serve --tp over two ranks on the one card
# ---------------------------------------------------------------------------

TP_CHILD = r"""
import json, os, sys, time
t_start = time.time()
root, model_dir, rank, port, http_port = sys.argv[1], sys.argv[2], int(sys.argv[3]), *sys.argv[4:6]
os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                  MASTER_PORT=port)
import numpy as np
import torch
import torch.distributed as dist
from cosy_tpu_torch import ops, serve
from cosy_tpu_torch.config import ModelConfig
from cosy_tpu_torch.models.flow import flow_inference
from cosy_tpu_torch.models.llm import llm_teacher_forced_logits
from cosy_tpu_torch.parallel import tp as TP

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.cuda.set_device(0)
# two ranks on one card: NCCL refuses that, so this script makes a gloo group
# (CUDA tensors) before it calls into the port, which joins it
dist.init_process_group("gloo", rank=rank, world_size=2)
inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
cfg = ModelConfig()
# serve.main's steps, with (a), (b) and (d) on the built server's split
# pipeline before it serves.  The MeanFlow sampler (the model dir's flow with
# its time branch: 2 estimator calls a request) keeps each request's flow to
# 2 x 384 split products
args = serve.build_parser().parse_args([
    "--model-dir", model_dir, "--tp", "2", "--port", http_port, "--engine-slots", "2",
    "--sampler", "meanflow", "--flow-weights", os.path.join(root, "flow_meanflow.pt")])
serve.refuse_queued_flags(args)
tp = serve.start_tp(args)
server = serve.build_server(args, tp)
pipe, dev = server.api.model, tp.mesh.device
views = (pipe.llm_p, pipe.flow_p)  # each carries its layout (P.split)
nbytes = lambda p, whole: sum(v.numel() * v.element_size() * (2 if whole and k in p.split.layout
                                                             else 1) for k, v in p.d.items())
res = {"rank": rank, "device": str(dev), "backend": dist.get_backend(),
       "whole_bytes": [nbytes(p, True) for p in views],
       "local_bytes": [nbytes(p, False) for p in views],
       "split": [sum(k in p.split.layout for k in p.d) for p in views],
       "layout_split": sum(TP.count_sharded(p.split.layout) for p in views)}
spk = np.zeros((1, 192), np.float32)
# (a) the solo decode (after a 4-token one that warms up), and the logits
# along the world-one tokens where the two diverge
for cap in (4, inp["cap"]):
    torch.cuda.synchronize()
    t = time.perf_counter()
    toks = pipe.generate_tokens(inp["ids"], spk, cap, torch.Generator().manual_seed(inp["seed"]))
    torch.cuda.synchronize()
    res["decode_s"] = time.perf_counter() - t
res["tokens"] = [int(x) for x in toks[0]]
if res["tokens"] != inp["want"]:
    with torch.inference_mode():
        prefix, _, _ = pipe._build_prefix(inp["ids"], None, None, spk, inp["cap"])
        res["logits"] = llm_teacher_forced_logits(pipe.llm_p, cfg.llm, prefix, [prefix.shape[1]],
                                                  [inp["want"]])[0].float().cpu()
# (b) one flow call at phase 5's shape with the Euler sampler (the time
# branch unused), z injected, counted: each block gathers its split weights
# and runs the kernel chain
kw = dict(n_timesteps=inp["nfe"], z=inp["z"].to(dev), finetuned_norm=True,
          mel_norm=(cfg.mel_mean, cfg.mel_std))
with torch.inference_mode():
    args_f = (pipe.flow_p, cfg.flow, inp["flow_tokens"].to(dev),
              torch.zeros((1, 0), dtype=torch.long, device=dev),
              torch.zeros((1, 0, 80), device=dev), torch.zeros((1, 192), device=dev))
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    mel = flow_inference(*args_f, **kw)
    torch.cuda.synchronize()
    res["flow_s"] = time.perf_counter() - t
    res["flow_counts"] = ops.launch_counts()
res["mel"] = mel.cpu()
torch.save(res, os.path.join(root, f"rank{rank}.pt"))
del mel
# (c) the server: rank 0 serves on http_port until SIGTERM, rank 1 follows
t = time.time()
res_main = serve.serve(server, args, tp)
dist.destroy_process_group()
print(json.dumps({"main": res_main, "serve_s": time.time() - t, "wall_s": time.time() - t_start}))
"""


def tp_serving_phase(cfg, model_dir, seed=80, cap=60, n_ids=16):
    """[20]: serve --tp 2 at full width over two ranks on the one card, one
    child process each over a gloo group with CUDA tensors (the port's
    collectives as NCCL would run them across cards, by way of the host):
    (a) a solo decode to ``cap`` tokens against the world-one decode, (b) a
    flow call at phase 5's shape with z injected (the kernel chain B1 -> A
    -> B2 64 x NFE times, on each block's all-gathered weights) against the
    world-one flow, (c) the server through
    TTSClient (its flows MeanFlow's two calls: gloo's copies through the
    host make each split product ~2.6 ms on the card), then SIGTERM, (d)
    each rank's weight bytes.  Returns rank 0's launches of (b)."""
    log("[20] serve --tp 2 at full width: two ranks on the one card over gloo (CUDA tensors)")
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as root:
        d = model_dir  # phase 15's seeded model dir
        rng = np.random.default_rng(seed + 40)
        ids = rng.integers(0, 256, (1, n_ids)).astype(np.int64)
        T_mel, nfe = 311, 15
        inp = {"ids": ids, "cap": cap, "seed": seed + 41, "nfe": nfe,
               "flow_tokens": torch.from_numpy(rng.integers(0, cfg.flow.vocab_size, (1, 181))),
               "z": torch.randn((1, 80, T_mel + 1), generator=torch.Generator().manual_seed(seed))}
        api = CosyVoice(d, model_cfg=cfg, device=DEV)
        pipe = api.model
        spk = np.zeros((1, 192), np.float32)
        torch.cuda.synchronize()
        t = time.perf_counter()
        want = pipe.generate_tokens(ids, spk, cap, torch.Generator().manual_seed(inp["seed"]))
        torch.cuda.synchronize()
        one_decode_s = time.perf_counter() - t
        inp["want"] = want = [int(x) for x in want[0]]
        with torch.inference_mode():
            prefix, _, _ = pipe._build_prefix(ids, None, None, spk, cap)
            one_logits = llm_teacher_forced_logits(pipe.llm_p, cfg.llm, prefix, [prefix.shape[1]],
                                                   [want])[0].float().cpu()
            args = (pipe.flow_p, cfg.flow, inp["flow_tokens"].to(DEV),
                    torch.zeros((1, 0), dtype=torch.long, device=DEV),
                    torch.zeros((1, 0, 80), device=DEV), torch.zeros((1, 192), device=DEV))
            kw = dict(n_timesteps=nfe, z=inp["z"].to(DEV), finetuned_norm=True,
                      mel_norm=(cfg.mel_mean, cfg.mel_std))
            torch.cuda.synchronize()
            t = time.perf_counter()
            mel_one = flow_inference(*args, **kw).cpu()
            one_flow_s = time.perf_counter() - t
        del api, pipe
        torch.cuda.empty_cache()
        torch.save(inp, os.path.join(root, "inputs.pt"))
        flow = load_torch_checkpoint(os.path.join(d, "flow.pt"))
        save_torch_checkpoint(add_meanflow_time_branch(flow, cfg.flow.estimator),
                              os.path.join(root, "flow_meanflow.pt"))
        del flow
        log(f"  world one (first calls): decode of {len(want)} tokens in {one_decode_s:.3f} s "
            f"({len(want) / one_decode_s:.1f} tokens/s); flow at T = {T_mel}, NFE {nfe} "
            f"{one_flow_s:.3f} s")

        port = http_port = _free_port()
        while http_port == port:
            http_port = _free_port()
        here = os.path.dirname(os.path.abspath(__file__))
        logs = [open(os.path.join(root, f"child{r}.log"), "w+") for r in range(2)]
        procs = [subprocess.Popen([sys.executable, "-c", TP_CHILD, root, d, str(r), str(port),
                                   str(http_port)], cwd=here, stdout=logs[r],
                                  stderr=subprocess.STDOUT, text=True) for r in range(2)]
        url = f"http://127.0.0.1:{http_port}"

        def tail(r):
            logs[r].flush()
            logs[r].seek(0)
            return logs[r].read()[-4000:]

        try:
            c = TTSClient(url, timeout=300)
            deadline = time.time() + 400
            while not c.healthz():
                if time.time() > deadline or any(p.poll() is not None for p in procs):
                    raise SystemExit("chip_smoke: the --tp 2 server did not come up:\n"
                                     + tail(0) + tail(1))
                time.sleep(0.5)
            t_up = time.time() - t0
            t = time.perf_counter()
            wav, sr = c.tts("A")  # one text id: at most 20 tokens
            whole_s = time.perf_counter() - t
            t = time.perf_counter()
            first, chunks = None, []
            for chunk in c.tts_stream("A"):
                first = first or time.perf_counter() - t
                chunks.append(chunk)
            stream_s = time.perf_counter() - t
            dropped = c.tts_stream("B")
            got_one = next(dropped)
            dropped.close()
            stats = c.stats()  # the server goes on after a dropped stream
            procs[0].send_signal(15)
            procs[1].send_signal(15)  # a follower ignores it: rank 0's drain stops it
            rcs = [p.wait(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = [tail(r) for r in range(2)]
        for f in logs:
            f.close()
        if rcs != [0, 0]:
            raise SystemExit(f"chip_smoke: the --tp 2 children exited {rcs}:\n{outs[0]}{outs[1]}")
        ends = [json.loads(next(ln for ln in reversed(o.splitlines()) if ln.startswith('{"main"')))
                for o in outs]
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    # (d) the split
    for r in ranks:
        log(f"  (d) rank {r['rank']} on {r['device']} over {r['backend']}: {r['split'][0]} llm + "
            f"{r['split'][1]} flow split params; weight bytes llm {r['local_bytes'][0]} of "
            f"{r['whole_bytes'][0]} ({r['local_bytes'][0] / r['whole_bytes'][0]:.3f}), flow "
            f"{r['local_bytes'][1]} of {r['whole_bytes'][1]} "
            f"({r['local_bytes'][1] / r['whole_bytes'][1]:.3f})")
    if not all(r["split"][0] > 0 and r["split"][1] > 0 and r["layout_split"] == sum(r["split"])
               and r["local_bytes"][0] < r["whole_bytes"][0]
               and r["local_bytes"][1] < r["whole_bytes"][1] for r in ranks):
        raise SystemExit("chip_smoke: the --tp 2 weights did not split")
    # (a) the decode
    for r in ranks:
        got = r["tokens"]
        log(f"  (a) rank {r['rank']}: {len(got)} tokens in {r['decode_s']:.3f} s "
            f"({len(got) / r['decode_s']:.1f} tokens/s); equal to the world-one decode: "
            f"{got == want}")
        if got != want:
            j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                     min(len(got), len(want)))
            gap = (r["logits"][j] - one_logits[j]).abs().max().item()
            tol = 1e-4 * max(1.0, one_logits[j].abs().max().item())
            log(f"  (a) tokens diverge at step {j}: logit gap {gap:.3e} (tol {tol:.3e})")
            if not gap <= tol:
                raise SystemExit("chip_smoke: the --tp 2 decode diverges beyond rounding")
    # (b) the flow
    tol = 1e-4 * max(1.0, mel_one.abs().max().item())
    for r in ranks:
        err = (r["mel"] - mel_one).abs().max().item()
        counts = r["flow_counts"]
        log(f"  (b) rank {r['rank']}: flow at T = {T_mel}, NFE {nfe} in {r['flow_s']:.3f} s, "
            f"max_abs_err against the world-one flow {err:.3e} (tol {tol:.3e}); "
            f"launches {counts}")
        if r["mel"].shape != mel_one.shape or not err <= tol:
            raise SystemExit("chip_smoke: the --tp 2 flow disagrees with the world-one flow")
        chain = ("fused_transformer_block", "ln_gemm", "flash_attention", "block_tail")
        if any(counts[k] != 64 * nfe for k in chain) or any(
                counts[k] for k in ("gemm", "layer_norm_rows", "banded_attention")):
            raise SystemExit(f"chip_smoke: the --tp 2 flow's launches {counts} are not the "
                             f"chain B1 -> A -> B2 64 x {nfe} times")
    # (c) the server
    log(f"  (c) server up {t_up:.1f} s after the phase began; whole request {wav.size / sr:.2f} s "
        f"of audio in {whole_s:.3f} s (RTF {whole_s / (wav.size / sr):.3f}); stream: first "
        f"piece after {first:.3f} s, {len(chunks)} pieces, {sum(x.size for x in chunks) / sr:.2f} "
        f"s of audio in {stream_s:.3f} s; a stream dropped after {got_one.size} samples; "
        f"/stats requests {stats['requests']} errors {stats['errors']}")
    log(f"  (c) rank 0: {ends[0]['main']}, rank 1: {ends[1]['main']}; the children took "
        f"{ends[0]['wall_s']:.1f} / {ends[1]['wall_s']:.1f} s; exit codes {rcs}")
    audio = [wav] + chunks + [got_one]
    if not (sr == 22050 and all(a.size and np.isfinite(a).all() for a in audio)
            and ends[1]["main"] == {"replayed": ends[0]["main"]["sent"], "errors": []}):
        raise SystemExit("chip_smoke: the --tp 2 server's answers or replay counts are off")
    log(f"  phase 20 took {time.time() - t0:.1f} s")
    return ranks[0]["flow_counts"]


def report(name, r):
    def dev(key):
        return "" if r.get(key) is None else f" ({r[key]:.4f} on the card)"

    log(f"  {name:<44} max_abs_err {r['err']:.3e} ({r['tol']}) {'ok' if r['ok'] else 'FAIL'}"
        f" | kernel {r['ms']:.4f} ms{dev('dev_ms')}, plain {r['plain_ms']:.4f} ms"
        f"{dev('plain_dev_ms')}, "
        + (f"library {r['library_ms']:.4f} ms" if r["library_ms"] is not None
           else f"library none (unfused library calls {r['unfused_ms']:.4f} ms")
        + dev("lib_dev_ms") + ("" if r["library_ms"] is not None else ")")
        + (f", kernel A with a band bias {r['kernel_a_ms']:.4f} ms"
           if "kernel_a_ms" in r else "")
        + (f", seven-launch chain {r['chain7_ms']:.4f} ms{dev('chain7_dev_ms')} "
           f"(err {r['chain7_err']:.2e})" if "chain7_ms" in r else "")
        + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
        + (f" (three TF32 passes {r['tf32x3_ms']:.4f} ms)" if r.get("tf32x3_ms") else ""))
    if not r["ok"]:
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain version")
    if not r.get("same", True):
        raise SystemExit(f"chip_smoke: {name} changed its result from one call to the next")


def main():
    t_start = time.time()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"[1] device: {name} | {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    t = time.time()
    libs = _cuda.build()
    log(f"[2] kernels built in {time.time() - t:.1f} s: {[os.path.basename(p) for p in libs]}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[3] kernels vs plain versions (TF32 off for matmul and cuDNN)")
    g = torch.Generator(device=DEV).manual_seed(0)
    for bad, what in ((torch.float16, "fp16"), (None, "head dim 32")):
        shape = (1, 1, 8, 32 if bad is None else 64)
        q = torch.zeros(shape, device=DEV, dtype=bad or torch.float32)
        n0 = flash_attention.launches
        try:
            flash_attention(q, q, q, None, 1.0)
        except (TypeError, ValueError) as e:
            if flash_attention.launches != n0:
                raise SystemExit(f"chip_smoke: kernel A launched on {what}")
            log(f"  refused {what} on CUDA: {e}")
        else:
            raise SystemExit(f"chip_smoke: kernel A accepted {what}")
    q = torch.zeros((1, 1, 8, 64), device=DEV)
    n0 = banded_attention.launches
    for what, call, exc in (
            ("fp16", lambda: banded_attention(q.half(), q.half(), q.half(), 1.0, 2), TypeError),
            ("head dim 32", lambda: banded_attention(q[..., :32], q[..., :32], q[..., :32], 1.0, 2),
             ValueError),
            ("S != T", lambda: banded_attention(q, q[:, :, :4], q[:, :, :4], 1.0, 2), ValueError),
            ("an input that requires a gradient",
             lambda: banded_attention(q.clone().requires_grad_(True), q, q, 1.0, 2), RuntimeError)):
        try:
            call()
        except exc as e:
            log(f"  kernel C refused {what} on CUDA: {e}")
        else:
            raise SystemExit(f"chip_smoke: kernel C accepted {what}")
    if banded_attention.launches != n0:
        raise SystemExit("chip_smoke: kernel C launched on a refused input")
    # what the 16-byte copies of the redesigned kernels do not take
    n0 = (flash_attention.launches, gemm.launches)
    q65 = torch.zeros((1, 1, 8, 65), device=DEV)[..., :64]
    a = torch.zeros((64, 64), device=DEV)
    for what, call in (
            ("rows off a 16-byte boundary", lambda: flash_attention(q65, q65, q65, None, 1.0)),
            ("a GEMM with K = 60", lambda: gemm(a[:, :60].contiguous(), [a[:, :60].contiguous()])),
            ("a GEMM operand off a 16-byte boundary",
             lambda: gemm(torch.zeros(64 * 64 + 1, device=DEV)[1:].view(64, 64), [a])),
            ("a non-contiguous GEMM operand", lambda: gemm(a.t(), [a]))):
        try:
            call()
        except ValueError as e:
            log(f"  refused {what} on CUDA: {e}")
        else:
            raise SystemExit(f"chip_smoke: a kernel accepted {what}")
    if (flash_attention.launches, gemm.launches) != n0:
        raise SystemExit("chip_smoke: a kernel launched on a refused input")
    # what kernels B1 and B2 do not take
    n0 = (ln_gemm.launches, block_tail.launches)
    v = torch.zeros(256, device=DEV)
    w96 = torch.zeros(64, 96, device=DEV)
    tail_w = [torch.zeros(s, device=DEV) for s in ((256, 512), (256,), (256,), (256,), (1024, 256),
                                                   (1024,), (256, 1024), (256,))]
    for what, call, exc in (
            ("an LN prologue over K = 96", lambda: ln_gemm(torch.zeros(8, 96, device=DEV), v[:96],
                                                          v[:96], [w96]), ValueError),
            ("an LN prologue over K = 512", lambda: ln_gemm(
                torch.zeros(8, 512, device=DEV), torch.zeros(512, device=DEV),
                torch.zeros(512, device=DEV), [torch.zeros(64, 512, device=DEV)]), ValueError),
            ("a block tail of width 128", lambda: block_tail(
                torch.zeros(8, 512, device=DEV), torch.zeros(8, 128, device=DEV),
                *[torch.zeros(t.shape[0] // 2 if t.shape[0] == 256 else t.shape[0],
                              *t.shape[1:], device=DEV) for t in tail_w]), ValueError),
            ("a bf16 block tail with f32 weights", lambda: block_tail(
                torch.zeros(8, 512, device=DEV, dtype=torch.bfloat16),
                torch.zeros(8, 256, device=DEV, dtype=torch.bfloat16), *tail_w), TypeError),
            ("a block tail input that requires a gradient", lambda: block_tail(
                torch.zeros(8, 512, device=DEV, requires_grad=True),
                torch.zeros(8, 256, device=DEV), *tail_w), RuntimeError)):
        try:
            call()
        except exc as e:
            log(f"  refused {what} on CUDA: {e}")
        else:
            raise SystemExit(f"chip_smoke: a block kernel accepted {what}")
    if (ln_gemm.launches, block_tail.launches) != n0:
        raise SystemExit("chip_smoke: a block kernel launched on a refused input")
    for dtype in (torch.float32, torch.bfloat16):
        # the windowed path's shapes, the aligned shapes beside them, a
        # ragged T with a short k_valid, a window covering T, and a narrow
        # window whose k_valid leaves whole query tiles without a key
        dn = str(dtype)[6:]
        # phase 7's own shapes first: 1485 tokens give 2558 mel frames, so
        # the path launches C at T = 2558 (window 256) and, most often, at
        # T/2 = 1279 (window 128); both end in a ragged query and key tile
        report(f"C main path (2,8,2558,64) window 256 {dn}",
               banded_case(g, 2, 8, 2558, 256, dtype))
        r = banded_case(g, 2, 8, 1279, 128, dtype)
        report(f"C main path (2,8,1279,64) window 128 {dn}", r)
        if dtype == torch.float32:
            main_c = r
        report(f"C (2,8,2560,64) window 256 {dn}", banded_case(g, 2, 8, 2560, 256, dtype))
        report(f"C (2,8,1280,64) window 128 {dn}", banded_case(g, 2, 8, 1280, 128, dtype))
        report(f"C (2,8,2307,64) window 256 k_valid [2307,1811] {dn}",
               banded_case(g, 2, 8, 2307, 256, dtype, kv=[2307, 1811]))
        report(f"C (2,8,200,64) window 4096 >= T {dn}", banded_case(g, 2, 8, 200, 4096, dtype))
        report(f"C (2,8,150,64) window 3 k_valid [150,9] {dn}",
               banded_case(g, 2, 8, 150, 3, dtype, kv=[150, 9]))
        for T in (207, 414, 1024, 2580):
            report(f"A (2,8,{T},64) {str(dtype)[6:]} bias+k_valid+masked row",
                   attention_case(g, 2, 8, T, T, dtype, iters=20 if T < 2000 else 5))
        report(f"A (2,8,128,64) S=8320 {str(dtype)[6:]} bias+k_valid",
               attention_case(g, 2, 8, 128, 8320, dtype, iters=5))
        for T in (208, 414):
            for with_bias in (False, True):
                report(f"B (2,{T},256) {str(dtype)[6:]} {'bias' if with_bias else 'no bias'}",
                       block_case(g, 2, T, dtype, with_bias))
    # the main path's shapes: mel length 311 -> padded 312; 8 blocks run at
    # T = 312 and 56 at the T/2 level, 156 (B = 2, so 624 and 312 rows).
    # The kernels line reports the T/2 level, where most launches run.
    report("A main path (2,8,312,64) f32 bias", attention_case(g, 2, 8, 312, 312, torch.float32))
    main_a = attention_case(g, 2, 8, 156, 156, torch.float32)
    report("A main path (2,8,156,64) f32 bias", main_a)
    for T in (312, 156):
        report(f"A main path (2,8,{T},64) bf16 bias", attention_case(g, 2, 8, T, T, torch.bfloat16))
    for dtype in (torch.float32, torch.bfloat16):
        report(f"A fused block's views (2,312,3,8,64) -> (2,312,8,64) {str(dtype)[6:]} bias",
               attention_views_case(g, 2, 8, 312, dtype))
    report("B main path (2,312,256) f32 bias", block_case(g, 2, 312, torch.float32, True))
    main_b = block_case(g, 2, 156, torch.float32, True)
    report("B main path (2,156,256) f32 bias", main_b)
    report("B main path (2,156,256) bf16 bias", block_case(g, 2, 156, torch.bfloat16, True))
    report("LayerNorm main path (624,256) f32", layer_norm_case(g, 2 * 312))
    main_ln = layer_norm_case(g, 2 * 156)
    report("LayerNorm main path (312,256) f32", main_ln)
    # the four products at the long utterance's rows (2 x 2558) and at the
    # short synthesis's two levels, f32 and bf16.  The kernels line reports
    # FF2 at 312 rows in f32, the case furthest behind the library
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (2 * 2558, 2 * 312, 2 * 156):
            it = 10 if rows > 1000 else 50
            level = {}
            level["QKV"] = gemm_case(g, rows, 256, 512, 3, iters=it, dtype=dtype)
            level["out-proj"] = gemm_case(g, rows, 512, 256, bias=True, residual=True,
                                          iters=it, dtype=dtype)
            level["FF1"] = gemm_case(g, rows, 256, 1024, bias=True, gelu="tanh", iters=it,
                                     dtype=dtype)
            level["FF2"] = gemm_case(g, rows, 1024, 256, bias=True, residual=True, iters=it,
                                     dtype=dtype)
            for what, r in level.items():
                report(f"GEMM main path {what} M={rows} {str(dtype)[6:]} plan {r['plan']}", r)
        if dtype == torch.float32:
            main_gemm = level["FF2"]
    # kernels B1 and B2 at the short synthesis's two levels and the long
    # utterance's rows; the kernels line reports 312 rows in f32 (the T/2
    # level, where 56 of the 64 blocks run)
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (2 * 156, 2 * 312, 2 * 2558):
            it = 10 if rows > 1000 else 20
            r1, r2 = ln_gemm_case(g, rows, dtype, iters=it), tail_case(g, rows, dtype, iters=it)
            report(f"B1 ln_gemm M={rows} {str(dtype)[6:]} plan {r1['plan']} same bits twice "
                   f"{r1['same']}", r1)
            report(f"B2 block_tail M={rows} {str(dtype)[6:]} plan {r2['plan']} same bits twice "
                   f"{r2['same']}", r2)
            if rows == 2 * 156 and dtype == torch.float32:
                main_b1, main_b2 = r1, r2
    # bf16 at 2558 rows: 40 row tiles, the plan no other row count picks
    r2 = tail_case(g, 2558, torch.bfloat16, iters=10)
    report(f"B2 block_tail M=2558 bf16 plan {r2['plan']} same bits twice {r2['same']}", r2)
    report("B1 ln_gemm M=312 x f32 under bf16 weights",
           ln_gemm_case(g, 312, torch.bfloat16, x_dtype=torch.float32))
    report("B1 ln_gemm M=156 bf16 (MeanFlow's T/2 level)", ln_gemm_case(g, 156, torch.bfloat16))
    ln_gemm_ragged(g)
    # the streaming path's shapes (phase 9): a 120-token window is 206 mel
    # frames (even: no mask, no bias) and 103 at the T/2 level; the bucketed
    # final chunk is 220 frames with its true 172 valid (a (B,T,T) bias),
    # 110 with 86 valid at T/2.  B1 and B2 run at 412, 206, 440 and 220 rows
    log("  streaming and final-bucket shapes (phase 9's), plans (kv_splits) of A, "
        "(block_m, block_n) of B1, (block_m, cluster, sub-tile) of B2")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype)[6:]
        for T, valid in ((206, None), (103, None), (220, 172), (110, 86)):
            what = "no bias" if valid is None else f"bias from key {valid}"
            report(f"A stream (2,8,{T},64) {dn} {what} plan "
                   f"{_attention_plan(16, T, T, None, dtype)}",
                   attention_case(g, 2, 8, T, T, dtype, masked=False, pad_from=valid))
            report(f"B stream (2,{T},256) {dn} {what}",
                   block_case(g, 2, T, dtype, valid is not None, pad_from=valid))
        for rows in (412, 206, 440, 220):
            r1, r2 = ln_gemm_case(g, rows, dtype), tail_case(g, rows, dtype)
            report(f"B1 stream M={rows} {dn} plan {r1['plan']} same bits twice {r1['same']}", r1)
            report(f"B2 stream M={rows} {dn} plan {r2['plan']} same bits twice {r2['same']}", r2)
    # exact (erf) GELU: the variant of B2 and of the GEMM epilogue behind
    # EstimatorConfig(gelu_approximate=False); the kernels line reports B2-erf
    # at 312 rows in f32, beside B2's tanh row
    log("  exact (erf) GELU beside tanh at 312 rows: B2, the GEMM epilogue (FF1), the block")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype)[6:]
        for gelu in ("tanh", "erf"):
            r2 = tail_case(g, 2 * 156, dtype, gelu=gelu)
            report(f"B2 block_tail M=312 {dn} gelu {gelu} plan {r2['plan']}", r2)
            if dtype == torch.float32 and gelu == "erf":
                main_b2_erf = r2
        r = gemm_case(g, 2 * 156, 256, 1024, bias=True, gelu="erf", dtype=dtype)
        report(f"GEMM FF1 gelu erf M=312 {dn} plan {r['plan']}", r)
        report(f"B (2,156,256) {dn} bias gelu erf",
               block_case(g, 2, 156, dtype, True, gelu_approximate=False))
    refuse_missing_gelu()
    # CosyVoice2's streaming shapes (phase 12's): a window of 75 tokens is 150
    # mel frames, 75 at the T/2 level; every level carries the static-chunk
    # bias of 50 frames as a contiguous (2, T, T)
    log("  CosyVoice2 streaming shapes: A, the block, B1 and B2 with the 50-frame chunk bias")
    for dtype, T in ((torch.float32, 150), (torch.float32, 75), (torch.bfloat16, 75)):
        dn = str(dtype)[6:]
        cb = _stream_bias(None, 2, T, 50, dtype, DEV)
        ra = attention_case(g, 2, 8, T, T, dtype, masked=False, bias_t=cb)
        report(f"A cv2 stream (2,8,{T},64) {dn} chunk bias", ra)
        rb = block_case(g, 2, T, dtype, True, bias_t=cb)
        report(f"B cv2 stream (2,{T},256) {dn} chunk bias", rb)
        r1, r2 = ln_gemm_case(g, 2 * T, dtype), tail_case(g, 2 * T, dtype)
        report(f"B1 cv2 stream M={2 * T} {dn} plan {r1['plan']}", r1)
        report(f"B2 cv2 stream M={2 * T} {dn} plan {r2['plan']}", r2)
        if T == 75 and dtype == torch.float32:
            cv2_kernels = {"flash_attention": ra, "fused_transformer_block": rb,
                           "ln_gemm": r1, "block_tail": r2}
    if set(_TAIL_PLANS) - TAIL_PLANS_RUN:
        raise SystemExit(f"chip_smoke: no case ran the B2 plans "
                         f"{set(_TAIL_PLANS) - TAIL_PLANS_RUN}")
    log(f"  B2: every plan held against block_tail_ref: {sorted(TAIL_PLANS_RUN)}")
    attention_splits(g)
    same_twice(g)

    cfg = ModelConfig()
    log("[4] full-width estimator call, B=2, T=208 (valid 207: mask + bias)")
    flow = init_flow_params(cfg.flow, DEV, seed=1)
    est = P(dict(flow.named_parameters())).sub("decoder.estimator")
    gen = torch.Generator(device=DEV).manual_seed(2)
    x, mu, cond = (torch.randn(2, 80, 208, device=DEV, generator=gen) for _ in range(3))
    spks = torch.randn(2, 80, device=DEV, generator=gen)
    tt = torch.rand(2, device=DEV, generator=gen)
    mask = torch.ones(2, 1, 208, device=DEV)
    mask[:, :, 207:] = 0.0
    args = (x, mask, mu, tt, spks, cond)
    with torch.inference_mode():
        y = conditional_decoder(est, cfg.flow.estimator, *args)
        est_ms = cuda_ms(lambda: conditional_decoder(est, cfg.flow.estimator, *args), 5)
        est_cpu = P({k: v.cpu() for k, v in est.d.items()}).sub("decoder.estimator")
        t = time.time()
        y_cpu = conditional_decoder(est_cpu, cfg.flow.estimator, *(a.cpu() for a in args))
        cpu_s = time.time() - t
    err = (y.cpu() - y_cpu).abs().max().item()
    scale = y_cpu.abs().max().item()
    log(f"  card {est_ms:.3f} ms/call, cpu (plain versions) {cpu_s:.2f} s; max_abs_err "
        f"{err:.3e} vs max|y| {scale:.3e} (tol 1e-4 * max(1, max|y|))")
    if not (torch.isfinite(y).all() and err <= 1e-4 * max(1.0, scale)):
        raise SystemExit("chip_smoke: full-width estimator disagrees with the CPU plain path")
    counts_erf = erf_estimator(est, cfg.flow.estimator, args, est_cpu, y)
    refuse_tiny_widths()

    log("[5] full-width prompt-free synthesis (random seeded weights)")
    t = time.time()
    llm = init_llm_params(cfg.llm, DEV, seed=3)
    hift = init_hift_params(cfg.hift, DEV, seed=4)
    torch.cuda.synchronize()
    log(f"  weights on the card in {time.time() - t:.1f} s: llm "
        f"{sum(p.numel() for p in llm.parameters()) / 1e6:.1f} M, flow "
        f"{sum(p.numel() for p in flow.parameters()) / 1e6:.1f} M, hift "
        f"{sum(p.numel() for p in hift.parameters()) / 1e6:.1f} M params")
    # 16 text ids; EOS held off (min ratio 12) and the decode capped at 181
    # tokens -> 311 mel frames: odd (padded, masked, (B,T,T) bias) and > 300
    # (NFE 15)
    icfg = InferenceConfig(min_token_text_ratio=12.0)
    pipe = TTSPipeline(cfg, llm, flow, hift, icfg, finetuned_norm=True)
    ids = np.random.default_rng(5).integers(0, 256, (1, 16)).astype(np.int64)
    ops.reset_launch_counts()
    t = time.time()
    wav = next(pipe.synthesize(ids, spk_embedding=np.zeros((1, 192), np.float32),
                               max_len_cap=181, seed=6))["tts_speech"]
    total_s = time.time() - t
    counts = ops.launch_counts()
    T_mel, nfe = 311, 15
    log(f"  stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in pipe.stage_seconds.items())
        + f"; total {total_s:.3f} s")
    log(f"  waveform {wav.shape}, finite {bool(np.isfinite(wav).all())}, "
        f"{wav.shape[1] / cfg.sample_rate:.2f} s of audio")
    log(f"  launches: {counts}")
    blocks = 64 * nfe
    if wav.shape != (1, 256 * T_mel) or not np.isfinite(wav).all():
        raise SystemExit("chip_smoke: synthesis output has the wrong shape or is not finite")
    if counts["fused_transformer_block"] != blocks or counts["ln_gemm"] != blocks \
            or counts["block_tail"] != blocks or counts["flash_attention"] < blocks \
            or counts["gemm"] != 0 or counts["layer_norm_rows"] != 0:
        raise SystemExit(f"chip_smoke: launch counts {counts} off the path's 64 x NFE {nfe} "
                         "blocks of three launches")

    log("[6] where the time goes: one estimator call at the main path's shape "
        "(B=2, T=312, valid 311), torch.profiler")
    where_time_goes(est, cfg.flow.estimator, 312)

    counts_w = windowed_synthesis(cfg, llm, flow, hift)
    training_steps(cfg, llm, flow, hift)
    streaming_synthesis(cfg, llm, flow, hift)
    batched_serving(cfg, llm, flow, hift)
    del llm, flow, hift, pipe, est, est_cpu
    torch.cuda.empty_cache()
    training_cli(cfg)
    counts_cv2, cv2_models = cv2_synthesis()
    cv2_cfgs = (Qwen2LMConfig(), Flow2Config(), hift24k_config())
    for phase in (cv2_serving, frontend_and_prep):
        for k, v in phase(*cv2_cfgs, *cv2_models).items():
            counts_cv2[k] += v
    del cv2_models
    torch.cuda.empty_cache()
    model_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_api_")  # [15]'s, read by [20]
    counts_api, counts_voiced = api_and_serving(cfg, model_dir.name)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_regimes_") as root:
        t = time.time()
        counts_mf, counts_teacher = meanflow_phase(cfg, root)
        for total, part in zip((counts_mf, counts_teacher), meanflow_cv2(root)):
            for k, v in part.items():
                total[k] += v
        log("  the kernels at the MeanFlow path's T/2 level (B = 1, no CFG doubling: 156 rows) "
            "and at the distillation teacher's (4 rows of 125 frames), f32")
        mf = {"flash_attention": attention_case(g, 1, 8, 156, 156, torch.float32),
              "fused_transformer_block": block_case(g, 1, 156, torch.float32, True),
              "ln_gemm": ln_gemm_case(g, 156, torch.float32),
              "block_tail": tail_case(g, 156, torch.float32)}
        for kname, r in mf.items():
            report(f"{kname} MeanFlow (B = 1, 156 rows)", r)
        teacher_b = block_case(g, 4, 125, torch.float32, True)
        report("B distillation teacher (4,125,256)", teacher_b)
        full_param_phase(root, cfg, Qwen2LMConfig(), Flow2Config())
        gan_phase(cfg)
        log(f"  phase 16 took {time.time() - t:.1f} s")
        scale_out_phase(root, cfg)
    counts_lt = new_modules_phase(cfg)
    counts_x = export_and_tools_phase(cfg)
    counts_tp = tp_serving_phase(cfg, model_dir.name)
    model_dir.cleanup()

    def entry(name, source, replaces, r, launches=None):
        # times on the card (torch.profiler) where the profiler gave them,
        # else the CUDA-event means: on a slow host the event mean of a small
        # kernel is the host's launch rate, not the kernel
        def on_card(key, event_key):
            return r[event_key] if r.get(key) is None else r[key]

        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": counts[name] if launches is None else launches,
                "max_abs_err": r["err"], "ms": on_card("dev_ms", "ms"),
                "plain_ms": on_card("plain_dev_ms", "plain_ms"), "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "library_ms": None if r["library_ms"] is None
                else on_card("lib_dev_ms", "library_ms")}

    kernels = [
        entry("flash_attention", "cosy_tpu_torch/csrc/flash_attention.cu",
              "cosy_tpu/ops/flash_attention.py:76", main_a),
        entry("fused_transformer_block", "cosy_tpu_torch/csrc/fused_block.cu",
              "cosy_tpu/ops/fused_block.py:34", main_b),
        entry("layer_norm_rows", "cosy_tpu_torch/csrc/fused_block.cu",
              "cosy_tpu/ops/fused_block.py:49", main_ln),
        entry("gemm", "cosy_tpu_torch/csrc/fused_block.cu",
              "cosy_tpu/ops/fused_block.py:51", main_gemm),
        entry("ln_gemm", "cosy_tpu_torch/csrc/ln_gemm.cu",
              "cosy_tpu/ops/fused_block.py:49", main_b1),
        entry("block_tail", "cosy_tpu_torch/csrc/block_tail.cu",
              "cosy_tpu/ops/fused_block.py:74", main_b2),
        # launches on the windowed path (phase 7); times at its T/2 level
        entry("banded_attention", "cosy_tpu_torch/csrc/flash_attention.cu",
              "cosy_tpu/ops/flash_attention.py:275", main_c,
              launches=counts_w["banded_attention"]),
        # exact-GELU B2: launches of phase 4's gelu_approximate=False call
        entry("block_tail_erf", "cosy_tpu_torch/csrc/block_tail.cu",
              "cosy_tpu/ops/fused_block.py:83", main_b2_erf,
              launches=counts_erf["block_tail"]),
        # phase 15: the fused blocks of the API's calls (a), and kernel A
        # launched alone in the unfused blocks of the voiced calls (b);
        # times at the main path's T/2 level
        entry("fused_transformer_block_api", "cosy_tpu_torch/csrc/fused_block.cu",
              "cosy_tpu/ops/fused_block.py:34", main_b,
              launches=counts_api["fused_transformer_block"]),
        entry("flash_attention_voiced", "cosy_tpu_torch/csrc/flash_attention.cu",
              "cosy_tpu/ops/flash_attention.py:76", main_a,
              launches=counts_voiced["flash_attention"]
              - counts_voiced["fused_transformer_block"]),
    ] + [
        # CosyVoice2 (phase 12): launches of its synthesis, times at the
        # streaming window's T/2 level with the chunk bias
        entry(f"{name}_cv2_stream", src, rep, cv2_kernels[name], launches=counts_cv2[name])
        for name, src, rep in (
            ("flash_attention", "cosy_tpu_torch/csrc/flash_attention.cu",
             "cosy_tpu/ops/flash_attention.py:76"),
            ("fused_transformer_block", "cosy_tpu_torch/csrc/fused_block.cu",
             "cosy_tpu/ops/fused_block.py:34"),
            ("ln_gemm", "cosy_tpu_torch/csrc/ln_gemm.cu", "cosy_tpu/ops/fused_block.py:49"),
            ("block_tail", "cosy_tpu_torch/csrc/block_tail.cu", "cosy_tpu/ops/fused_block.py:74"))
    ] + [
        # phase 16 (a): the MeanFlow syntheses' launches (1 and 2 steps, the
        # inference CLI, the server), times at their T/2 level (B = 1)
        entry(f"{name}_meanflow", src, rep, mf[name], launches=counts_mf[name])
        for name, src, rep in (
            ("flash_attention", "cosy_tpu_torch/csrc/flash_attention.cu",
             "cosy_tpu/ops/flash_attention.py:76"),
            ("fused_transformer_block", "cosy_tpu_torch/csrc/fused_block.cu",
             "cosy_tpu/ops/fused_block.py:34"),
            ("ln_gemm", "cosy_tpu_torch/csrc/ln_gemm.cu", "cosy_tpu/ops/fused_block.py:49"),
            ("block_tail", "cosy_tpu_torch/csrc/block_tail.cu", "cosy_tpu/ops/fused_block.py:74"))
    ] + [
        # the distillation teacher's CFG-batched calls (4 x 64 blocks an
        # integral step, 64 a jvp step)
        entry("fused_transformer_block_distill_teacher", "cosy_tpu_torch/csrc/fused_block.cu",
              "cosy_tpu/ops/fused_block.py:34", teacher_b,
              launches=counts_teacher["fused_transformer_block"]),
        # phase 18 (b): the train-style flow inference's blocks (64 x NFE 4),
        # times at the main path's T/2 level
        entry("fused_transformer_block_like_training", "cosy_tpu_torch/csrc/fused_block.cu",
              "cosy_tpu/ops/fused_block.py:34", main_b,
              launches=counts_lt["fused_transformer_block"]),
        # phase 19 (a): the estimator call of the ONNX export's own check
        # (B = 2, T = 256), times at the main path's T/2 level
        entry("fused_transformer_block_onnx_check", "cosy_tpu_torch/csrc/fused_block.cu",
              "cosy_tpu/ops/fused_block.py:34", main_b,
              launches=counts_x["fused_transformer_block"]),
    ] + [
        # phase 20 (b): one rank's flow call under serve --tp 2, each block
        # the chain on its all-gathered weights (64 x NFE 15); times at the
        # main path's T/2 level
        entry(f"{name}_tp", src, rep, r, launches=counts_tp[name])
        for name, src, rep, r in (
            ("flash_attention", "cosy_tpu_torch/csrc/flash_attention.cu",
             "cosy_tpu/ops/flash_attention.py:76", main_a),
            ("fused_transformer_block", "cosy_tpu_torch/csrc/fused_block.cu",
             "cosy_tpu/ops/fused_block.py:34", main_b),
            ("ln_gemm", "cosy_tpu_torch/csrc/ln_gemm.cu", "cosy_tpu/ops/fused_block.py:49",
             main_b1),
            ("block_tail", "cosy_tpu_torch/csrc/block_tail.cu", "cosy_tpu/ops/fused_block.py:74",
             main_b2))
    ]
    log(f"  run took {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
