"""TTS pipeline: text ids -> speech tokens -> mel -> waveform (the port of
the JAX package's ``infer/pipeline.py``): whole-utterance and streamed
synthesis of one request (prompt-free, zero-shot, cross-lingual, instruct
and voice conversion), micro-batched synthesis of several, and un-merged
multi-voice LoRA serving (``set_voices``).

Stages: ``_build_prefix`` packs [sos, spk?, text_enc, task, prompt speech?]
for the LLM (the prompt text encoded before the text),
``generate_tokens`` runs the AR decode (``generate_tokens_stream`` in
segments), ``token2wav`` runs the flow solve (NFE by mel length), the
boundary trim and HiFT, and in streaming mode the overlap fades and the
flow and HiFT carries of a :class:`StreamState`.  Streaming keeps the
reference's geometry: windows of hop + overlap tokens advance by the hop,
the mel overlap is faded into the next window, and the last window is
padded to one token bucket (``bucket_final``) with its true length masked.

Randomness: every draw comes from a ``torch.Generator`` seeded with
``stream_seed(seed, row, stage) = seed + stage + row * 2**32``.  Stage 0 is
the row's decode (a CPU generator, its uniforms drawn in bulk for the
sampler on the device); stage ``1 + k`` is the row's k-th wav chunk (a
generator on the pipeline's device, which draws the flow's z, then
HiFT's phases and noise).  A single
request is row 0, so whole-utterance synthesis draws from ``seed`` and
``seed + 1``, and row b of a batch decodes as a solo request does with
``stream_seed(seed, b, 0)``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import InferenceConfig, ModelConfig
from ..ctx import EVAL, Ctx
from ..layers.basic import dense
from ..models import flow as F
from ..models import hift as H
from ..models import llm as L
from ..ops.fused_block import require_kernel_widths
from ..parallel import tp as TP
from ..params import P


def stream_seed(seed: int, row: int, stage: int) -> int:
    """The seed of ``row``'s generator for ``stage`` (0: decode, 1 + k: wav
    chunk k); see the module docstring."""
    return seed + stage + (row << 32)


def fade_in_out(fade_in: torch.Tensor, fade_out: torch.Tensor, window: torch.Tensor,
                valid: Optional[int] = None) -> torch.Tensor:
    """Crossfade the head of ``fade_in`` with the tail of ``fade_out`` over
    half the window, clamped to the shorter signal (a final chunk can be
    shorter than the window).  ``valid``: ``fade_in`` is bucket-padded and
    only its first ``valid`` frames are real, so the clamp uses that length
    (the JAX package's ``fade_in_out_valid_jnp``)."""
    half = window.shape[0] // 2
    n = min(half, fade_in.shape[-1], fade_out.shape[-1],
            fade_in.shape[-1] if valid is None else valid)
    if n == 0:
        return fade_in
    head = fade_in[..., :n] * window[:n] + fade_out[..., -n:] * window[half:half + n]
    return torch.cat([head, fade_in[..., n:]], dim=-1)


def _batch_prefixes(built):
    """LEFT-pad per-request (prefix (1, L, D), min_len, max_len) triples
    into one batch with L0 rounded up to a multiple of 16.  Returns
    (prefix (B, L0, D), valid, min_lens, max_lens)."""
    L0 = -(-max(pr.shape[1] for pr, _, _ in built) // 16) * 16
    prefix = torch.cat([torch.nn.functional.pad(pr, (0, 0, L0 - pr.shape[1], 0))
                        for pr, _, _ in built])
    return (prefix, [pr.shape[1] for pr, _, _ in built], [mn for _, mn, _ in built],
            [ml for _, _, ml in built])


@dataclasses.dataclass
class StreamState:
    """Per-request streaming carries, kept on the pipeline's device (the
    emitted wav is the one host copy a chunk).  None before the first
    chunk."""
    mel_overlap: Optional[torch.Tensor] = None  # (1, 80, 34) faded into the next window
    hift_mel: Optional[torch.Tensor] = None  # (1, 80, 20) mel cache before the next chunk
    hift_source: Optional[torch.Tensor] = None  # (1, 1, 5120) source carry
    hift_speech: Optional[torch.Tensor] = None  # (1, 5120) wav tail faded into the next chunk
    flow_cache: Optional[torch.Tensor] = None  # (1, 80, 34, 2) z / mu carry


@dataclasses.dataclass
class StreamCursor:
    """One stream's place in its token stream: the next window's start
    ``pos`` and hop, the chunks emitted so far (chunk k draws from
    ``stream_seed(seed, row, 1 + k)``) and its carries."""
    spk: np.ndarray
    seed: int
    row: int
    hop: int
    pos: int = 0
    chunk: int = 0
    state: StreamState = dataclasses.field(default_factory=StreamState)
    prompt_token: Optional[np.ndarray] = None  # the flow prompt every window takes
    prompt_feat: Optional[np.ndarray] = None  # its raw mel (1, T, 80)
    voice: Optional[str] = None  # a registered voice's adapters (set_voices)


class TTSPipeline:
    """Synthesis over the port's ``TransformerLM``, ``Flow`` and ``HiFT``
    modules (all on one device)."""

    _marks_off = False  # stage marks skipped (a batch dispatched before its reads)

    def __init__(self, model_cfg: ModelConfig, llm: L.TransformerLM, flow: F.Flow,
                 hift: H.HiFT, infer_cfg: InferenceConfig = InferenceConfig(),
                 finetuned_norm: bool = True):
        self.device = next(flow.parameters()).device
        require_kernel_widths(model_cfg.flow.estimator, self.device)
        F.check_sampler_weights(infer_cfg.sampler, infer_cfg.meanflow_steps, flow)
        self.cfg = model_cfg
        self.icfg = infer_cfg
        self.finetuned_norm = finetuned_norm
        self.llm_p, self.flow_p, self.hift_p = llm.p, flow.p, hift.p
        # the weights every decode route's per-token step reads: int8 under
        # int8_decode (the prefill and the head keep llm_p)
        self.llm_step_p = (L.quantize_decode_step(self.llm_p, model_cfg.llm)
                           if infer_cfg.int8_decode else self.llm_p)
        # wall seconds of the last synthesize() / token2wav() per stage
        # (decode, flow, hift), each ending in a device synchronize
        self.stage_seconds: Dict[str, float] = {}
        self._t_mark = 0.0
        # streaming geometry (the reference's hop / overlap / fade constants)
        fr = model_cfg.flow.input_frame_rate
        self.token_min_hop_len = 2 * fr
        self.token_overlap_len = 20
        self.mel_overlap_len = int(self.token_overlap_len / fr * 22050 / 256)
        self.mel_cache_len = 20
        self.source_cache_len = self.mel_cache_len * 256
        self.mel_window = self._hamming(2 * self.mel_overlap_len)
        self.speech_window = self._hamming(2 * self.source_cache_len)
        # the short first hop (first_chunk_tokens), clamped below by the
        # smallest window whose emitted audio is not empty: a non-final
        # window of W tokens emits ~W * ratio - mel_overlap - mel_cache frames
        ratio = model_cfg.flow.token_mel_ratio
        min_first = max(1, int(-(-(self.mel_overlap_len + self.mel_cache_len + 1)
                                 // ratio)) - self.token_overlap_len)
        self.first_hop = (min(max(infer_cfg.first_chunk_tokens, min_first),
                              self.token_min_hop_len)
                          if infer_cfg.first_chunk_tokens else self.token_min_hop_len)
        # the final window is shorter than hop + overlap tokens: one bucket
        self._final_tok_bucket = -(-(self.token_min_hop_len + self.token_overlap_len) // 32) * 32
        # multi-voice serving (set_voices): the voice-stacked llm bank with
        # its trailing zero row, each voice's flow adapters, the scales
        self._voice_names: List[str] = []
        self._voice_llm_bank: Optional[Dict[str, torch.Tensor]] = None
        self._voice_flow: List[Optional[Dict[str, torch.Tensor]]] = []
        self._llm_lora_scale = 1.0
        self._flow_lora_scale = 1.0

    def shard(self, mesh) -> Tuple[int, int]:
        """Split the LLM's and the flow's weights over ``mesh``'s model axis
        (``parallel.tp.shard_params``): this rank keeps its block of each
        split leaf and the rest whole, and the views carry the layout
        (``P.split``), so every call runs the split products whatever thread
        makes it.  HiFT and the voice banks stay whole, as in the JAX
        package's server.  The int8 step view is split by the same rule from
        its whole int8 matrices (per-row scales of a column split need whole
        rows).  Returns the (LLM, flow) leaves split."""
        self.llm_p, self.llm_step_p, self.flow_p, counts = shard_pipeline(
            mesh, self.llm_p, self.llm_step_p, self.flow_p)
        return counts

    def _hamming(self, n: int) -> torch.Tensor:
        return torch.as_tensor(np.hamming(n), dtype=torch.float32, device=self.device)

    def _mark(self, stage: Optional[str]):
        """Close ``stage`` (None: start the clock) after the device is idle."""
        if self._marks_off:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if stage is not None:
            self.stage_seconds[stage] = now - self._t_mark
        self._t_mark = now

    def _wav_generator(self, seed: int, row: int, chunk: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(stream_seed(seed, row, 1 + chunk))

    @staticmethod
    def _decode_generator(seed: int, row: int) -> torch.Generator:
        return torch.Generator().manual_seed(stream_seed(seed, row, 0))

    def _spk(self, spk_embedding: Optional[np.ndarray]) -> np.ndarray:
        """The prompt-free zero embedding for None (the batched paths, the
        engine and the flow: a speaker row of zeros)."""
        if spk_embedding is None:
            return np.zeros((1, self.cfg.llm.spk_embed_dim), np.float32)
        return np.asarray(spk_embedding, np.float32)

    # ------------------------------------------------------------------
    # multi-voice LoRA serving
    # ------------------------------------------------------------------

    def set_voices(self, voices, llm_scale: float = 2.0, flow_scale: float = 2.0) -> None:
        """Register named LoRA voices served UN-merged: one base model, about
        2 M adapter parameters a voice, routed per request (the reference
        can only merge each voice into a full model copy).

        ``voices``: ordered ``{name: {"llm": adapter dict | None, "flow":
        adapter dict | None}}``, flat ``<param path>.lora_A/B`` dicts as the
        trainer makes them or ``serve.load_voice_adapters`` reads them
        (tensors or arrays).  Every voice must cover the same llm adapter
        keys and shapes; flow adapters may be left out per voice.
        ``llm_scale`` / ``flow_scale`` are the adapters' alpha / r (2.0 at
        the reference's defaults).  Everything is built once, here, on the
        pipeline's device, detached (the kernels refuse a tensor that needs
        a gradient)."""
        from ..lora import _frozen_tensor, stack_voice_loras

        names = list(voices)
        llm_dicts = [voices[n].get("llm") for n in names]
        if any(d is not None for d in llm_dicts):
            if any(d is None for d in llm_dicts):
                missing = [n for n, d in zip(names, llm_dicts) if d is None]
                raise ValueError(
                    f"voices {missing} lack llm adapters; the voice-stacked "
                    "decode bank needs every voice to cover the same keys")
            bank = stack_voice_loras(llm_dicts, self.device)
            L._stack_decode_loras(bank, self.cfg.llm.llm.num_blocks)  # refuse early
            # one extra ALL-ZERO row (vid == len(names)): the base voice of
            # mixed batches, an exactly zero delta, so unvoiced rows decode
            # bit-identically to the adapter-free decode
            self._voice_llm_bank = {k: torch.cat([v, torch.zeros_like(v[:1])])
                                    for k, v in bank.items()}
        else:
            self._voice_llm_bank = None
        self._voice_flow = [
            None if voices[n].get("flow") is None
            else {k: _frozen_tensor(v, self.device) for k, v in voices[n]["flow"].items()}
            for n in names]
        self._voice_names = names
        self._llm_lora_scale = float(llm_scale)
        self._flow_lora_scale = float(flow_scale)

    @property
    def voice_names(self) -> List[str]:
        """Registered voice names (``set_voices``); [] when unset.  A copy."""
        return list(self._voice_names)

    def _voice_index(self, voice: str) -> int:
        try:
            return self._voice_names.index(voice)
        except ValueError:
            raise KeyError(f"unknown voice {voice!r}; registered: {self._voice_names} "
                           "(set_voices)") from None

    def _voice(self, voice: Optional[str]):
        """(llm bank, vid, flow adapters) of a request's voice; (None, None,
        None) for the base model.  A lookup: set_voices staged everything."""
        if voice is None:
            return None, None, None
        i = self._voice_index(voice)
        return self._voice_llm_bank, (None if self._voice_llm_bank is None else i), \
            self._voice_flow[i]

    def _voice_batch(self, voices: Optional[Sequence[Optional[str]]]):
        """(llm bank, vids) for per-row routing in a shared decode, or (None,
        None) when no row needs LLM adapters.  Unvoiced rows ("" / None)
        take the bank's trailing all-zero row.  Names are always checked,
        so a flow-only registry still refuses an unknown voice."""
        if voices is None or all(not v for v in voices):
            return None, None
        base = len(self._voice_names)
        vids = [self._voice_index(v) if v else base for v in voices]
        if self._voice_llm_bank is None:
            return None, None
        return self._voice_llm_bank, vids

    # ------------------------------------------------------------------
    # stage 1: AR speech-token generation
    # ------------------------------------------------------------------

    def _build_prefix(self, text_tokens: np.ndarray, prompt_text: Optional[np.ndarray],
                      prompt_speech_token: Optional[np.ndarray],
                      spk_embedding: Optional[np.ndarray], max_len_cap: int,
                      voice: Optional[str] = None):
        """Pack [sos, spk?, text_enc, task, prompt_speech?]; returns (prefix
        (1, L0, D), min_len, max_len).  The prompt text goes before the text
        into the text encoder; ``spk_embedding=None`` omits the speaker row
        (instruct).  min_len and max_len follow the target text's length
        only.  ``voice`` runs the text encoder and the speaker affine
        through that voice's adapters, as a merged-weights build would."""
        p, cfg = self.llm_p, self.cfg.llm
        bank, vid, _ = self._voice(voice)
        ctx = EVAL if bank is None else Ctx(
            lora=bank, lora_scale=self._llm_lora_scale,
            lora_vids=torch.tensor([vid], dtype=torch.long, device=self.device))
        tt = np.asarray(text_tokens)
        n_prompt = 0
        if prompt_text is not None and np.asarray(prompt_text).size:
            n_prompt = np.asarray(prompt_text).shape[1]
            tt = np.concatenate([np.asarray(prompt_text), tt], axis=1)
        tt = torch.as_tensor(tt, dtype=torch.long, device=self.device)
        text_len = tt.shape[1]
        text_enc = L.llm_encode_text(
            p, cfg, tt, torch.full((1,), text_len, dtype=torch.int32, device=self.device), ctx)
        emb = p["llm_embedding.weight"]
        parts = [emb[cfg.sos_eos][None, None]]
        if spk_embedding is not None:
            spk = torch.as_tensor(np.asarray(spk_embedding, np.float32), device=self.device)
            parts.append(dense(p, "spk_embed_affine_layer",
                               L._l2_normalize(spk.to(emb.dtype), dim=1), ctx)[:, None])
        parts += [text_enc, emb[cfg.task_id][None, None]]
        if prompt_speech_token is not None and np.asarray(prompt_speech_token).size:
            pst = torch.as_tensor(np.asarray(prompt_speech_token), dtype=torch.long,
                                  device=self.device).reshape(1, -1)
            parts.append(p["speech_embedding.weight"][pst].to(emb.dtype))
        prefix = torch.cat(parts, dim=1)
        target = text_len - n_prompt
        min_len = int(target * self.icfg.min_token_text_ratio)
        max_len = min(int(target * self.icfg.max_token_text_ratio), max_len_cap)
        return prefix, min_len, max_len

    def _sampling(self) -> dict:
        return dict(top_p=self.icfg.sampling_top_p, top_k=self.icfg.sampling_top_k,
                    win_size=self.icfg.ras_win_size, tau_r=self.icfg.ras_tau_r)

    def _decode_lora(self, voice: Optional[str]) -> dict:
        """The decode's adapter arguments for one request's voice."""
        bank, vid, _ = self._voice(voice)
        if bank is None:
            return {}
        return dict(lora=bank, vids=[vid], lora_scale=self._llm_lora_scale)

    def generate_tokens(self, text_tokens: np.ndarray,
                        spk_embedding: Optional[np.ndarray] = None,
                        max_len_cap: int = 2048,
                        generator: Optional[torch.Generator] = None,
                        prompt_text: Optional[np.ndarray] = None,
                        prompt_speech_token: Optional[np.ndarray] = None,
                        voice: Optional[str] = None) -> np.ndarray:
        """(1, Tt) text ids -> (1, n) speech tokens (the prefix of
        :meth:`_build_prefix`).  ``generator`` is a CPU generator: its
        uniforms are drawn in bulk and sampled on the device."""
        return next(iter(self._token_segments(text_tokens, spk_embedding, max_len_cap,
                                              generator, prompt_text, prompt_speech_token,
                                              voice, stream=False)))[0]

    def generate_tokens_stream(self, text_tokens: np.ndarray,
                               spk_embedding: Optional[np.ndarray] = None,
                               max_len_cap: int = 2048,
                               generator: Optional[torch.Generator] = None,
                               prompt_text: Optional[np.ndarray] = None,
                               prompt_speech_token: Optional[np.ndarray] = None,
                               voice: Optional[str] = None
                               ) -> Iterator[Tuple[np.ndarray, bool]]:
        """Yields (tokens so far (1, n), done) after each decode segment:
        the first ends after first_hop + overlap tokens, each later one a hop
        further.  The tokens equal ``generate_tokens``'s with the same
        generator: the segments are one paused and resumed decode."""
        return self._token_segments(text_tokens, spk_embedding, max_len_cap, generator,
                                    prompt_text, prompt_speech_token, voice, stream=True)

    def _token_segments(self, text_tokens, spk_embedding, max_len_cap, generator,
                        prompt_text, prompt_speech_token, voice, stream: bool):
        prefix, min_len, max_len = self._build_prefix(
            text_tokens, prompt_text, prompt_speech_token, spk_embedding, max_len_cap, voice)
        state = L.llm_decode_start(self.llm_p, self.cfg.llm, prefix, [prefix.shape[1]],
                                   [min_len], [max_len], [generator], **self._sampling(),
                                   **self._decode_lora(voice), step_p=self.llm_step_p)
        target = min(self.first_hop + self.token_overlap_len, max_len) if stream else None
        seg = state.launch(target)
        while True:
            # segment k + 1 is enqueued ahead of segment k's read (the JAX
            # package's dispatch pipelining; its first chunk now, the rest
            # at the next advance: models/decode.py).  The tokens are
            # unchanged, and a segment after the last token stops after a
            # chunk of steps
            nxt = None
            if stream and target < max_len:
                nxt_target = min(target + self.token_min_hop_len, max_len)
                nxt = state.launch(nxt_target, ahead=True)
            seg.wait()
            done = state.done[0]
            yield np.asarray(state.tokens[0], np.int64)[None, :], done
            if done:
                return
            seg, target = nxt, nxt_target

    # ------------------------------------------------------------------
    # stage 2+3: tokens -> mel -> wav
    # ------------------------------------------------------------------

    def _select_nfe(self, mel_len: int) -> int:
        """Euler steps by true mel length: 10 / 15 / 20; the fixed few-step
        count under the distilled MeanFlow sampler."""
        if self.icfg.sampler == "meanflow":
            return self.icfg.meanflow_steps
        if mel_len > self.icfg.nfe_long_threshold:
            return self.icfg.nfe_long
        if mel_len > self.icfg.nfe_mid_threshold:
            return self.icfg.nfe_mid
        return self.icfg.nfe_short

    def _mel_len(self, n_tokens: int) -> int:
        return int(n_tokens / self.cfg.flow.input_frame_rate * 22050 / 256)

    def _flow_kw(self, voice: Optional[str]) -> dict:
        """flow_inference's adapter and mel-space arguments for a voice: a
        voice's fine-tuned flow adapters work in normalized mel space, so
        they take the denormalization whatever the base pipeline's
        ``finetuned_norm``."""
        _, _, flow_lora = self._voice(voice)
        return dict(finetuned_norm=self.finetuned_norm or flow_lora is not None,
                    mel_norm=(self.cfg.mel_mean, self.cfg.mel_std),
                    lora=flow_lora, lora_scale=self._flow_lora_scale,
                    sampler=self.icfg.sampler)

    def token2wav(self, token: np.ndarray, spk_embedding: np.ndarray,
                  prompt_token: Optional[np.ndarray] = None,
                  prompt_feat: Optional[np.ndarray] = None, speed: float = 1.0,
                  generator: Optional[torch.Generator] = None,
                  z: Optional[torch.Tensor] = None,
                  hift_phase: Optional[torch.Tensor] = None,
                  hift_noise: Optional[torch.Tensor] = None,
                  stream_state: Optional[StreamState] = None,
                  finalize: bool = True, voice: Optional[str] = None) -> np.ndarray:
        """Flow solve, anti-leakage boundary trim, optional speed change and
        HiFT -> (1, n) float32 waveform.  ``z`` / ``hift_phase`` /
        ``hift_noise`` inject the random draws (tests); otherwise they come
        from ``generator`` (a generator on the pipeline's device).  A flow
        prompt (``prompt_token`` and its raw mel ``prompt_feat``) conditions
        the solve, and its region is dropped from the output.  ``voice``
        applies that voice's flow adapters un-merged.

        Streaming: ``stream_state`` carries the flow cache, the mel overlap
        and HiFT's mel, source and wav tails from one window to the next and
        is updated in place; a prompt goes into every window.  A window that
        is not the last (``finalize`` False) holds back its last
        mel_overlap frames for the next window's fade and source_cache
        samples for the next wav's.  The last window, when ``bucket_final``
        holds and it is prompt-free at speed 1 with 0 < n <= the token
        bucket, is padded to the bucket with its true length masked
        (:meth:`_token2wav_final_bucketed`)."""
        wav = self._token2wav(token, spk_embedding, prompt_token, prompt_feat, speed, generator,
                              z, hift_phase, hift_noise, stream_state, finalize, voice)
        wav = wav.float().cpu().numpy()
        self._mark("hift")
        return wav

    def _token2wav(self, token, spk_embedding, prompt_token, prompt_feat, speed, generator, z,
                   hift_phase, hift_noise, stream_state, finalize, voice) -> torch.Tensor:
        """:meth:`token2wav`'s (1, n) waveform, left on the device."""
        if speed != 1.0 and stream_state is not None and stream_state.hift_mel is not None:
            # the speed change would stretch the crossfade-cache region
            raise ValueError("speed change only supports non-stream inference mode")
        dev = self.device
        flow_kw = self._flow_kw(voice)
        self._mark(None)
        prompt_token = np.zeros((1, 0), np.int64) if prompt_token is None else prompt_token
        prompt_feat = np.zeros((1, 0, 80), np.float32) if prompt_feat is None else prompt_feat
        if (self.icfg.sampler == "meanflow" and prompt_token.shape[1]
                and not getattr(self, "_warned_mf_prompt", False)):
            # the distiller trains the student prompt-free (zero conds):
            # prompted conds are out of its distribution
            print("WARNING: meanflow sampler with a prompt - the distilled student was "
                  "trained prompt-free; expect degraded output (use the euler sampler for "
                  "prompted synthesis)")
            self._warned_mf_prompt = True
        if (self.icfg.bucket_final and stream_state is not None and finalize
                and speed == 1.0 and prompt_token.shape[1] == 0 and prompt_feat.shape[1] == 0
                and 0 < token.shape[1] <= self._final_tok_bucket):
            return self._token2wav_final_bucketed(token, spk_embedding, stream_state,
                                                  generator, z, hift_phase, hift_noise,
                                                  flow_kw)
        st = stream_state
        mel_len = prompt_feat.shape[1] + self._mel_len(token.shape[1])
        out = F.flow_inference(
            self.flow_p, self.cfg.flow,
            torch.as_tensor(token, dtype=torch.long, device=dev),
            torch.as_tensor(prompt_token, dtype=torch.long, device=dev),
            torch.as_tensor(prompt_feat, dtype=torch.float32, device=dev),
            torch.as_tensor(spk_embedding, dtype=torch.float32, device=dev),
            n_timesteps=self._select_nfe(mel_len), generator=generator, z=z,
            flow_cache=None if st is None else st.flow_cache,
            return_cache=st is not None and not finalize, **flow_kw)
        mel = out[0] if st is not None and not finalize else out
        trim = int(prompt_feat.shape[1] * self.icfg.boundary_trim_ratio)
        if trim > 0 and mel.shape[2] > trim:
            mel = mel[:, :, trim:]
        cache_source = None
        if st is not None:
            if not finalize:
                st.flow_cache = out[1]
            if st.mel_overlap is not None:
                mel = fade_in_out(mel, st.mel_overlap, self.mel_window)
            if st.hift_mel is not None:
                mel = torch.cat([st.hift_mel, mel], dim=2)
                cache_source = st.hift_source
            if not finalize:
                st.mel_overlap = mel[:, :, -self.mel_overlap_len:]
                mel = mel[:, :, :-self.mel_overlap_len]
        if speed != 1.0 and finalize:
            mel = F.interpolate_linear(mel, int(mel.shape[2] / speed))
        self._mark("flow")
        wav, source = H.hift_inference(self.hift_p, self.cfg.hift, mel, generator,
                                       hift_phase, hift_noise, cache_source)
        if st is not None:
            if st.hift_speech is not None:
                wav = fade_in_out(wav, st.hift_speech, self.speech_window)
            if not finalize:
                st.hift_mel = mel[:, :, -self.mel_cache_len:]
                st.hift_source = source[:, :, -self.source_cache_len:]
                st.hift_speech = wav[:, -self.source_cache_len:]
                wav = wav[:, :-self.source_cache_len]
        return wav

    def _token2wav_final_bucketed(self, token, spk_embedding, st: StreamState, generator,
                                  z, hift_phase, hift_noise, flow_kw) -> torch.Tensor:
        """The last streaming window at the one token bucket: the flow
        solve, the fade and HiFT run at the bucket's length with the true
        length masked, and the wav is cut back to the true length.  NFE
        follows the true mel length."""
        dev = self.device
        n = token.shape[1]
        mel2 = self._mel_len(n)
        tok = torch.zeros((1, self._final_tok_bucket), dtype=torch.long, device=dev)
        tok[:, :n] = torch.as_tensor(token, dtype=torch.long, device=dev)
        mel = F.flow_inference(
            self.flow_p, self.cfg.flow, tok, torch.zeros((1, 0), dtype=torch.long, device=dev),
            torch.zeros((1, 0, 80), device=dev),
            torch.as_tensor(spk_embedding, dtype=torch.float32, device=dev),
            n_timesteps=self._select_nfe(mel2), generator=generator, z=z,
            flow_cache=st.flow_cache, token_valid=n, mel_valid=mel2, **flow_kw)
        valid = mel2
        if st.mel_overlap is not None:
            mel = fade_in_out(mel, st.mel_overlap, self.mel_window, valid=mel2)
        if st.hift_mel is not None:
            mel = torch.cat([st.hift_mel, mel], dim=2)
            valid += st.hift_mel.shape[2]
        self._mark("flow")
        wav, _ = H.hift_inference(self.hift_p, self.cfg.hift, mel, generator, hift_phase,
                                  hift_noise, st.hift_source, mel_valid=valid)
        if st.hift_speech is not None:
            wav = fade_in_out(wav, st.hift_speech, self.speech_window)
        return wav[:, :valid * 256]

    # ------------------------------------------------------------------
    # streaming
    # ------------------------------------------------------------------

    def stream_plan(self, n_tokens: int) -> List[Tuple[int, int, int]]:
        """The (start, end, wav samples) of each chunk that streaming cuts
        from ``n_tokens`` prompt-free tokens: windows of hop + overlap
        tokens, the first advancing by first_hop and the rest by the hop,
        then the rest as the last window.  A window that is not the
        last emits its mel less the overlap, plus the previous window's mel
        cache, less the source cache; the last emits its whole mel plus the
        cache."""
        hop, ov = self.token_min_hop_len, self.token_overlap_len
        cur, plan, pos, cache = self.first_hop, [], 0, 0
        while n_tokens - pos >= cur + ov:
            mel = cache + self._mel_len(cur + ov) - self.mel_overlap_len
            plan.append((pos, pos + cur + ov, 256 * mel - self.source_cache_len))
            pos, cur, cache = pos + cur, hop, self.mel_cache_len
        plan.append((pos, n_tokens, 256 * (cache + self._mel_len(n_tokens - pos))))
        return plan

    def stream_chunks(self, cur: StreamCursor, tokens: np.ndarray,
                      done: bool) -> Iterator[np.ndarray]:
        """The (1, n) wavs of the windows that ``tokens`` (the stream's
        tokens so far) already fill, advancing ``cur``: hop + overlap
        tokens each, the cursor's hop first and the pipeline's after, then
        the rest as the last window once ``done``.  Every window takes the
        cursor's flow prompt and voice."""
        ov = self.token_overlap_len
        kw = dict(prompt_token=cur.prompt_token, prompt_feat=cur.prompt_feat,
                  stream_state=cur.state, voice=cur.voice)
        while tokens.shape[1] - cur.pos >= cur.hop + ov:
            yield self.token2wav(tokens[:, cur.pos:cur.pos + cur.hop + ov], cur.spk,
                                 generator=self._wav_generator(cur.seed, cur.row, cur.chunk),
                                 finalize=False, **kw)
            cur.pos, cur.hop, cur.chunk = cur.pos + cur.hop, self.token_min_hop_len, cur.chunk + 1
        if done:
            yield self.token2wav(tokens[:, cur.pos:], cur.spk,
                                 generator=self._wav_generator(cur.seed, cur.row, cur.chunk),
                                 finalize=True, **kw)

    def stream_token2wav(self, producer: Iterable[Tuple[np.ndarray, bool]],
                         spk_embedding: np.ndarray, seed: int = 0,
                         prompt_token: Optional[np.ndarray] = None,
                         prompt_feat: Optional[np.ndarray] = None,
                         voice: Optional[str] = None) -> Iterator[np.ndarray]:
        """Cut the (tokens so far, done) pairs of ``producer`` into windows
        (:meth:`stream_plan`'s geometry, the first advancing by first_hop)
        and yield each window's (1, n) wav as soon as its tokens exist."""
        cur = StreamCursor(spk_embedding, seed, 0, self.first_hop, prompt_token=prompt_token,
                           prompt_feat=prompt_feat, voice=voice)
        for tokens, done in producer:
            yield from self.stream_chunks(cur, tokens, done)
            if done:
                return

    # ------------------------------------------------------------------
    # full pipeline
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def synthesize(self, text_tokens: Optional[np.ndarray] = None,
                   prompt_text: Optional[np.ndarray] = None,
                   prompt_speech_token: Optional[np.ndarray] = None,
                   prompt_feat: Optional[np.ndarray] = None,
                   spk_embedding: Optional[np.ndarray] = None,
                   llm_prompt_speech_token: Optional[np.ndarray] = None,
                   flow_prompt_speech_token: Optional[np.ndarray] = None,
                   llm_embedding: Optional[np.ndarray] = None,
                   flow_embedding: Optional[np.ndarray] = None,
                   source_speech_token: Optional[np.ndarray] = None,
                   stream: bool = False, speed: float = 1.0, voice: Optional[str] = None,
                   max_len_cap: int = 2048, seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Yields {'tts_speech': (1, n) float32} chunks: one, or with
        ``stream`` one a window, the first after first_hop + overlap tokens
        are decoded instead of after the whole utterance (the reference's
        ``CosyVoiceModel.tts``).

        Conditioning is split as in the reference: the ``llm_`` arguments
        go to the decode's prefix (with ``prompt_text``), the ``flow_``
        ones to every flow solve (with ``prompt_feat``, the prompt's raw
        mel); the unprefixed ``prompt_speech_token`` / ``spk_embedding``
        stand for both.  No LLM embedding omits the speaker row
        (instruct); no flow embedding is the zero embedding.
        ``source_speech_token`` is voice conversion: those tokens bypass the
        LLM.  ``voice`` routes the decode and the flow through a registered
        voice's adapters (:meth:`set_voices`).  Random draws are seeded by
        ``seed`` (module docstring)."""
        if stream and speed != 1.0:
            raise ValueError("speed != 1.0 is only supported with stream=False")
        llm_prompt = prompt_speech_token if llm_prompt_speech_token is None \
            else llm_prompt_speech_token
        flow_prompt = prompt_speech_token if flow_prompt_speech_token is None \
            else flow_prompt_speech_token
        llm_emb = spk_embedding if llm_embedding is None else llm_embedding
        flow_emb = self._spk(spk_embedding if flow_embedding is None else flow_embedding)
        vc_tokens = None
        if source_speech_token is not None and np.asarray(source_speech_token).size:
            vc_tokens = np.asarray(source_speech_token, np.int64).reshape(1, -1)
        self.stage_seconds = {}
        decode = dict(prompt_text=prompt_text, prompt_speech_token=llm_prompt, voice=voice)
        if stream:
            producer = iter([(vc_tokens, True)]) if vc_tokens is not None else \
                self.generate_tokens_stream(text_tokens, llm_emb, max_len_cap,
                                            self._decode_generator(seed, 0), **decode)
            for wav in self.stream_token2wav(producer, flow_emb, seed, flow_prompt,
                                             prompt_feat, voice):
                yield {"tts_speech": wav}
            return
        self._mark(None)
        tokens = vc_tokens if vc_tokens is not None else self.generate_tokens(
            text_tokens, llm_emb, max_len_cap, self._decode_generator(seed, 0), **decode)
        self._mark("decode")
        wav = self.token2wav(tokens, flow_emb, flow_prompt, prompt_feat, speed=speed,
                             generator=self._wav_generator(seed, 0, 0), voice=voice)
        yield {"tts_speech": wav}

    def _decode_batch(self, text_tokens_list: Sequence[np.ndarray], spks: List[np.ndarray],
                      max_len_cap: int, seed: int,
                      voices: Optional[Sequence[Optional[str]]] = None) -> L.DecodeState:
        """Prefill the requests as one left-padded batch; row b decodes from
        ``stream_seed(seed, b, 0)``, as a solo request with that seed does,
        through its voice's adapters (``voices``; the base model for "" or
        None)."""
        voices = list(voices) if voices is not None else [None] * len(text_tokens_list)
        built = [self._build_prefix(t, None, None, s, max_len_cap, v or None)
                 for t, s, v in zip(text_tokens_list, spks, voices)]
        bank, vids = self._voice_batch(voices)
        prefix, valid, min_lens, max_lens = _batch_prefixes(built)
        lora = {} if bank is None else dict(lora=bank, vids=vids,
                                            lora_scale=self._llm_lora_scale)
        return L.llm_decode_start(self.llm_p, self.cfg.llm, prefix, valid, min_lens, max_lens,
                                  [self._decode_generator(seed, b) for b in range(len(built))],
                                  **self._sampling(), **lora, step_p=self.llm_step_p)

    @torch.inference_mode()
    def synthesize_batch(self, text_tokens_list: Sequence[np.ndarray], spk_embeddings=None,
                         speed=1.0, max_len_cap: int = 2048, seed: int = 0,
                         voices: Optional[Sequence[Optional[str]]] = None) -> List[np.ndarray]:
        """Micro-batched whole-utterance synthesis (prompt-free: a None
        embedding is the zero one): one batched decode shares each step's
        weight reads across the requests, then flow and HiFT run per
        request.  Returns a (1, n) wav per request; request b's draws are
        row b's (module docstring).  ``voices`` routes each row through its
        registered voice inside the shared decode; mixed voiced and base
        rows are fine."""
        B = len(text_tokens_list)
        spks = [self._spk(s) for s in (spk_embeddings or [None] * B)]
        speeds = list(speed) if isinstance(speed, (list, tuple)) else [speed] * B
        voices = list(voices) if voices is not None else [None] * B
        state = self._decode_batch(text_tokens_list, spks, max_len_cap, seed, voices).run()
        # every request's token2wav is enqueued before any wav is read (the
        # JAX package's dispatch of every fused token2wav before a sync)
        self._marks_off = True
        try:
            wavs = [self._token2wav(np.asarray(state.tokens[b], np.int64)[None], spks[b], None,
                                    None, speeds[b], self._wav_generator(seed, b, 0), None, None,
                                    None, None, True, voices[b] or None)
                    for b in range(B)]
        finally:
            self._marks_off = False
        return [w.float().cpu().numpy() for w in wavs]

    @torch.inference_mode()
    def synthesize_stream_batch(self, text_tokens_list: Sequence[np.ndarray],
                                spk_embeddings=None, max_len_cap: int = 2048, seed: int = 0,
                                voices: Optional[Sequence[Optional[str]]] = None
                                ) -> Iterator[Tuple[int, np.ndarray, bool]]:
        """Batched streaming (prompt-free): one lock-step segmented decode
        shares each step's weight reads across the streams, and each stream
        emits hop-sized chunks with the overlap and fades of
        :meth:`synthesize`.  Yields (request index, wav (1, n), last).
        ``voices`` as in :meth:`synthesize_batch`."""
        B = len(text_tokens_list)
        spks = [self._spk(s) for s in (spk_embeddings or [None] * B)]
        voices = list(voices) if voices is not None else [None] * B
        state = self._decode_batch(text_tokens_list, spks, max_len_cap, seed, voices)
        hop = self.token_min_hop_len
        curs = [StreamCursor(spks[b], seed, b, hop, voice=voices[b] or None) for b in range(B)]
        finished = [False] * B
        target = hop + self.token_overlap_len
        seg = state.launch(target)
        while not all(finished):
            nxt = state.launch(target + hop, ahead=True)  # before this segment's read
            seg.wait()
            for b in range(B):
                if finished[b]:
                    continue
                finished[b] = state.done[b]
                wavs = list(self.stream_chunks(
                    curs[b], np.asarray(state.tokens[b], np.int64)[None], finished[b]))
                for i, wav in enumerate(wavs):
                    yield b, wav, finished[b] and i == len(wavs) - 1
            seg, target = nxt, target + hop


def shard_pipeline(mesh, llm_p: P, llm_step_p: P, flow_p: P):
    """A pipeline's split views, each carrying its layout (``P.split``):
    (LLM, its step view, flow, (LLM leaves split, flow leaves split)).  The
    step view's own leaves (int8 matrices and their scales) split by the
    LLM's rule; the leaves it shares with the LLM stay shared."""
    llm, llm_layout = TP.shard_params(mesh, llm_p.d)
    step, step_layout = llm, llm_layout
    if llm_step_p is not llm_p:
        own = {k: v for k, v in llm_step_p.d.items() if llm_p.d.get(k) is not v}
        own, own_layout = TP.shard_params(mesh, own)
        step, step_layout = {**llm, **own}, {**llm_layout, **own_layout}
    flow, flow_layout = TP.shard_params(mesh, flow_p.d)

    def view(d, prefix, layout):
        return P(d, prefix, TP.make_split(mesh, layout))

    return (view(llm, llm_p.prefix, llm_layout), view(step, llm_step_p.prefix, step_layout),
            view(flow, flow_p.prefix, flow_layout),
            (TP.count_sharded(llm_layout), TP.count_sharded(flow_layout)))
