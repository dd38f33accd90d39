"""The user API (the port of the JAX package's ``api.py``): ``CosyVoice``
and ``CosyVoice2`` load a model dir and synthesize in every mode of the
reference's ``cosyvoice/cli/cosyvoice.py``.

- CosyVoice: ``inference_sft`` (a registered speaker), ``inference_zero_shot``
  (a prompt wav and its text), ``inference_cross_lingual`` (a prompt wav, no
  LLM prompt), ``inference_instruct`` (a registered speaker and an
  instruction; no LLM speaker row) and ``inference_vc`` (voice conversion:
  the source's speech tokens bypass the LLM).
- CosyVoice2: the same, with ``inference_instruct2`` (an instruction and a
  prompt wav) in place of ``inference_instruct``.
- ``list_available_spks``, ``add_zero_shot_spk``, ``save_spkinfo``: the
  speaker registry (``spk2info.pt`` of the model dir).

Every mode yields ``{"tts_speech": (1, n) float32}`` chunks: one a text
segment, or one a streaming window.  Weights come from the model dir's
``llm.pt`` / ``flow.pt`` / ``hift.pt`` (``compat.loader``), the topology
from its ``cosyvoice.yaml`` when there is one (``compat.yaml_config``), the
frontend is ``data.frontend.Frontend``; ``flow_state`` (a flow state dict,
the server's ``--flow-weights``) takes the place of ``flow.pt``.  Everything
runs on CUDA unless the caller passes another ``device``; without a card
that raises.

Randomness: the API keeps a request counter ``_n``; request n (from 1)
synthesizes with the seed ``stream_seed(seed, n, 0) = seed + n * 2**32``
(``_next_seed``), whose decode and wav-chunk generators are those of
``TTSPipeline.synthesize`` (``infer.pipeline``): ``seed + n * 2**32`` and
``seed + n * 2**32 + 1 + k``.  Two requests never share a generator, and
the same ``seed`` replays the same requests.  The JAX package folds the
counter into one PRNG key instead (``jax.random.fold_in``).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from .compat.loader import load_modules
from .config import HiFTConfig, InferenceConfig, ModelConfig
from .data.frontend import Frontend
from .infer.pipeline import TTSPipeline, stream_seed
from .models.flow import Flow
from .models.hift import HiFT
from .models.llm import TransformerLM
from .params import resolve_device


class CosyVoice:
    """CosyVoice-300M (cosyvoice.py:27-139) over ``TTSPipeline``."""

    def __init__(self, model_dir: str, model_cfg: Optional[ModelConfig] = None,
                 infer_cfg: Optional[InferenceConfig] = None, finetuned_norm: bool = False,
                 seed: int = 0, device=None, flow_state: Optional[dict] = None):
        self.model_dir = model_dir
        self.device = resolve_device(device)
        yaml_path = os.path.join(model_dir, "cosyvoice.yaml")
        if model_cfg is None and os.path.exists(yaml_path):
            # variant num_blocks / heads / channels load without code edits
            from .compat.yaml_config import inference_config_from_yaml, model_config_from_yaml

            model_cfg = model_config_from_yaml(yaml_path)
            if infer_cfg is None:
                infer_cfg = inference_config_from_yaml(yaml_path)
        self.cfg = model_cfg or ModelConfig()
        self.sample_rate = self.cfg.sample_rate
        mods = load_modules(model_dir, {"llm": (TransformerLM, self.cfg.llm),
                                        "flow": (Flow, self.cfg.flow),
                                        "hift": (HiFT, self.cfg.hift)}, self.device,
                            None if flow_state is None else {"flow": flow_state})
        self.frontend = Frontend(model_dir, self.sample_rate, device=self.device)
        self.model = TTSPipeline(self.cfg, mods["llm"], mods["flow"], mods["hift"],
                                 infer_cfg or InferenceConfig(), finetuned_norm=finetuned_norm)
        self._seed = seed
        self._n = 0

    # ------------------------------------------------------------------

    def _next_seed(self) -> int:
        """The next request's seed (module docstring)."""
        self._n += 1
        return stream_seed(self._seed, self._n, 0)

    def list_available_spks(self):
        return list(self.frontend.spk2info.keys())

    def add_zero_shot_spk(self, prompt_text: str, prompt_speech_16k: np.ndarray,
                          zero_shot_spk_id: str) -> bool:
        """Register a prompt (its text, speech tokens, mel and embedding)
        under ``zero_shot_spk_id`` for later zero-shot and instruct calls."""
        if not zero_shot_spk_id:
            raise ValueError("do not use empty zero_shot_spk_id")
        model_input = self.frontend.frontend_zero_shot("", prompt_text, prompt_speech_16k, "")
        model_input.pop("text", None)
        self.frontend.spk2info[zero_shot_spk_id] = model_input
        return True

    def save_spkinfo(self):
        """Write the speaker registry to the model dir's ``spk2info.pt``."""
        blob = {k: {kk: torch.from_numpy(np.asarray(vv)) if isinstance(vv, np.ndarray) else vv
                    for kk, vv in v.items()}
                for k, v in self.frontend.spk2info.items()}
        torch.save(blob, os.path.join(self.model_dir, "spk2info.pt"))

    # ------------------------------------------------------------------

    def _model_kwargs(self, model_input: dict) -> dict:
        """The pipeline's conditioning from a frontend dict (frontend.py's
        keys)."""
        return dict(
            text_tokens=model_input.get("text"),
            prompt_text=model_input.get("prompt_text"),
            prompt_feat=model_input.get("prompt_speech_feat"),
            llm_prompt_speech_token=model_input.get("llm_prompt_speech_token"),
            flow_prompt_speech_token=model_input.get("flow_prompt_speech_token"),
            llm_embedding=model_input.get("llm_embedding"),
            flow_embedding=model_input.get("flow_embedding"),
            source_speech_token=model_input.get("source_speech_token"),
        )

    def _run(self, model_input: dict, stream: bool, speed: float) -> Iterator[dict]:
        """Synthesize one frontend dict, logging each chunk's RTF."""
        start = time.time()
        for out in self.model.synthesize(stream=stream, speed=speed, seed=self._next_seed(),
                                         **self._model_kwargs(model_input)):
            n = out["tts_speech"].shape[1] / self.sample_rate
            logging.info("yield speech len %.2f, rtf %.3f", n,
                         (time.time() - start) / max(n, 1e-6))
            yield out
            start = time.time()

    def inference_sft(self, tts_text: str, spk_id: str, stream: bool = False,
                      speed: float = 1.0, text_frontend: bool = True):
        for seg in self.frontend.normalize(tts_text, split=True, text_frontend=text_frontend):
            yield from self._run(self.frontend.frontend_sft(seg, spk_id), stream, speed)

    def inference_zero_shot(self, tts_text: str, prompt_text: str,
                            prompt_speech_16k: np.ndarray, zero_shot_spk_id: str = "",
                            stream: bool = False, speed: float = 1.0,
                            text_frontend: bool = True):
        prompt_text = self.frontend.normalize(prompt_text, split=False,
                                              text_frontend=text_frontend)
        for seg in self.frontend.normalize(tts_text, split=True, text_frontend=text_frontend):
            if len(seg) < 0.5 * len(prompt_text):
                logging.warning("synthesis text %s too short vs prompt %s", seg, prompt_text)
            model_input = self.frontend.frontend_zero_shot(seg, prompt_text, prompt_speech_16k,
                                                           zero_shot_spk_id)
            yield from self._run(model_input, stream, speed)

    def inference_cross_lingual(self, tts_text: str, prompt_speech_16k: np.ndarray,
                                zero_shot_spk_id: str = "", stream: bool = False,
                                speed: float = 1.0, text_frontend: bool = True):
        for seg in self.frontend.normalize(tts_text, split=True, text_frontend=text_frontend):
            model_input = self.frontend.frontend_cross_lingual(seg, prompt_speech_16k,
                                                               zero_shot_spk_id)
            yield from self._run(model_input, stream, speed)

    def inference_instruct(self, tts_text: str, spk_id: str, instruct_text: str,
                           stream: bool = False, speed: float = 1.0,
                           text_frontend: bool = True):
        instruct_text = self.frontend.normalize(instruct_text, split=False,
                                                text_frontend=text_frontend)
        for seg in self.frontend.normalize(tts_text, split=True, text_frontend=text_frontend):
            model_input = self.frontend.frontend_instruct(seg, spk_id, instruct_text)
            yield from self._run(model_input, stream, speed)

    def inference_vc(self, source_speech_16k: np.ndarray, prompt_speech_16k: np.ndarray,
                     stream: bool = False, speed: float = 1.0):
        model_input = self.frontend.frontend_vc(source_speech_16k, prompt_speech_16k)
        yield from self._run(model_input, stream, speed)


class CosyVoice2(CosyVoice):
    """CosyVoice2 (cosyvoice.py:142-194): the Qwen2 LM and the causal
    streaming flow at 24 kHz over ``TTS2Pipeline``.  ``inference_instruct``
    gives way to ``inference_instruct2`` (an instruction and a voice
    prompt).  The default HiFT is ``hift24k_config()`` (three source
    resblocks for three upsample stages), as the public yaml spells it."""

    def __init__(self, model_dir: str, llm_cfg=None, flow_cfg=None,
                 hift_cfg: Optional[HiFTConfig] = None,
                 infer_cfg: Optional[InferenceConfig] = None, seed: int = 0, device=None,
                 flow_state: Optional[dict] = None):
        from .infer.pipeline2 import TTS2Pipeline, hift24k_config
        from .models.flow2 import Flow2, Flow2Config
        from .models.qwen2lm import Qwen2LM, Qwen2LMConfig

        self.model_dir = model_dir
        self.device = resolve_device(device)
        self.sample_rate = 24000
        yaml_path = os.path.join(model_dir, "cosyvoice.yaml")
        if llm_cfg is None and flow_cfg is None and hift_cfg is None \
                and os.path.exists(yaml_path):
            from .compat.yaml_config import cv2_configs_from_yaml

            llm_cfg, flow_cfg, hift_cfg, self.sample_rate = cv2_configs_from_yaml(yaml_path)
        llm_cfg = llm_cfg or Qwen2LMConfig()
        flow_cfg = flow_cfg or Flow2Config()
        hift_cfg = hift_cfg or hift24k_config()
        mods = load_modules(model_dir, {"llm": (Qwen2LM, llm_cfg), "flow": (Flow2, flow_cfg),
                                        "hift": (HiFT, hift_cfg)}, self.device,
                            None if flow_state is None else {"flow": flow_state})
        self.frontend = Frontend(model_dir, self.sample_rate, device=self.device)
        hop = int(np.prod(hift_cfg.upsample_rates)) * hift_cfg.istft_hop_len
        self.model = TTS2Pipeline(llm_cfg, flow_cfg, hift_cfg, mods["llm"], mods["flow"],
                                  mods["hift"], infer_cfg or InferenceConfig(), hop_samples=hop)
        self._seed = seed
        self._n = 0

    def _model_kwargs(self, model_input: dict) -> dict:
        """CosyVoice2's LLM has no speaker row: no LLM embedding."""
        kw = super()._model_kwargs(model_input)
        kw.pop("llm_embedding")
        return kw

    def inference_instruct(self, *a, **kw):
        raise NotImplementedError("inference_instruct is CosyVoice(1); use "
                                  "inference_instruct2 (cosyvoice.py:186 semantics)")

    def inference_instruct2(self, tts_text: str, instruct_text: str,
                            prompt_speech_16k: np.ndarray, zero_shot_spk_id: str = "",
                            stream: bool = False, speed: float = 1.0,
                            text_frontend: bool = True):
        for seg in self.frontend.normalize(tts_text, split=True, text_frontend=text_frontend):
            model_input = self.frontend.frontend_zero_shot(
                seg, instruct_text + "<|endofprompt|>", prompt_speech_16k, zero_shot_spk_id)
            # instruct2: no speech-token prompt on the LLM side (frontend.py:240-244)
            model_input.pop("llm_prompt_speech_token", None)
            yield from self._run(model_input, stream, speed)
