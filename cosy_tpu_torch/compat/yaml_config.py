"""Model-dir ``cosyvoice.yaml`` topology ingestion (the port's copy of the
JAX package's ``compat/yaml_config.py``).

The reference instantiates its whole model graph from the model dir's
hyperpyyaml file (cosyvoice/cli/cosyvoice.py:35-54, bin/train.py:104-115).
No object constructor is executed: this module parses the hyperpyyaml tag
subset the CosyVoice yamls use (``!new:``, ``!name:``, ``!apply:``, ``!ref
<key>``) into plain dicts and maps the shape and flag kwargs onto the typed
dataclasses of :mod:`cosy_tpu_torch.config`, so a checkpoint with a variant
topology (other num_blocks, heads, channels) loads without code edits.

PyYAML is imported inside the parser only: a model dir without a
``cosyvoice.yaml`` never needs it.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, Optional

from ..config import (
    CFMConfig, EncoderConfig, EstimatorConfig, FlowConfig, HiFTConfig,
    InferenceConfig, LLMConfig, ModelConfig, replace,
)

# ---------------------------------------------------------------------------
# hyperpyyaml-subset parser
# ---------------------------------------------------------------------------


class _Ref:
    def __init__(self, key: str):
        self.key = key


def _make_loader():
    import yaml

    class Loader(yaml.SafeLoader):
        pass

    def tagged(prefix):
        def construct(loader, suffix, node):
            if isinstance(node, yaml.MappingNode):
                d = loader.construct_mapping(node, deep=True)
            elif isinstance(node, yaml.SequenceNode):
                d = {"__args__": loader.construct_sequence(node, deep=True)}
            else:
                scalar = loader.construct_scalar(node)
                d = {"__args__": [scalar]} if scalar else {}
            d["__target__"] = suffix
            return d
        return construct

    for prefix in ("!new:", "!name:", "!apply:", "!module:"):
        Loader.add_multi_constructor(prefix, tagged(prefix))

    def ref(loader, node):
        return _Ref(loader.construct_scalar(node))

    Loader.add_constructor("!ref", ref)
    return Loader


_REF_RE = re.compile(r"^<([^<>]+)>$")


def _resolve(obj: Any, root: Dict[str, Any]) -> Any:
    if isinstance(obj, _Ref):
        m = _REF_RE.match(obj.key.strip())
        if m and m.group(1) in root:
            return _resolve(root[m.group(1)], root)
        return obj.key
    if isinstance(obj, dict):
        return {k: _resolve(v, root) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_resolve(v, root) for v in obj]
    return obj


def parse_hyperyaml(path_or_text: str) -> Dict[str, Any]:
    """Parse a cosyvoice.yaml into plain dicts (no object instantiation).

    Tagged nodes become dicts with a ``__target__`` key holding the
    ``module.Class`` path; ``!ref <key>`` resolves against top-level keys.
    """
    import yaml

    text = path_or_text
    if os.path.exists(path_or_text):
        with open(path_or_text) as f:
            text = f.read()
    raw = yaml.load(text, Loader=_make_loader())
    if not isinstance(raw, dict):
        raise ValueError("cosyvoice.yaml must be a mapping at top level")
    return {k: _resolve(v, raw) for k, v in raw.items()}


# ---------------------------------------------------------------------------
# dataclass mapping
# ---------------------------------------------------------------------------


def _strip(d: Any) -> Dict[str, Any]:
    return {k: v for k, v in d.items() if not k.startswith("__")} \
        if isinstance(d, dict) else {}


def _target(d: Any) -> str:
    return d.get("__target__", "").rsplit(".", 1)[-1] if isinstance(d, dict) else ""


def _fill(cls, kwargs: Dict[str, Any], base=None):
    """Overlay yaml kwargs onto dataclass defaults, keeping only known
    fields; lists become tuples (nested for e.g. resblock dilations)."""
    names = {f.name for f in dataclasses.fields(cls)}

    def conv(v):
        if isinstance(v, list):
            return tuple(conv(x) for x in v)
        return v

    picked = {k: conv(v) for k, v in kwargs.items() if k in names}
    return replace(base, **picked) if base is not None else cls(**picked)


def _encoder(d: Any, base: EncoderConfig) -> EncoderConfig:
    return _fill(EncoderConfig, _strip(d), base=base)


def model_config_from_yaml(path_or_text: str,
                           base: Optional[ModelConfig] = None) -> ModelConfig:
    """Map a CosyVoice (v1) cosyvoice.yaml onto :class:`ModelConfig`."""
    cfg = base or ModelConfig()
    y = parse_hyperyaml(path_or_text)

    llm_y = y.get("llm") or {}
    if llm_y:
        lk = _strip(llm_y)
        llm = _fill(LLMConfig, lk, base=cfg.llm)
        if "text_encoder" in lk:
            llm = replace(llm, text_encoder=_encoder(lk["text_encoder"],
                                                     cfg.llm.text_encoder))
        if isinstance(lk.get("llm"), dict):
            inner = _encoder(lk["llm"], cfg.llm.llm)
            if _target(lk["llm"]) == "TransformerEncoder":
                inner = replace(inner, input_layer=cfg.llm.llm.input_layer)
            llm = replace(llm, llm=inner)
        cfg = replace(cfg, llm=llm)

    flow_y = y.get("flow") or {}
    if flow_y:
        fk = _strip(flow_y)
        flow = _fill(FlowConfig, fk, base=cfg.flow)
        if "encoder" in fk:
            flow = replace(flow, encoder=_encoder(fk["encoder"], cfg.flow.encoder))
        if isinstance(fk.get("length_regulator"), dict):
            ratios = _strip(fk["length_regulator"]).get("sampling_ratios")
            if ratios:
                flow = replace(flow, regulator_stages=len(ratios))
        dec = fk.get("decoder")
        if isinstance(dec, dict):
            dk = _strip(dec)
            cfm_params = dk.get("cfm_params")
            if isinstance(cfm_params, dict):
                content = _strip(cfm_params).get("content", _strip(cfm_params))
                flow = replace(flow, cfm=_fill(CFMConfig, _strip(content) or content,
                                               base=cfg.flow.cfm))
            if isinstance(dk.get("estimator"), dict):
                flow = replace(flow, estimator=_fill(
                    EstimatorConfig, _strip(dk["estimator"]),
                    base=cfg.flow.estimator))
        cfg = replace(cfg, flow=flow)

    hift_y = y.get("hift") or {}
    if hift_y:
        cfg = replace(cfg, hift=_fill(HiFTConfig, _strip(hift_y), base=cfg.hift))

    if "sample_rate" in y:
        cfg = replace(cfg, sample_rate=int(y["sample_rate"]),
                      hift=replace(cfg.hift, sampling_rate=int(y["sample_rate"])))
    feat = y.get("feat_extractor")
    if isinstance(feat, dict):
        fk = _strip(feat)
        if "hop_size" in fk:
            cfg = replace(cfg, mel_hop=int(fk["hop_size"]))
    return cfg


def inference_config_from_yaml(path_or_text: str,
                               base: Optional[InferenceConfig] = None
                               ) -> InferenceConfig:
    """Pull the RAS sampling knobs out of llm.sampling (yaml
    !name:...ras_sampling top_p/top_k/win_size/tau_r)."""
    cfg = base or InferenceConfig()
    y = parse_hyperyaml(path_or_text)
    samp = _strip(y.get("llm") or {}).get("sampling")
    if isinstance(samp, dict):
        sk = _strip(samp)
        cfg = replace(
            cfg,
            sampling_top_p=float(sk.get("top_p", cfg.sampling_top_p)),
            sampling_top_k=int(sk.get("top_k", cfg.sampling_top_k)),
            ras_win_size=int(sk.get("win_size", cfg.ras_win_size)),
            ras_tau_r=float(sk.get("tau_r", cfg.ras_tau_r)),
        )
    return cfg


def cv2_configs_from_yaml(path_or_text: str, llm_base=None, flow_base=None,
                          hift_base=None):
    """Map a CosyVoice2 cosyvoice.yaml onto (Qwen2LMConfig, Flow2Config,
    HiFTConfig, sample_rate)."""
    from ..models.flow2 import Flow2Config
    from ..models.qwen2lm import Qwen2LMConfig

    y = parse_hyperyaml(path_or_text)
    llm_cfg = llm_base or Qwen2LMConfig()
    flow_cfg = flow_base or Flow2Config()
    hift_cfg = hift_base or HiFTConfig(
        sampling_rate=24000, upsample_rates=(8, 5, 3),
        upsample_kernel_sizes=(16, 11, 7),
        source_resblock_kernel_sizes=(7, 7, 11),
        source_resblock_dilation_sizes=((1, 3, 5),) * 3)  # pipeline2.hift24k_config()

    llm_y = _strip(y.get("llm") or {})
    if llm_y:
        qwen_base = llm_cfg.qwen
        llm_cfg = _fill(Qwen2LMConfig, {k: v for k, v in llm_y.items()
                                        if k != "qwen"}, base=llm_cfg)
        # explicit qwen topology block (the stock yaml points at a HF
        # pretrain_path instead; variant/synthetic yamls can spell dims out)
        if isinstance(llm_y.get("qwen"), dict):
            from ..layers.qwen2 import Qwen2Config

            llm_cfg = replace(llm_cfg, qwen=_fill(
                Qwen2Config, _strip(llm_y["qwen"]), base=qwen_base))

    flow_y = _strip(y.get("flow") or {})
    if flow_y:
        enc_base = flow_cfg.encoder
        flow_cfg = _fill(Flow2Config, flow_y, base=flow_cfg)
        if "encoder" in flow_y:
            flow_cfg = replace(flow_cfg, encoder=_encoder(
                flow_y["encoder"], enc_base))
        dec = flow_y.get("decoder")
        if isinstance(dec, dict):
            dk = _strip(dec)
            cfm_params = dk.get("cfm_params")
            if isinstance(cfm_params, dict):
                content = _strip(cfm_params).get("content", _strip(cfm_params))
                flow_cfg = replace(flow_cfg, cfm=_fill(
                    CFMConfig, _strip(content) or content, base=flow_cfg.cfm))
            if isinstance(dk.get("estimator"), dict):
                flow_cfg = replace(flow_cfg, estimator=_fill(
                    EstimatorConfig, _strip(dk["estimator"]),
                    base=flow_cfg.estimator))
    hift_y = _strip(y.get("hift") or {})
    if hift_y:
        hift_cfg = _fill(HiFTConfig, hift_y, base=hift_cfg)
    sample_rate = int(y.get("sample_rate", hift_cfg.sampling_rate))
    return llm_cfg, flow_cfg, hift_cfg, sample_rate
