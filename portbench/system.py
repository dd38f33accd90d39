"""The system under test, built from a configuration file and a seed.

The weights come from :mod:`portbench.reference.weights` (the frozen
copy's parameter specs, drawn on the device from the seed); the program's
modules are built on the meta device and take those tensors as they are,
by name, so a leaf the program lacks or adds fails the build.  The same
function, with ``reference=True``, builds the frozen copy's pipeline over
weights drawn again from the same seed.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace
from typing import Any, Dict

import torch

from . import spec
from .reference.weights import spec_weights

FROZEN = "portbench.reference.frozen"
# the weight streams of one seed: one a model component
_COMPONENTS = ("llm", "flow", "hift")


def component_seed(seed: int, component: str) -> int:
    return (int(seed) * len(_COMPONENTS) + _COMPONENTS.index(component)) % (1 << 62)


def _mods(root: str) -> SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(config=m("config"), llm=m("models.llm"), flow=m("models.flow"),
                           hift=m("models.hift"), qwen2lm=m("models.qwen2lm"),
                           flow2=m("models.flow2"), pipeline=m("infer.pipeline"),
                           pipeline2=m("infer.pipeline2"))


def program_modules() -> SimpleNamespace:
    return _mods("cosy_tpu_torch")


def reference_modules() -> SimpleNamespace:
    return _mods(FROZEN)


def audio_rate(config: Dict[str, Any]) -> int:
    """Samples a second of the configuration's wav."""
    if config["family"] == "cosyvoice":
        return config["model"]["sample_rate"]
    return config["hift"]["sampling_rate"]


def _module(mod_cls, cfg, weights: Dict[str, torch.Tensor]):
    m = mod_cls(cfg, device="meta")
    m.load_state_dict(weights, strict=True, assign=True)
    for p in m.parameters():
        p.requires_grad_(False)
    return m


def modules(config: Dict[str, Any], seed: int, device, reference: bool = False
            ) -> Dict[str, Any]:
    """The configuration's ``llm``, ``flow`` and ``hift`` modules on
    ``device`` with weights from ``seed``: the program's, or with
    ``reference`` the frozen copy's (over the same weights)."""
    mods = reference_modules() if reference else program_modules()
    frozen = reference_modules()
    fam = config["family"]
    if fam == "cosyvoice":
        mcfg = spec.build(mods.config.ModelConfig, config["model"])
        fcfg = spec.build(frozen.config.ModelConfig, config["model"])
        parts = {
            "llm": (mods.llm.TransformerLM, mcfg.llm, frozen.llm.llm_spec(fcfg.llm)),
            "flow": (mods.flow.Flow, mcfg.flow, frozen.flow.flow_spec(fcfg.flow)),
            "hift": (mods.hift.HiFT, mcfg.hift, frozen.hift.hift_spec(fcfg.hift)),
        }
    elif fam == "cosyvoice2":
        lcfg = spec.build(mods.qwen2lm.Qwen2LMConfig, config["llm"])
        fcfg = spec.build(mods.flow2.Flow2Config, config["flow"])
        hcfg = spec.build(mods.config.HiFTConfig, config["hift"])
        zl = spec.build(frozen.qwen2lm.Qwen2LMConfig, config["llm"])
        zf = spec.build(frozen.flow2.Flow2Config, config["flow"])
        zh = spec.build(frozen.config.HiFTConfig, config["hift"])
        parts = {
            "llm": (mods.qwen2lm.Qwen2LM, lcfg, frozen.qwen2lm.qwen2lm_spec(zl)),
            "flow": (mods.flow2.Flow2, fcfg, frozen.flow2.flow2_spec(zf)),
            "hift": (mods.hift.HiFT, hcfg, frozen.hift.hift_spec(zh)),
        }
    else:
        raise SystemExit(f"unknown model family {fam!r}")
    return {k: _module(cls, c, spec_weights(s, component_seed(seed, k), device))
            for k, (cls, c, s) in parts.items()}


def build(config: Dict[str, Any], seed: int, device, inference: Dict[str, Any],
          reference: bool = False) -> Any:
    """The configuration's pipeline (``TTSPipeline`` or ``TTS2Pipeline``) on
    ``device`` with weights from ``seed``; ``inference`` overrides fields of
    the file's inference config (the traffic's EOS floor).  The program's,
    or with ``reference`` the frozen copy's."""
    mods = reference_modules() if reference else program_modules()
    icfg = spec.build(mods.config.InferenceConfig, {**config["inference"], **inference})
    m = modules(config, seed, device, reference)
    if config["family"] == "cosyvoice":
        mcfg = spec.build(mods.config.ModelConfig, config["model"])
        return mods.pipeline.TTSPipeline(mcfg, m["llm"], m["flow"], m["hift"], icfg,
                                         finetuned_norm=config["finetuned_norm"])
    lcfg = spec.build(mods.qwen2lm.Qwen2LMConfig, config["llm"])
    fcfg = spec.build(mods.flow2.Flow2Config, config["flow"])
    hcfg = spec.build(mods.config.HiFTConfig, config["hift"])
    return mods.pipeline2.TTS2Pipeline(lcfg, fcfg, hcfg, m["llm"], m["flow"], m["hift"],
                                       icfg, hop_samples=config["hop_samples"])


def plain_config(config: Dict[str, Any]) -> SimpleNamespace:
    """The frozen dataclasses of a configuration file, for the cost model
    and the stream geometry."""
    frozen = reference_modules()
    if config["family"] == "cosyvoice":
        return SimpleNamespace(model=spec.build(frozen.config.ModelConfig, config["model"]))
    return SimpleNamespace(llm=spec.build(frozen.qwen2lm.Qwen2LMConfig, config["llm"]),
                           flow=spec.build(frozen.flow2.Flow2Config, config["flow"]),
                           hift=spec.build(frozen.config.HiFTConfig, config["hift"]))

