"""Toy configurations and cells for the CPU tests: the published graphs at
toy widths, driven through the harness's own drivers and checks."""

from __future__ import annotations

import json
import shutil
import types
from pathlib import Path
from typing import Any, Dict

from portbench import spec
from portbench.reference.frozen import config as FC
from portbench.reference.frozen.layers.qwen2 import Qwen2Config
from portbench.reference.frozen.models.flow2 import Flow2Config
from portbench.reference.frozen.models.qwen2lm import Qwen2LMConfig


def config_300m() -> Dict[str, Any]:
    return {"family": "cosyvoice", "model": spec.as_json(FC.tiny_model_config()),
            "inference": spec.as_json(FC.InferenceConfig()), "finetuned_norm": True,
            "train": spec.as_json(FC.TrainConfig(batch_size=2)), "dtype": "float32"}


def config_cv2() -> Dict[str, Any]:
    llm = Qwen2LMConfig(llm_input_size=32, llm_output_size=32, speech_token_size=30,
                        qwen=Qwen2Config(hidden_size=32, intermediate_size=64,
                                         num_hidden_layers=2, num_attention_heads=4,
                                         num_key_value_heads=2, head_dim=8, vocab_size=50))
    flow = Flow2Config(
        input_size=16, output_size=80, spk_embed_dim=12, vocab_size=33,
        encoder=FC.EncoderConfig(input_size=16, output_size=16, attention_heads=2,
                                 linear_units=24, num_blocks=1, static_chunk_size=4),
        num_up_blocks=1,
        estimator=FC.EstimatorConfig(in_channels=320, out_channels=80, channels=(12,),
                                     attention_head_dim=4, n_blocks=1, num_mid_blocks=1,
                                     num_heads=2),
        decoder_static_chunk_size=4)
    hift = FC.HiFTConfig(
        in_channels=80, base_channels=16, nb_harmonics=2, upsample_rates=(8, 8),
        upsample_kernel_sizes=(16, 16), istft_n_fft=16, istft_hop_len=4,
        resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
        source_resblock_kernel_sizes=(3, 3), source_resblock_dilation_sizes=((1,), (1,)),
        f0_predictor_cond_channels=8)
    return {"family": "cosyvoice2", "llm": spec.as_json(llm), "flow": spec.as_json(flow),
            "hift": spec.as_json(hift), "inference": spec.as_json(FC.InferenceConfig()),
            "hop_samples": 256, "dtype": "float32"}


ENGINE = {"clients": 2, "slots": 2, "check_requests": 2, "table": 4,
          "text_ids": {"dist": "loguniform", "min": 10, "max": 14}}
TOKEN2WAV = {"tokens": {"dist": "loguniform", "min": 40, "max": 120}, "table": 3}
TRAIN = {"clips": 12, "clip_s": {"dist": "loguniform", "min": 0.5, "max": 3.0}, "trace_steps": 1}


def cell(config: Dict[str, Any], mix: str, **overrides) -> types.SimpleNamespace:
    """A cell of ``config`` under the mix ``mix`` with ``overrides`` of its
    parameters (the harness reads only these attributes)."""
    return types.SimpleNamespace(
        name=f"tiny.{mix}", config=config, chips=1,
        traffic={**spec.load_json(spec.HERE / "traffic" / f"{mix}.json"), **overrides})


def root(tmp: Path, extra_metrics: Dict[str, str] = None) -> Path:
    """A checkout-like folder at ``tmp`` holding a ``BENCHMARK.json`` of the
    toy configurations and one cell for each of the repository's mixes
    (``tiny.<mix>``), the mixes at toy sizes, the repository's metric files
    and limits for the toy cells: the harness finds all of it by name, as
    it finds the checkout's.  ``extra_metrics`` adds metric files by name."""
    data = tmp / spec.HERE.name
    for sub in ("configs", "traffic", "metrics", "limits"):
        (data / sub).mkdir(parents=True, exist_ok=True)
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    configs = {"tiny-300m": config_300m(), "tiny-cv2": config_cv2()}
    for name, cfg in configs.items():
        (data / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    real = {w["name"]: w for w in bench["workloads"]}
    overrides = {"token2wav": TOKEN2WAV, "engine": ENGINE, "train": TRAIN}
    cells = []
    for w in real.values():
        mix = spec.load_json(spec.HERE / "traffic" / f"{w['traffic']}.json")
        (data / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps({**mix, **overrides.get(mix["driver"], {})}))
        family = spec.load_json(spec.ROOT / next(
            c["file"] for c in bench["configs"] if c["name"] == w["config"]))["family"]
        name = f"tiny.{w['traffic']}"
        cells.append({**w, "name": name,
                      "config": "tiny-300m" if family == "cosyvoice" else "tiny-cv2"})
        shutil.copy(spec.HERE / "limits" / f"{w['name']}.json", data / "limits" / f"{name}.json")
    for p in (spec.HERE / "metrics").glob("*.py"):
        shutil.copy(p, data / "metrics" / p.name)
    for name, body in (extra_metrics or {}).items():
        (data / "metrics" / f"{name}.py").write_text(body)

    def rename(m):
        if "workloads" in m:
            m = {**m, "workloads": [f"tiny.{real[c]['traffic']}" for c in m["workloads"]]}
        return m

    bench = {**bench, "workloads": cells,
             "configs": [{"name": n, "source": "toy widths of the CPU tests",
                          "file": f"{spec.HERE.name}/configs/{n}.json", "reduced": [],
                          "why": "toy"} for n in configs],
             "end_to_end": [rename(m) for m in bench["end_to_end"]],
             "per_layer": [rename(m) for m in bench["per_layer"]]}
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
