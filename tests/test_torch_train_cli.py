"""``python -m cosy_tpu_torch.train`` at ``--tiny --device cpu`` on
synthetic parquet records: a few steps, the checkpoint, ``--resume``
continuing the step counter, merged weights that load strictly into the
port's pipeline and synthesize; the flag rules of ``train_joint.py``; and
``compat.loader.load_or_init`` both ways (seeded init, strict load with
HiFT's weight norm folded)."""

import argparse
import os

import numpy as np
import pytest
import torch

from cosy_tpu_torch.compat.loader import load_or_init, load_pretrained
from cosy_tpu_torch.config import tiny_model_config
from cosy_tpu_torch.infer.pipeline import TTSPipeline
from cosy_tpu_torch.models.flow import Flow, init_flow_params
from cosy_tpu_torch.models.hift import init_hift_params
from cosy_tpu_torch.models.llm import TransformerLM, init_llm_params
from cosy_tpu_torch.train import __main__ as cli
from test_torch_data import write_records
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)


def _flags(**kw):
    base = dict(mode="joint", epochs=None, batch_size=None, lr=None, max_feat_len=None,
                accum=None, reference_layout=False, batched_micro=False)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("case", [
    (dict(), (8, 2)),
    (dict(batch_size=3, accum=4), (3, 4)),
    (dict(reference_layout=True), (1, 16)),
    (dict(batched_micro=True), (16, 1)),
    (dict(batched_micro=True, accum=12), (32, 3)),
    (dict(batched_micro=True, accum=5), (8, 5)),
], ids=["default", "explicit", "reference", "fold_2", "fold_4_of_12", "fold_none_of_5"])
def test_batch_flags_follow_train_joint(case):
    kw, (bs, accum) = case
    tcfg = cli.train_config(_flags(**kw))
    assert (tcfg.batch_size, tcfg.accumulate_grad_batches) == (bs, accum)


def test_reference_layout_conflicts_with_explicit_batch():
    with pytest.raises(SystemExit, match="conflicts"):
        cli.train_config(_flags(reference_layout=True, accum=2))


def test_tiny_cli_trains_saves_resumes_and_exports(tmp_path, capsys):
    data, out = tmp_path / "data", tmp_path / "out"
    write_records(str(data / "train.parquet"), 16, seed=3, vocab=128)
    argv = ["--data-dir", str(data), "--output", str(out), "--tiny", "--device", "cpu",
            "--batch-size", "4", "--accum", "2", "--max-feat-len", "60", "--epochs", "1",
            "--pretrained", str(tmp_path / "none")]
    res = cli.main(argv)
    assert res.steps == 2 and res.state.step == 2 and res.loader_wait >= 0
    text = capsys.readouterr().out
    assert "2 steps in" in text and "loader wait" in text and "random initialization" in text
    names = set(os.listdir(out))
    assert {"joint_joint_last.ckpt.pt", "llm_merged_joint.pt", "flow_merged_joint.pt",
            "adapters_joint.pt", "metrics.jsonl"} <= names

    res2 = cli.main(argv + ["--resume", str(out / "joint_joint_last.ckpt")])
    assert res2.steps == 2 and res2.state.step == 4  # the step counter continues
    assert "Resumed from" in capsys.readouterr().out

    cfg = tiny_model_config()
    llm, flow = TransformerLM(cfg.llm, "cpu"), Flow(cfg.flow, "cpu")
    llm.load_state_dict(torch.load(out / "llm_merged_joint.pt", weights_only=True), strict=True)
    flow.load_state_dict(torch.load(out / "flow_merged_joint.pt", weights_only=True),
                         strict=True)
    base = init_flow_params(cfg.flow, "cpu", seed=res.trainer.tcfg.seed + 1).state_dict()
    assert any(not torch.equal(v, base[k]) for k, v in flow.state_dict().items())
    pipe = TTSPipeline(cfg, llm, flow, init_hift_params(cfg.hift, "cpu"))
    wav = next(pipe.synthesize(np.asarray([[5, 6, 7]]), max_len_cap=12))["tts_speech"]
    assert wav.ndim == 2 and wav.shape[1] > 0 and np.isfinite(wav).all()


def test_cli_on_an_empty_data_dir_returns_without_training(tmp_path, capsys):
    os.makedirs(tmp_path / "empty")
    assert cli.main(["--data-dir", str(tmp_path / "empty"), "--tiny", "--device", "cpu",
                     "--output", str(tmp_path / "o")]) is None
    assert "no data" in capsys.readouterr().out


def test_load_or_init_seeded_without_checkpoints(tmp_path):
    cfg = tiny_model_config()
    mods = load_or_init(str(tmp_path), cfg, "cpu", seed=5)
    for name, init, seed in (("llm", init_llm_params, 5), ("flow", init_flow_params, 6),
                             ("hift", init_hift_params, 7)):
        want = init(getattr(cfg, name), "cpu", seed=seed).state_dict()
        got = mods[name].state_dict()
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_load_or_init_loads_checkpoints_strictly(tmp_path):
    """llm.pt / flow.pt / hift.pt of the torch names (HiFT's conv_pre as a
    weight-norm g / v pair) load strictly; a missing key raises."""
    cfg = tiny_model_config()
    src = {"llm": init_llm_params(cfg.llm, "cpu", seed=1).state_dict(),
           "flow": init_flow_params(cfg.flow, "cpu", seed=2).state_dict(),
           "hift": init_hift_params(cfg.hift, "cpu", seed=3).state_dict()}
    hift = dict(src["hift"])
    w = hift.pop("conv_pre.weight")
    norm = torch.sqrt(torch.sum(w * w, dim=(1, 2), keepdim=True))
    hift["conv_pre.weight_g"], hift["conv_pre.weight_v"] = norm, w
    for name, sd in (("llm", src["llm"]), ("flow", src["flow"]), ("hift", hift)):
        torch.save(sd, tmp_path / f"{name}.pt")
    mods = load_or_init(str(tmp_path), cfg, "cpu")
    for name in src:
        got = mods[name].state_dict()
        for k, v in src[name].items():
            torch.testing.assert_close(got[k], v, atol=1e-6, rtol=1e-6)
    assert sorted(load_pretrained(str(tmp_path))["hift"]) == sorted(src["hift"])

    flow = dict(src["flow"])
    flow.pop(next(iter(flow)))
    torch.save(flow, tmp_path / "flow.pt")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_or_init(str(tmp_path), cfg, "cpu")
