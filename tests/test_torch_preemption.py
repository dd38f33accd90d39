"""Preemption in ``JointTrainer.fit`` (the port of tests/test_preemption.py):
a SIGTERM or SIGINT mid-epoch finishes the step in flight, writes a
resumable snapshot and restores the old handlers; a fresh trainer resumed
from the snapshot lands on the same step, and its next step equals the
uninterrupted run's within 1e-6 x max|p| (each step draws from its own
generator, seeded by the step).  Across two ranks a signal to one rank
stops both on the same step (tests/test_torch_parallel.py)."""

import dataclasses
import os
import signal

import numpy as np
import pytest
import torch

from cosy_tpu_torch.config import LoRAConfig, TrainConfig, tiny_model_config
from cosy_tpu_torch.models import flow as TF
from cosy_tpu_torch.train.trainer import JointTrainer
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

CFG = tiny_model_config()
TCFG = TrainConfig(training_mode="flow_only", accumulate_grad_batches=2, max_feat_len=16,
                   max_epochs=1, batch_size=2, bf16=False, learning_rate=1e-3,
                   warmup_steps=1,
                   flow_lora=LoRAConfig(r=2, alpha=4, dropout=0.0,
                                        target_modules=("to_q", "to_k", "to_v")))


@pytest.fixture(scope="module")
def flow():
    return TF.init_flow_params(CFG.flow, "cpu", seed=2)


def _batches(n):
    rng = np.random.default_rng(0)
    return [{"speech_token": rng.integers(0, 128, (2, 2, 9)).astype(np.int32),
             "speech_token_len": rng.integers(5, 10, (2, 2)).astype(np.int32),
             "speech_feat": (rng.standard_normal((2, 2, 16, 80)) * 2 - 6).astype(np.float32),
             "speech_feat_len": rng.integers(10, 17, (2, 2)).astype(np.int32),
             "embedding": rng.standard_normal((2, 2, 192)).astype(np.float32)}
            for _ in range(n)]


def _adapters(state):
    return {f"{n}.{k}": v.detach().clone() for n, d in state.loras.items() for k, v in d.items()}


@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGINT], ids=["term", "int"])
def test_signal_writes_a_snapshot_that_resumes_the_same_run(flow, tmp_path, sig):
    batches = _batches(8)
    old = signal.getsignal(sig)

    def loader():
        for i, b in enumerate(batches):
            if i == 3:  # the notice arrives mid-epoch
                os.kill(os.getpid(), sig)
            yield b

    tr = JointTrainer(CFG, TCFG, None, flow, out_dir=str(tmp_path / "a"), total_steps=50)
    state = tr.fit(loader(), log_every=1000)
    assert 3 <= state.step <= 5, state.step
    snap = tmp_path / "a" / "joint_flow_only_preempt.ckpt.pt"
    assert snap.exists()
    assert signal.getsignal(sig) is old
    assert not (tmp_path / "a" / "joint_flow_only_last.ckpt.pt").exists()  # no epoch end

    k = state.step
    resumed = JointTrainer(CFG, TCFG, None, flow, out_dir=str(tmp_path / "b"), total_steps=50)
    back = resumed.load_checkpoint(str(snap), resumed.init_state(torch.Generator().manual_seed(9)))
    assert back.step == k
    after = resumed.fit([batches[k]], resume=str(snap), log_every=1000)
    assert after.step == k + 1

    plain = JointTrainer(CFG, TCFG, None, flow, out_dir=str(tmp_path / "c"), total_steps=50)
    want = _adapters(plain.fit(batches[:k + 1], log_every=1000))
    got = _adapters(after)
    scale = max(float(v.abs().max()) for v in want.values())
    assert sorted(got) == sorted(want)
    assert max(float((got[n] - want[n]).abs().max()) for n in want) <= 1e-6 * scale


def test_uninterrupted_fit_leaves_the_handlers_and_writes_no_snapshot(flow, tmp_path):
    old = signal.getsignal(signal.SIGTERM)
    tcfg = dataclasses.replace(TCFG, early_stop_patience=100)
    tr = JointTrainer(CFG, tcfg, None, flow, out_dir=str(tmp_path), total_steps=50)
    state = tr.fit(_batches(2), log_every=1000)
    assert state.step == 2 and signal.getsignal(signal.SIGTERM) is old
    assert not (tmp_path / "joint_flow_only_preempt.ckpt.pt").exists()
