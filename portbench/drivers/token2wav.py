"""One closed-loop client of ``TTSPipeline.token2wav``: long-form
narration, or voice conversion of a recording after its frontend.

Call j synthesizes prompt-free source speech tokens (the mix's quantile
table of token counts in cycles, each in an order drawn from the seed)
with a speaker embedding drawn from the seed; its noise comes from a
generator seeded for the call.
Set-up runs each size of the table once.  The window holds whole calls:
it opens at a call's start and closes at the end of the first call that
ends ``seconds`` or more after it, so the rate covers all the work and all
the time between.  With tracing, the profile spans the calls that follow
the window, up to ``trace_seconds``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from .. import system, traffic
from ..record import Record
from ..trace import WINDOW_SPAN
from ..yardstick import work

WARM = 1 << 40  # the warm-up calls' indices, apart from the window's


class Driver:
    def __init__(self, cell, pipe, seed: int, plain):
        t = cell.traffic
        self.cell, self.pipe, self.seed, self.plain, self.t = cell, pipe, seed, plain, t
        self.rate = system.audio_rate(cell.config)
        self.sizes = traffic.Sizes(t["tokens"], t["table"], seed)
        self.vocab = plain.model.flow.vocab_size
        self.calls: List[Dict[str, Any]] = []
        self.device = pipe.device

    @staticmethod
    def inference(cell) -> Dict[str, Any]:
        return {}

    def inputs(self, j: int, n_tokens: int) -> Dict[str, Any]:
        """Call j's inputs, drawn from the run's seed."""
        g = traffic.rng(self.seed, "inputs", j)
        return dict(token=g.integers(0, self.vocab, (1, n_tokens)).astype(np.int64),
                    spk_embedding=g.standard_normal((1, self.plain.model.flow.spk_embed_dim)
                                                    ).astype(np.float32),
                    seed=traffic.request_seed(self.seed, j))

    def _call(self, j: int, n_tokens: int, keep: bool) -> Dict[str, Any]:
        x = self.inputs(j, n_tokens)
        gen = torch.Generator(device=self.device).manual_seed(x["seed"])
        t0 = time.perf_counter()
        with torch.inference_mode():
            wav = self.pipe.token2wav(x["token"], x["spk_embedding"], generator=gen)
        t1 = time.perf_counter()
        rec = dict(index=j, n_tokens=n_tokens, t0=t0, t1=t1, samples=wav.shape[1])
        if keep:
            rec["wav"] = wav.reshape(-1)
        return rec

    def warm(self):
        for i, n in enumerate(sorted(self.sizes.table, reverse=True)):
            self._call(WARM + i, int(round(n)), keep=False)

    def measure(self, seconds: float, tracer) -> Record:
        j = 0
        t_open = time.perf_counter()
        while not self.calls or self.calls[-1]["t1"] < t_open + seconds:
            self.calls.append(self._call(j, int(round(self.sizes[j])), keep=True))
            j += 1
        window = self.calls[-1]["t1"] - t_open
        rec = Record(window_s=window, attempted=len(self.calls), failed=0)
        rec.audio_s = sum(c["samples"] for c in self.calls) / self.rate
        if tracer.on:  # the traced calls follow the measured window
            traced: List[Dict[str, Any]] = []
            tracer.start()
            t_trace = time.perf_counter()
            with torch.profiler.record_function(WINDOW_SPAN):
                while not traced or traced[-1]["t1"] < t_trace + self.t["trace_seconds"]:
                    traced.append(self._call(j, int(round(self.sizes[j])), keep=False))
                    j += 1
            tracer.stop()
            rec.traced_audio_s = sum(c["samples"] for c in traced) / self.rate
            icfg = self.pipe.icfg
            for c in traced:
                rec.traced_flops += work.token2wav_flops(self.plain.model, icfg,
                                                         c["n_tokens"])[0]
        return rec

    def close(self):
        self.pipe = None

    def samples(self, check_seed: int) -> List[Dict[str, Any]]:
        """The calls the reference compares: the longest of the window and
        others drawn from the seed."""
        calls = sorted(self.calls, key=lambda c: (-c["n_tokens"], c["index"]))
        rest = calls[1:]
        pick = traffic.rng(check_seed, "inputs").permutation(len(rest))[:self.t["check_calls"] - 1]
        chosen = [calls[0]] + [rest[i] for i in sorted(pick)]
        return [dict(c, **{"inputs": self.inputs(c["index"], c["n_tokens"])}) for c in chosen]
