"""Closed-loop streaming clients on ``ContinuousBatchEngine``.

As many clients as the engine has slots; each submits a prompt-free
request and its next one when the last has ended.  Request j has ``n``
random text ids (the mix's quantile table of id counts in cycles, each in
an order drawn from the seed, so the clients' first requests spread over
the whole range and their completions do not fall together), and the mix's
``token_text_ratio`` is both the EOS floor and the cap of the inference
config: request j decodes exactly ``int(n * ratio)`` tokens (CosyVoice2
less any fill tokens it samples).

One consumer thread serves every client: each request's chunks reach it on
one shared queue, stamped when the engine puts them, and it submits the
client's next request when a request ends.  The main thread only polls the
engine's segment counter near the times that decide something.

Set-up starts the clients and waits until every one has its first chunk,
which fills every slot; the window then opens at the next segment
boundary and closes at the first boundary ``seconds`` or more after it, so
it holds whole segments (a segment's decode, then the chunks of its
windows).  Audio counts chunk by chunk, where a chunk reached its client
inside the window.  With tracing, the profile spans the ``trace_segments``
segments that follow the window, so the window's own clock readings carry
no profiler.  After the window no request is submitted;
the loop runs on until each request submitted inside the window has its
first chunk (``drain_seconds`` at most), then every request left is
cancelled and the engine stopped.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import system, traffic
from ..record import Record
from ..trace import WINDOW_SPAN
from ..yardstick import work

POLL_S = 0.02  # a segment end is read at most this late: 0.04% of a 45 s window
_STOP = object()


def audio_in(requests, lo: float, hi: float, rate: int) -> float:
    """Seconds of audio in the chunks that reached their clients in [lo, hi)."""
    return sum(n for r in requests for t, n in r.chunks if lo <= t < hi) / rate


def first_chunk_waits(requests, lo: float, hi: float) -> List[float]:
    """Submission to first chunk of every request whose first chunk arrived
    in [lo, hi)."""
    return [r.t_first - r.t_submit for r in requests
            if r.t_first is not None and lo <= r.t_first < hi]


class Request:
    def __init__(self, index: int, client: int, n_ids: int, text: np.ndarray, seed: int,
                 cap: int):
        self.index, self.client, self.n_ids, self.text = index, client, n_ids, text
        self.seed, self.cap = seed, cap
        self.t_submit = self.t_first = self.t_done = None
        self.chunks: List[tuple] = []  # (arrival time, samples)
        self.wav: List[np.ndarray] = []
        self.err: Optional[BaseException] = None
        self.handle = None
        self.tokens: Optional[np.ndarray] = None


class _Tagged:
    """A request's queue as the engine sees it: each item goes on the shared
    queue with the request and the time it was put."""

    def __init__(self, shared: queue.Queue, req: Request):
        self.shared, self.req = shared, req

    def put(self, item):
        self.shared.put((self.req, item, time.perf_counter()))


class Driver:
    def __init__(self, cell, pipe, seed: int, plain):
        from cosy_tpu_torch.infer.engine import ContinuousBatchEngine

        t = cell.traffic
        self.cell, self.pipe, self.seed, self.plain, self.t = cell, pipe, seed, plain, t
        self.family = cell.config["family"]
        self.rate = system.audio_rate(cell.config)
        self.sizes = traffic.Sizes(t["text_ids"], t["table"], seed)
        self.vocab = (plain.model.llm.text_token_size if self.family == "cosyvoice"
                      else plain.llm.qwen.vocab_size)
        self.eng = ContinuousBatchEngine(pipe, slots=t["slots"], prefetch=t["prefetch"])
        self.requests: List[Request] = []
        self._shared: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._submitting = True
        self._started = 0  # clients with a first chunk
        self._all_started = threading.Event()
        self._consumer: Optional[threading.Thread] = None
        self.t_open = self.t_close = 0.0
        self.pending = (0, 0)  # the engine's pending requests at the window's open and close

    @staticmethod
    def inference(cell) -> Dict[str, Any]:
        """The inference-config fields this mix sets: the EOS floor and the
        cap, both at the mix's tokens a text id."""
        r = float(cell.traffic["token_text_ratio"])
        return {"min_token_text_ratio": r, "max_token_text_ratio": r}

    def _submit(self, client: int):
        j = len(self.requests)
        n = max(1, int(round(self.sizes[j])))
        r = Request(j, client, n, traffic.text_ids(self.seed, j, n, self.vocab),
                    traffic.request_seed(self.seed, j),
                    int(n * float(self.t["token_text_ratio"])))
        self.requests.append(r)
        r.t_submit = time.perf_counter()
        r.handle = self.eng.submit(r.text, seed=r.seed)
        # the engine puts a request's first chunk a decode segment after its
        # admission; anything put before the swap is moved over
        old, r.handle.q = r.handle.q, _Tagged(self._shared, r)
        while True:
            try:
                r.handle.q.put(old.get_nowait())
            except queue.Empty:
                break

    def _consume(self):
        while True:
            item = self._shared.get()
            if item is _STOP:
                return
            r, payload, t = item
            if payload is not None:
                if r.t_first is None:
                    r.t_first = t
                    if r.index < self.t["clients"]:
                        self._started += 1
                        if self._started == self.t["clients"]:
                            self._all_started.set()
                r.chunks.append((t, payload.shape[1]))
                r.wav.append(payload)
                continue
            r.t_done, r.err, r.tokens = t, r.handle.err, r.handle.tokens
            with self._lock:
                if self._submitting:
                    self._submit(r.client)

    def warm(self):
        with self._lock:
            for c in range(self.t["clients"]):
                self._submit(c)
        self._consumer = threading.Thread(target=self._consume, daemon=True)
        self._consumer.start()
        if not self._all_started.wait(timeout=900):
            raise RuntimeError(f"{self._started} of {self.t['clients']} clients had a first "
                               "chunk in 900 s")
        if any(r.err is not None for r in self.requests):
            raise RuntimeError(f"a request failed in set-up: "
                               f"{next(r.err for r in self.requests if r.err is not None)!r}")

    def _boundary(self, after: int, deadline: float) -> float:
        """Wait for the segment counter to pass ``after``; the time it did."""
        t_end = time.perf_counter() + deadline
        while self.eng.segments_run <= after:
            if time.perf_counter() > t_end:
                raise RuntimeError(f"no engine segment ended in {deadline} s")
            time.sleep(POLL_S)
        return time.perf_counter()

    def _next_boundary(self, after: float, seen: int) -> tuple:
        """Sleep through what decides nothing, then poll for the first
        segment end at or after the time ``after``; (its time, the count)."""
        while True:
            now = time.perf_counter()
            if self.eng.segments_run != seen:
                seen = self.eng.segments_run
                if now >= after:
                    return now, seen
            elif now > after + 600:
                raise RuntimeError("no segment ended in the 600 s after the window's length")
            if now < after - 2 * POLL_S:
                time.sleep(after - 2 * POLL_S - now)
            else:
                time.sleep(POLL_S)

    def measure(self, seconds: float, tracer) -> Record:
        self.t_open = t_open = self._boundary(self.eng.segments_run, deadline=600)
        first = self.eng.segments_run
        self.pending = (len(self.eng._pending), 0)
        # whole segments: the window closes at the first segment end at or
        # after ``seconds``, so it holds every chunk of each segment in it
        t_close, seen = self._next_boundary(t_open + seconds, first)
        self.t_close = t_close
        self.pending = (self.pending[0], len(self.eng._pending))
        t_trace = t_close
        if tracer.on:  # the traced segments follow the measured window
            tracer.start()
            with torch.profiler.record_function(WINDOW_SPAN):
                t_trace, _ = self._next_boundary(time.perf_counter(), self.eng.segments_run)
                for _ in range(self.t["trace_segments"] - 1):
                    t_trace, _ = self._next_boundary(time.perf_counter(), self.eng.segments_run)
            tracer.stop()
        segments = seen - first
        with self._lock:
            self._submitting = False
            inside = [r for r in self.requests if t_open <= r.t_submit < t_close]
        t_end = time.perf_counter() + self.t["drain_seconds"]
        while time.perf_counter() < t_end and any(r.t_first is None and r.t_done is None
                                                  for r in inside):
            time.sleep(0.05)
        self._stop()
        rec = Record(window_s=t_close - t_open, segments=segments, attempted=len(inside),
                     segment_s=(t_close - t_open) / segments,
                     failed=sum(1 for r in inside if r.err is not None or r.t_first is None))
        rec.ttfa_s = first_chunk_waits(self.requests, t_open, t_close)
        rec.audio_s = audio_in(self.requests, t_open, t_close, self.rate)
        rec.pending = self.pending
        if tracer.on:
            rec.traced_audio_s = audio_in(self.requests, t_close, t_trace, self.rate)
            rec.traced_flops = sum(self._chunk_flops(r, k) for r in self.requests
                                   for k, (t, _) in enumerate(r.chunks) if t_close <= t < t_trace)
        return rec

    def _chunk_flops(self, r: Request, k: int) -> float:
        final = r.tokens is not None and r.err is None and k == len(r.chunks) - 1
        n_tok = len(r.tokens) if r.tokens is not None else r.cap
        if self.family == "cosyvoice":
            return work.chunk_flops_300m(self.plain.model, self.pipe.icfg, r.n_ids, n_tok, k,
                                         final)
        return work.chunk_flops_cv2(self.plain.llm, self.plain.flow, self.plain.hift, r.n_ids,
                                    n_tok, k, final)

    def _stop(self):
        with self._lock:
            self._submitting = False
            live = [r for r in self.requests if r.t_done is None and r.handle is not None]
        for r in live:
            self.eng.cancel(r.handle)
        self.eng.stop(timeout=180)
        t_end = time.perf_counter() + 60
        while any(r.t_done is None for r in self.requests) and time.perf_counter() < t_end:
            time.sleep(0.05)
        self._shared.put(_STOP)
        if self._consumer is not None:
            self._consumer.join(timeout=60)
        if (self._consumer is not None and self._consumer.is_alive()) or \
                (self.eng._thread is not None and self.eng._thread.is_alive()):
            raise RuntimeError("the engine's loop or the consumer did not end")

    def close(self):
        self.eng = None
        self.pipe = None

    def samples(self, check_seed: int) -> List[Dict[str, Any]]:
        """The requests the reference compares: those the window finished,
        the one with the most tokens first, the rest drawn from the seed."""
        done = [r for r in self.requests if r.err is None and r.tokens is not None
                and r.t_done is not None and self.t_open <= r.t_done < self.t_close]
        if not done:
            return []
        done.sort(key=lambda r: (-len(r.tokens), r.index))
        rest = done[1:]
        pick = traffic.rng(check_seed, "inputs").permutation(len(rest))[:self.t["check_requests"] - 1]
        chosen = [done[0]] + [rest[i] for i in sorted(pick)]
        return [dict(index=r.index, text=r.text, seed=r.seed, cap=r.cap,
                     tokens=np.asarray(r.tokens, np.int64),
                     wav=np.concatenate([w.reshape(-1) for w in r.wav])) for r in chosen]
