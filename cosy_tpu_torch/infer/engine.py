"""Continuous-batching TTS serving engine (the port of the JAX package's
``infer/engine.py``): requests join and leave a running batched decode at
segment boundaries instead of waiting for a whole cohort to drain.

- One :class:`~cosy_tpu_torch.models.llm.DecodeState` of ``slots`` rows
  runs in segments of ``seg_tokens`` loop steps.
- At each segment boundary a pending request is prefilled and spliced into
  a free row (``llm_admit_slot``); its first audio waits one segment, not
  the running rows' longest utterance.
- Cache columns are slot-local, so a free row admits any request that fits
  the engine's prefix width and cap, whatever the other rows have decoded.
- A row's tokens are those of a solo decode with the request's seed: the
  admission brings the request's own generator.
- After each segment every row's ready windows are synthesized
  (``TTSPipeline.stream_chunks``, the streaming geometry with the hop from
  the first window on) and put on the request's queue; a finished row
  frees at once.

One daemon thread runs the loop and owns every slot and the decode state;
``submit`` and ``cancel`` only touch the pending list under a condition
variable.  A failure inside one request's synthesis fails that request; a
failure of the loop itself fails every request and the engine starts
afresh on the next submission.

Usage::

    eng = ContinuousBatchEngine(pipeline, slots=4)
    req = eng.submit(text_tokens, seed=0)
    for chunk in req.chunks(timeout=60):   # (1, n) float32 wav chunks
        play(chunk)
    eng.stop()
"""

from __future__ import annotations

import queue
import threading
from typing import List, Optional

import numpy as np
import torch

from ..models import llm as L
from .pipeline import StreamCursor, TTSPipeline


class EngineRequest:
    """One in-flight synthesis request; its chunks arrive on ``q`` as
    (1, n) arrays, then None (with ``err`` set on failure)."""

    def __init__(self, text_tokens: np.ndarray, spk_embedding: Optional[np.ndarray],
                 seed: int):
        self.text_tokens = text_tokens
        self.spk_embedding = spk_embedding
        self.seed = seed
        self.q: queue.Queue = queue.Queue()
        self.err: Optional[BaseException] = None
        self.cancelled = False
        # filled at admission by the loop thread
        self.prefix: Optional[torch.Tensor] = None  # (1, L0, D), left-padded
        self.valid = 0
        self.min_len = 0
        self.cap = 0
        self.cursor: Optional[StreamCursor] = None  # its windows and carries
        self.admitted_segment: Optional[int] = None  # segments run before admission
        self.tokens: Optional[np.ndarray] = None  # the final token stream

    def chunks(self, timeout: Optional[float] = None):
        """Iterate this request's wav chunks; raises the request's error,
        or ``queue.Empty`` when none arrives within ``timeout`` seconds."""
        while (got := self.q.get(timeout=timeout)) is not None:
            yield got
        if self.err is not None:
            raise self.err


class ContinuousBatchEngine:
    """Token-level continuous batching over one persistent decode state of
    ``slots`` rows, prefixes left-padded to ``prefix_len`` and at most
    ``max_len`` tokens a request."""

    def __init__(self, pipeline: TTSPipeline, slots: int = 4, prefix_len: int = 128,
                 max_len: int = 512, seg_tokens: Optional[int] = None):
        self.pl = pipeline
        self.B = slots
        self.L0 = prefix_len
        self.max_len = max_len
        self.hop = pipeline.token_min_hop_len
        # admission granularity: one audio hop by default, so the emission
        # and admission cadences coincide
        self.seg = seg_tokens or self.hop
        self._slots: List[Optional[EngineRequest]] = [None] * slots
        self._state: Optional[L.DecodeState] = None
        self._pending: List[EngineRequest] = []
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self.segments_run = 0

    # -- public API -------------------------------------------------------

    def submit(self, text_tokens: np.ndarray, spk_embedding: Optional[np.ndarray] = None,
               seed: int = 0) -> EngineRequest:
        """Queue a request; its draws are those of ``pipeline.synthesize``
        with ``seed`` (row 0).  Consume its chunks with ``req.chunks()``."""
        req = EngineRequest(np.asarray(text_tokens), spk_embedding, seed)
        with self._cv:
            self._pending.append(req)
            if self._thread is None or not self._thread.is_alive():
                self._stopping = False
                self._thread = threading.Thread(target=self._loop, daemon=True)
                self._thread.start()
            self._cv.notify()
        return req

    def cancel(self, req: EngineRequest):
        """Abandon a request: a pending one is dropped at once, an admitted
        one stops at the next segment boundary and frees its row.  No-op
        for a finished request."""
        with self._cv:
            req.cancelled = True
            if req in self._pending:
                self._pending.remove(req)
                req.q.put(None)
            self._cv.notify()

    def stop(self, timeout: float = 30.0):
        """Finish the admitted and pending requests, then end the loop
        thread (waits at most ``timeout`` seconds for it)."""
        with self._cv:
            self._stopping = True
            self._cv.notify()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    # -- internals (loop thread) ------------------------------------------

    def _active(self) -> bool:
        return any(r is not None for r in self._slots)

    def _build(self, req: EngineRequest) -> bool:
        """Build and left-pad the request's prefix to the engine's width;
        fails the request (only it) and returns False when it cannot fit."""
        prefix, min_len, max_len = self.pl._build_prefix(
            req.text_tokens, self.pl._spk(req.spk_embedding), self.max_len)
        if prefix.shape[1] > self.L0:
            req.err = ValueError(f"prefix length {prefix.shape[1]} exceeds the engine's "
                                 f"prefix width {self.L0}")
            req.q.put(None)
            return False
        req.valid = prefix.shape[1]
        req.prefix = torch.nn.functional.pad(prefix, (0, 0, self.L0 - req.valid, 0))
        req.min_len, req.cap = min_len, max_len
        req.cursor = StreamCursor(self.pl._spk(req.spk_embedding), req.seed, 0, self.hop)
        return True

    def _try_admit(self):
        """Admit pending requests into free rows, in submission order."""
        while None in self._slots:
            with self._cv:
                if not self._pending:
                    return
                req = self._pending.pop(0)
            if req.cancelled:  # cancelled after leaving the pending list
                req.q.put(None)
                continue
            if not self._build(req):
                continue
            if self._state is None:
                pl = self.pl
                self._state = L.llm_decode_idle(pl.llm_p, pl.cfg.llm, self.B, self.L0,
                                                self.max_len, req.prefix.dtype, pl.device,
                                                **pl._sampling())
            b = self._slots.index(None)
            L.llm_admit_slot(self._state, req.prefix, req.valid, req.min_len, req.cap,
                             self.pl._decode_generator(req.seed, 0), b)
            req.admitted_segment = self.segments_run
            self._slots[b] = req

    def _segment(self):
        """Run one decode segment and emit every row's ready audio."""
        st = self._state
        for b, r in enumerate(self._slots):
            if r is not None and r.cancelled:
                st.done[b] = True  # stops at this boundary
        st.run(st.i + self.seg)
        self.segments_run += 1
        for b, req in enumerate(self._slots):
            if req is None:
                continue
            done = st.done[b]
            if not req.cancelled:
                try:
                    for wav in self.pl.stream_chunks(
                            req.cursor, np.asarray(st.tokens[b], np.int64)[None], done):
                        req.q.put(wav)
                except Exception as e:  # noqa: BLE001 - fail only this request
                    req.err, done = e, True
            if done:
                req.tokens = np.asarray(st.tokens[b], np.int64)
                st.done[b] = True
                req.q.put(None)
                self._slots[b] = None

    def _fail_all(self, e: BaseException):
        for b, req in enumerate(self._slots):
            if req is not None:
                req.err = e
                req.q.put(None)
                self._slots[b] = None
        with self._cv:
            for req in self._pending:
                req.err = e
                req.q.put(None)
            self._pending.clear()
        self._state = None  # a fresh state on the next admission

    def _loop(self):
        while True:
            with self._cv:
                while not self._pending and not self._active() and not self._stopping:
                    self._cv.wait()
                if self._stopping and not self._active() and not self._pending:
                    return
            try:
                with torch.inference_mode():
                    self._try_admit()
                    if self._active():
                        self._segment()
            except Exception as e:  # noqa: BLE001 - the engine must survive
                self._fail_all(e)
