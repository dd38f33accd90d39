"""HTTP TTS server over the user API (the port of the JAX package's
``serve.py``).

    python -m cosy_tpu_torch.serve --model-dir pretrained_models/CosyVoice-300M \
        --port 8080 [--voices alice=adapters_alice.pt,bob=...] [--engine-slots 4]
        [--engine-prefetch] [--warmup]

POST /tts  {"text": "...", "speed": 1.0, "stream": false, "spk_id": "", "voice": ""}
    -> audio/wav (whole) or a chunked WAV stream
GET /healthz
GET /stats    -> JSON serving statistics (requests and errors by route, RTF
                 and time-to-first-audio percentiles, queue depths)
GET /metrics  -> the same counters in Prometheus text format

Routes: concurrent prompt-free whole requests share one micro-batched decode
(``synthesize_batch``, a collection window of ``batch_window_ms``);
prompt-free streams go to the continuous-batching engine
(``--engine-slots``), voiced ones and all streams without an engine to
lock-step cohorts (``synthesize_stream_batch``, at most two cohorts at a
time, interleaved at segment boundaries); a ``spk_id`` request runs alone
through ``inference_sft``.  One device lock serializes the card's work: it
is held for a chunk, a segment or a batch, never across a yield to the
client, so a slow client never stalls the others.  ``voice`` selects a
registered LoRA voice (``--voices``), served un-merged.

SIGTERM / SIGINT drain: the listener closes, in-flight requests finish
(bounded by ``--drain-timeout``), then the process exits.  The server runs
on CUDA unless ``--device cpu`` is passed; without a card it raises.
``wav_bytes`` needs numpy only (the client imports it).

Tensor-parallel serving, one process a GPU::

    torchrun --nproc-per-node N -m cosy_tpu_torch.serve --tp N --model-dir DIR ...

splits the LLM's and the flow's weights over the N ranks (HiFT stays
whole).  Rank 0 serves HTTP; the other ranks follow: each device section
rank 0 runs under the device lock is first sent to them, and they run it
too, so every rank enters the same collectives in the same order
(``parallel/replay.py``).  After rank 0's drain every rank exits.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import os
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import NamedTuple, Optional

import numpy as np


def wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    """PCM16 mono WAV bytes (header + samples)."""
    pcm = (np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVEfmt " + struct.pack(
        "<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16) + b"data" + struct.pack("<I", len(pcm))
    return hdr + pcm


def load_voice_adapters(path: str) -> dict:
    """Split an adapter checkpoint (``JointTrainer.export_adapters``) into a
    ``set_voices`` entry: ``{"llm": {...} | None, "flow": {...} | None,
    "llm_scale": float | None, "flow_scale": float | None}``.  The file's
    keys are ``llm.<param path>.lora_A/B`` and ``flow.<...>`` plus
    ``llm._scaling`` / ``flow._scaling``, the adapters' alpha / r."""
    from .params import load_torch_checkpoint

    blob = load_torch_checkpoint(path)
    llm = {k[len("llm."):]: v for k, v in blob.items() if k.startswith("llm.") and ".lora_" in k}
    flow = {k[len("flow."):]: v for k, v in blob.items()
            if k.startswith("flow.") and ".lora_" in k}
    if not llm and not flow:
        raise SystemExit(
            f"{path}: no llm.*/flow.* adapter keys - pass an adapter-only checkpoint "
            "(JointTrainer.export_adapters, adapters_*.pt), not merged weights")
    return {
        "llm": llm or None,
        "flow": flow or None,
        "llm_scale": float(blob["llm._scaling"]) if "llm._scaling" in blob else None,
        "flow_scale": float(blob["flow._scaling"]) if "flow._scaling" in blob else None,
    }


class TTSServer:
    """The serving layer over an API object (``api.CosyVoice`` /
    ``CosyVoice2``, or anything with ``model``, ``frontend``,
    ``_next_seed`` and ``sample_rate``)."""

    def __init__(self, api, lock: Optional[threading.Lock] = None,
                 batch_window_ms: float = 20.0, max_batch: int = 8, engine_slots: int = 0,
                 replay_group=None, engine_prefetch: bool = False):
        self.api = api
        # one card: serialize its work; the pipelines batch inside a call
        self.lock = lock or threading.Lock()
        # rank 0 of a tensor-parallel server: each device section is sent to
        # the followers first (parallel/replay.py)
        self.replay = None
        if replay_group is not None:
            from .parallel.replay import Leader

            self.replay = Leader(replay_group, self.lock)
        # continuous batching (infer/engine.py) for prompt-free streams:
        # requests join and leave one running decode at segment boundaries.
        # The engine serves both families; it takes the same device lock.
        from .infer.pipeline import TTSPipeline
        from .infer.pipeline2 import TTS2Pipeline

        self._cv2 = isinstance(api.model, TTS2Pipeline)
        self.engine = None
        if engine_slots > 0 and isinstance(api.model, (TTSPipeline, TTS2Pipeline)):
            from .infer.engine import ContinuousBatchEngine

            self.engine = ContinuousBatchEngine(api.model, slots=engine_slots,
                                                device_lock=self.lock, replay=self.replay,
                                                prefetch=engine_prefetch)
        # dynamic batching of whole prompt-free requests: requests that
        # arrive within the window share one batched decode
        self.batch_window_ms = batch_window_ms
        self.max_batch = max_batch
        self._queue: list = []
        self._queue_lock = threading.Lock()
        self._worker_busy = threading.Lock()
        # streaming cohorts: a dispatcher thread forms them, each runs in its
        # own thread taking the device lock per segment; the semaphore bounds
        # the cohorts in flight
        self._stream_queue: list = []
        self._stream_wake = threading.Event()
        self._stream_thread: Optional[threading.Thread] = None
        self.max_concurrent_cohorts = 2
        self._cohort_slots = threading.Semaphore(self.max_concurrent_cohorts)
        self.batches_run = 0
        # serving statistics (GET /stats, /metrics)
        self._stats_lock = threading.Lock()
        self._t_started = time.time()
        self.active_requests = 0
        self._route_counts: collections.Counter = collections.Counter()
        self._route_errors: collections.Counter = collections.Counter()
        self._audio_seconds = 0.0
        self._busy_seconds = 0.0
        self._rtf_ring: collections.deque = collections.deque(maxlen=256)
        self._ttfa_ring: collections.deque = collections.deque(maxlen=256)

    # -- observability --------------------------------------------------

    def record_request(self, route: str, wall_s: float, audio_s: float,
                       ttfa_s: Optional[float] = None, error: bool = False):
        with self._stats_lock:
            self._route_counts[route] += 1
            if error:
                self._route_errors[route] += 1
            self._busy_seconds += wall_s
            if audio_s > 0:
                self._audio_seconds += audio_s
                self._rtf_ring.append(wall_s / audio_s)
            if ttfa_s is not None:
                self._ttfa_ring.append(ttfa_s)

    @staticmethod
    def _pct(ring, q):
        return float(np.percentile(np.asarray(ring), q)) if ring else None

    def stats(self) -> dict:
        with self._stats_lock:
            with self._queue_lock:
                q_batch, q_stream = len(self._queue), len(self._stream_queue)
            out = {
                "uptime_s": round(time.time() - self._t_started, 1),
                "active_requests": self.active_requests,
                "requests": dict(self._route_counts),
                "errors": dict(self._route_errors),
                "batches_run": self.batches_run,
                "audio_seconds": round(self._audio_seconds, 2),
                "busy_seconds": round(self._busy_seconds, 2),
                "queue_depth": {"batched": q_batch, "stream": q_stream},
                "rtf": {"p50": self._pct(self._rtf_ring, 50),
                        "p95": self._pct(self._rtf_ring, 95),
                        "window": len(self._rtf_ring)},
                "ttfa_s": {"p50": self._pct(self._ttfa_ring, 50),
                           "p95": self._pct(self._ttfa_ring, 95),
                           "window": len(self._ttfa_ring)},
            }
            if self.engine is not None:
                out["engine"] = {"slots": self.engine.B,
                                 "active": sum(s is not None for s in self.engine._slots),
                                 "segments_run": self.engine.segments_run,
                                 "prefetch_hits": self.engine.prefetch_hits}
            return out

    def metrics_text(self) -> str:
        """Prometheus text exposition of the ``stats()`` counters."""
        s = self.stats()
        lines = [
            "# TYPE cosy_tpu_uptime_seconds gauge",
            f"cosy_tpu_uptime_seconds {s['uptime_s']}",
            "# TYPE cosy_tpu_active_requests gauge",
            f"cosy_tpu_active_requests {s['active_requests']}",
            "# TYPE cosy_tpu_requests_total counter",
        ]
        for route, n in sorted(s["requests"].items()):
            lines.append('cosy_tpu_requests_total{route="%s"} %d' % (route, n))
        lines.append("# TYPE cosy_tpu_errors_total counter")
        for route, n in sorted(s["errors"].items()):
            lines.append('cosy_tpu_errors_total{route="%s"} %d' % (route, n))
        lines += [
            "# TYPE cosy_tpu_batches_run_total counter",
            f"cosy_tpu_batches_run_total {s['batches_run']}",
            "# TYPE cosy_tpu_audio_seconds_total counter",
            f"cosy_tpu_audio_seconds_total {s['audio_seconds']}",
            "# TYPE cosy_tpu_busy_seconds_total counter",
            f"cosy_tpu_busy_seconds_total {s['busy_seconds']}",
        ]
        for name, key in (("rtf", "rtf"), ("ttfa_seconds", "ttfa_s")):
            for q in ("p50", "p95"):
                v = s[key][q]
                if v is not None:
                    lines.append('cosy_tpu_%s{quantile="%s"} %.6f' % (name, q, v))
        return "\n".join(lines) + "\n"

    # -- synthesis routes -------------------------------------------------

    def _zero_spk(self) -> np.ndarray:
        """The zero speaker embedding of the loaded family."""
        model = self.api.model
        dim = model.fcfg.spk_embed_dim if self._cv2 else model.cfg.llm.spk_embed_dim
        return np.zeros((1, dim), np.float32)

    def _prompt_free_kwargs(self) -> dict:
        """The zero embedding for ``model.synthesize``: CosyVoice-300M takes
        ``spk_embedding`` (a speaker row of zeros), CosyVoice2 has no LLM
        speaker row and takes ``flow_embedding``."""
        return {("flow_embedding" if self._cv2 else "spk_embedding"): self._zero_spk()}

    def _text_ids(self, text: str) -> np.ndarray:
        fe = self.api.frontend
        return fe.extract_text_token(fe.normalize(text, split=False))

    def _model_iter(self, method: str, *args, **kwargs):
        """``api.model.<method>(*args, **kwargs)``, a generator, advanced one
        item a device section: each ``next`` runs under the device lock,
        never across a yield (this generator suspends while a handler
        writes to its client's socket), and under ``--tp`` is first sent to
        the followers, the first together with the call."""
        gen = getattr(self.api.model, method)(*args, **kwargs)
        gid, live = None, True
        try:
            while True:
                with self.lock:
                    if self.replay is not None:
                        gid = self.replay.advance(gid, method, args, kwargs)
                    live = False  # its end or a raise ends it on every rank
                    out = next(gen, None)
                    live = out is not None
                if not live:
                    return
                yield out
        finally:
            if live:  # closed early: a client that went away
                gen.close()
                if gid is not None:
                    with self.lock:
                        self.replay.send(("close", gid))

    def _model_call(self, method: str, *args, **kwargs):
        """``api.model.<method>(*args, **kwargs)`` as one device section."""
        with self.lock:
            if self.replay is not None:
                self.replay.send(("call", method, args, kwargs))
            return getattr(self.api.model, method)(*args, **kwargs)

    def synthesize(self, text: str, spk_id: str = "", speed: float = 1.0,
                   stream: bool = False, voice: str = ""):
        """One request alone: ``inference_sft`` for a ``spk_id``, else the
        prompt-free path (zero embedding; ``voice`` routes its adapters).
        Yields 1-D wav chunks; the device lock is held per chunk."""
        if spk_id:
            gen = self.api.inference_sft(text, spk_id, stream=stream, speed=speed,
                                         run=functools.partial(self._model_iter, "synthesize"))
        else:
            kwargs = self._prompt_free_kwargs()
            if voice:
                kwargs["voice"] = voice
            gen = self._model_iter("synthesize", self._text_ids(text), stream=stream,
                                   speed=speed, seed=self.api._next_seed(), **kwargs)
        with contextlib.closing(gen) as chunks:
            for out in chunks:
                yield out["tts_speech"][0]

    def synthesize_batched(self, text: str, speed: float = 1.0, voice: str = "") -> np.ndarray:
        """Queue a prompt-free request; the first waiting request thread
        leads: it waits out the collection window and runs the queue as one
        ``synthesize_batch`` (each row through its own voice).  Blocks until
        this request's wav is ready."""
        item = {"ids": self._text_ids(text), "speed": speed, "voice": voice,
                "event": threading.Event(), "wav": None, "err": None}
        with self._queue_lock:
            self._queue.append(item)
        with self._worker_busy:
            if not item["event"].is_set():  # not served by an earlier leader
                time.sleep(self.batch_window_ms / 1e3)
                with self._queue_lock:
                    batch, self._queue = (self._queue[:self.max_batch],
                                          self._queue[self.max_batch:])
                if batch:
                    try:
                        vkw = ({"voices": [b["voice"] or None for b in batch]}
                               if any(b["voice"] for b in batch) else {})
                        wavs = self._model_call(
                            "synthesize_batch", [b["ids"] for b in batch],
                            [self._zero_spk()] * len(batch), speed=[b["speed"] for b in batch],
                            seed=self.api._next_seed(), **vkw)
                        for b, w in zip(batch, wavs):
                            b["wav"] = w[0]
                    except Exception as e:  # noqa: BLE001 - every row gets the error
                        for b in batch:
                            b["err"] = e
                    finally:
                        self.batches_run += 1
                        for b in batch:
                            b["event"].set()
        item["event"].wait()
        if item["err"] is not None:
            raise item["err"]
        return item["wav"]

    def synthesize_stream_engine(self, text: str):
        """A prompt-free stream through the continuous-batching engine: it
        joins the running decode at the next segment boundary and frees its
        slot when done.  The zero speaker embedding keeps its prefix the
        other prompt-free routes' (a None embedding would drop the speaker
        row)."""
        req = self.engine.submit(self._text_ids(text), self._zero_spk(),
                                 seed=self.api._next_seed())
        try:
            for chunk in req.chunks():
                yield chunk[0]
        finally:
            # a client that went away closes this generator: free the slot
            self.engine.cancel(req)

    def synthesize_stream_batched(self, text: str, voice: str = ""):
        """A stream in a lock-step cohort: streams that arrive within the
        window share one segmented decode (``synthesize_stream_batch``), and
        each receives its own chunks as they are made.  Cohorts run in
        threads of their own holding the device lock per segment, so a
        request that arrives mid-cohort starts after the current segment."""
        import queue as _queue

        item = {"ids": self._text_ids(text), "voice": voice, "q": _queue.Queue(),
                "err": None, "dead": False}
        with self._queue_lock:
            self._stream_queue.append(item)
            # respawn a dead dispatcher: queued clients must never wait on it
            if self._stream_thread is None or not self._stream_thread.is_alive():
                self._stream_thread = threading.Thread(target=self._stream_worker,
                                                       daemon=True)
                self._stream_thread.start()
        self._stream_wake.set()
        try:
            while True:
                got = item["q"].get()
                if got is None:
                    if item["err"] is not None:
                        raise item["err"]
                    return
                yield got
        finally:
            # a client that went away: stop collecting its chunks (the
            # lock-step cohort itself runs to its end)
            item["dead"] = True

    def _stream_worker(self):
        while True:
            cohort, slot = [], False
            try:
                self._stream_wake.wait()
                self._cohort_slots.acquire()
                slot = True
                time.sleep(self.batch_window_ms / 1e3)  # the collection window
                with self._queue_lock:
                    cohort, self._stream_queue = (self._stream_queue[:self.max_batch],
                                                  self._stream_queue[self.max_batch:])
                    if not self._stream_queue:
                        self._stream_wake.clear()
                if not cohort:
                    self._cohort_slots.release()
                    continue
                threading.Thread(target=self._cohort_entry, args=(cohort,),
                                 daemon=True).start()
            except Exception as e:  # noqa: BLE001 - the dispatcher must not die
                for it in cohort:
                    it["err"] = it["err"] or e
                    it["q"].put(None)
                if slot:
                    self._cohort_slots.release()

    def _cohort_entry(self, cohort):
        try:
            self._run_stream_cohort(cohort)
        finally:
            self._cohort_slots.release()

    def _run_stream_cohort(self, cohort):
        with self._queue_lock:
            self.batches_run += 1
        finished = [False] * len(cohort)
        try:
            vkw = ({"voices": [it["voice"] or None for it in cohort]}
                   if any(it["voice"] for it in cohort) else {})
            # the device lock per segment: cohorts interleave here
            for b, wav, done in self._model_iter(
                    "synthesize_stream_batch", [it["ids"] for it in cohort],
                    [self._zero_spk()] * len(cohort), seed=self.api._next_seed(), **vkw):
                if not cohort[b]["dead"]:
                    cohort[b]["q"].put(wav[0])
                if done:
                    # release this client now: a short stream neither waits
                    # for nor inherits an error of the cohort's longest
                    finished[b] = True
                    cohort[b]["q"].put(None)
        except Exception as e:  # noqa: BLE001 - the unfinished streams get it
            for it, fin in zip(cohort, finished):
                if not fin:
                    it["err"] = e
        finally:
            for it, fin in zip(cohort, finished):
                if not fin:
                    it["q"].put(None)


def make_handler(server: TTSServer, sample_rate: int):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # chunked streaming

        def log_message(self, fmt, *args):
            pass

        def _plain(self, code: int, body: bytes, ctype: str = "text/plain"):
            """A framed response: under keep-alive the client needs a
            Content-Length to know where it ends."""
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._plain(200, b"ok")
            elif self.path == "/stats":
                self._plain(200, json.dumps(server.stats(), indent=1).encode(),
                            "application/json")
            elif self.path == "/metrics":
                self._plain(200, server.metrics_text().encode())
            else:
                self._plain(404, b"not found")

        def do_POST(self):
            t_req = time.time()
            audio_samples, ttfa, ok = 0, None, False
            # _tts sets the route as it decides, so a failure after the
            # choice counts against the real route, not bad_request
            self._cur_route = "bad_request"
            with server._stats_lock:
                server.active_requests += 1
            try:
                audio_samples, ttfa, ok = self._tts(t_req)
            finally:
                with server._stats_lock:
                    server.active_requests -= 1
                server.record_request(self._cur_route, time.time() - t_req,
                                      audio_samples / sample_rate, ttfa_s=ttfa, error=not ok)

        def _tts(self, t_req):
            """(audio samples, ttfa seconds | None, ok)."""
            if self.path != "/tts":
                self._plain(404, b"not found")
                self._cur_route = "not_found"
                return 0, None, False
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
                text = req["text"]
                stream = bool(req.get("stream", False))
                spk_id = req.get("spk_id", "")
                speed = float(req.get("speed", 1.0))
                voice = req.get("voice", "")
            except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
                # TypeError: a body that is not an object; ValueError: a
                # speed that is not a number - client errors, not 500s
                self._plain(400, f"bad request: {e}".encode())
                return 0, None, False
            if voice:
                if spk_id:
                    # spk_id routes to inference_sft, which takes no voice
                    self._plain(400, b"voice and spk_id are mutually exclusive; pass one")
                    return 0, None, False
                known = getattr(server.api.model, "voice_names", [])
                if voice not in known:
                    self._plain(400, f"unknown voice {voice!r}; registered: {known}".encode())
                    return 0, None, False
            if stream:
                return self._stream(t_req, text, spk_id, speed, voice)
            if not spk_id and hasattr(server.api.model, "synthesize_batch"):
                # concurrent prompt-free requests share a batched decode
                self._cur_route = "batched"
                wav = server.synthesize_batched(text, speed, voice)
            else:
                self._cur_route = "solo_sft" if spk_id else "solo"
                wav = np.concatenate(list(server.synthesize(text, spk_id, speed, voice=voice)))
            self._plain(200, wav_bytes(wav, sample_rate), "audio/wav")
            return int(np.size(wav)), None, True

        def _stream(self, t_req, text, spk_id, speed, voice):
            """A chunked WAV: a header with unknown-length markers, then
            PCM16 for each chunk as it is made."""
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def send_chunk(data: bytes):
                self.wfile.write(f"{len(data):X}\r\n".encode())
                self.wfile.write(data)
                self.wfile.write(b"\r\n")

            send_chunk(b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVEfmt "
                       + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16)
                       + b"data" + struct.pack("<I", 0xFFFFFFFF))
            if not spk_id and not voice and speed == 1.0 and server.engine is not None:
                self._cur_route = "stream_engine"
                pieces = server.synthesize_stream_engine(text)
            elif (not spk_id and speed == 1.0
                  and hasattr(server.api.model, "synthesize_stream_batch")):
                # voiced streams route their adapters per row in the cohort
                self._cur_route = "stream_cohort"
                pieces = server.synthesize_stream_batched(text, voice)
            else:
                self._cur_route = "stream_solo"
                pieces = server.synthesize(text, spk_id, speed, stream=True, voice=voice)
            samples, ttfa = 0, None
            try:
                for piece in pieces:
                    if ttfa is None:
                        ttfa = time.time() - t_req
                    samples += int(np.size(piece))
                    send_chunk((np.clip(piece, -1, 1) * 32767).astype("<i2").tobytes())
                self.wfile.write(b"0\r\n\r\n")
            finally:
                # a client that went away: close() runs the generator's
                # finally (engine cancel, cohort mark, lock release)
                pieces.close()
            return samples, ttfa, True

    return Handler


def resolve_finetuned_norm(flow_weights_path, override_flow, explicit, cosyvoice2) -> bool:
    """Whether served CosyVoice-300M flow weights work in normalized mel
    space (fine-tune outputs, which take the output denormalization) or raw
    mel space (pretrained-style).  Precedence: an explicit
    ``--finetuned-norm`` > the weights' ``.meta.json`` provenance sidecar
    (``params.save_weight_meta``) > the distilled ``time_mlp_s`` key.
    Unknown provenance raises: a raw-mel checkpoint served with the
    denormalization on fails silently as garbled audio."""
    if explicit is not None:
        return bool(explicit)
    if cosyvoice2 or override_flow is None:
        return False  # CosyVoice2 has no denormalization; stock weights are raw
    from .params import load_weight_meta

    meta = load_weight_meta(flow_weights_path)
    if meta and "mel_space" in meta:
        print(f"flow: mel_space={meta['mel_space']} ({flow_weights_path}.meta.json)")
        return meta["mel_space"] == "normalized"
    if "decoder.estimator.time_mlp_s.linear_1.weight" in override_flow:
        return True  # a MeanFlow-distilled v1 output (normalized space)
    raise SystemExit(
        f"--flow-weights {flow_weights_path}: cannot tell whether these weights work in "
        "normalized mel space (fine-tune outputs) or raw mel space (pretrained-style) - no "
        ".meta.json sidecar was found next to the file.  Pass --finetuned-norm 1 (merged "
        "fine-tune outputs) or --finetuned-norm 0 (raw-mel-space weights); the trainer's "
        "export writes the sidecar.")


def parse_voices(spec: str) -> tuple:
    """``name=path,...`` -> ({name: {"llm", "flow"}}, llm_scale, flow_scale).
    A file without a recorded scale was trained at the default alpha / r =
    2.0; every voice must share one scale a stage."""
    voices, llm_s, flow_s = {}, None, None
    for pair in spec.split(","):
        name, _, path = pair.partition("=")
        name, path = name.strip(), path.strip()
        if not name or not path:
            raise SystemExit(f"--voices: bad pair {pair!r} (want name=path)")
        if name in voices:
            raise SystemExit(f"--voices: duplicate voice name {name!r}")
        v = load_voice_adapters(path)
        for stage in ("llm_scale", "flow_scale"):
            if v[stage] is None and v[stage.split("_")[0]] is not None:
                v[stage] = 2.0
        for stage, cur in (("llm_scale", llm_s), ("flow_scale", flow_s)):
            if v[stage] is not None and cur is not None and v[stage] != cur:
                raise SystemExit(f"--voices: {name} {stage}={v[stage]} differs from an earlier "
                                 f"voice's {cur}; all voices must share one adapter scaling "
                                 "per stage")
        llm_s = v["llm_scale"] if v["llm_scale"] is not None else llm_s
        flow_s = v["flow_scale"] if v["flow_scale"] is not None else flow_s
        voices[name] = {"llm": v["llm"], "flow": v["flow"]}
    return voices, 2.0 if llm_s is None else llm_s, 2.0 if flow_s is None else flow_s


def warmup(server: TTSServer, text: str = "warmup.") -> float:
    """One request of each route (solo whole and streamed, batched, the
    engine or a cohort, and the voiced ones with the first voice), so the
    kernels are built (at first use) and no client waits for ``nvcc``.
    Returns the seconds it took."""
    t0 = time.time()
    for stream in (False, True):
        for _ in server.synthesize(text, stream=stream):
            pass
    server.synthesize_batched(text)
    if server.engine is not None:
        for _ in server.synthesize_stream_engine(text):
            pass
    for _ in server.synthesize_stream_batched(text):
        pass
    names = getattr(server.api.model, "voice_names", [])
    if names:
        for stream in (False, True):
            for _ in server.synthesize(text, stream=stream, voice=names[0]):
                pass
        server.synthesize_batched(text, voice=names[0])
        for _ in server.synthesize_stream_batched(text, voice=names[0]):
            pass
    return time.time() - t0


def refuse_queued_flags(args):
    """SystemExit for flag combinations the port refuses: a ``--tp`` that is
    not the launch's world, and the ROADMAP items still queued."""
    from .parallel.mesh import launched

    world = int(os.environ["WORLD_SIZE"]) if launched() else 1
    if args.tp != world:
        if args.tp > 1:
            raise SystemExit(f"--tp {args.tp} needs torchrun --nproc-per-node {args.tp} (one "
                             f"process a GPU); this launch has a world of {world}")
        raise SystemExit(f"a launch of {world} processes serves with --tp {world}, one process "
                         f"a GPU (got --tp {args.tp})")
    if args.voices and args.cosyvoice2:
        raise SystemExit("--voices is CosyVoice(1)-only for now (the CosyVoice2 pipeline has "
                         "no multi-voice decode wiring)")
    if args.meanflow_steps is not None and args.sampler != "meanflow":
        raise SystemExit("--meanflow-steps applies to --sampler meanflow only (the MeanFlow "
                         "sampler of ROADMAP A14)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="TTS HTTP server (PyTorch port)")
    ap.add_argument("--model-dir", default="pretrained_models/CosyVoice-300M")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--cosyvoice2", action="store_true")
    ap.add_argument("--engine-slots", type=int, default=0,
                    help="continuous batching of prompt-free streams with this many decode "
                         "slots (0: lock-step cohorts)")
    ap.add_argument("--warmup", action="store_true",
                    help="run one request of each route before listening (builds the "
                         "kernels)")
    ap.add_argument("--flow-weights", default=None,
                    help="serve these flow weights (e.g. a merged fine-tune) in place of the "
                         "model dir's")
    ap.add_argument("--voices", default=None, metavar="NAME=ADAPTERS.pt,...",
                    help="multi-voice LoRA serving: name=path pairs of adapter checkpoints, "
                         "served un-merged on one base model; clients pick with "
                         "{\"voice\": \"name\"}")
    ap.add_argument("--finetuned-norm", type=int, choices=[0, 1], default=None,
                    help="treat the flow weights as normalized-mel (fine-tuned) and "
                         "denormalize the output; default: the weights' .meta.json sidecar")
    ap.add_argument("--drain-timeout", type=float, default=30.0,
                    help="seconds to wait for in-flight requests after SIGTERM/SIGINT")
    ap.add_argument("--attn-window", type=int, default=0,
                    help="local-band estimator attention of +-N mel frames (kernel C); 0: "
                         "full attention")
    ap.add_argument("--sampler", default="euler", choices=["euler", "meanflow"],
                    help="meanflow: the few-step sampler of MeanFlow-distilled flow weights "
                         "(--flow-weights from python -m cosy_tpu_torch.train.distill)")
    ap.add_argument("--meanflow-steps", type=int, default=None,
                    help="estimator calls a flow solve under --sampler meanflow (default 2)")
    ap.add_argument("--int8", action="store_true",
                    help="weight-only int8 decode: per-row int8 weights in the decode step "
                         "(CosyVoice-300M) or every Qwen2 projection (--cosyvoice2); the "
                         "rounding can change the sampled tokens, so check a voice first "
                         "with quant.validate_int8_voice")
    ap.add_argument("--tp", type=int, default=1,
                    help="split the LLM and the flow over N GPUs, one process each: run under "
                         "torchrun --nproc-per-node N; rank 0 serves HTTP")
    ap.add_argument("--aot-cache", default=None, metavar="DIR",
                    help="build and load the compiled kernel libraries in DIR (created 0700; "
                         "refused if another user could write to it): a later start with "
                         "the same DIR loads them without running nvcc or g++")
    ap.add_argument("--engine-prefetch", action="store_true",
                    help="with --engine-slots: enqueue the engine's next decode segment before "
                         "reading the last one (hits show as prefetch_hits in /stats); an "
                         "admission drops the prefetched segment, so it pays under light load")
    return ap


class TPRun(NamedTuple):
    """A tensor-parallel server's place: its mesh, the replay ops' group
    and whether it made the process group (and so leaves it)."""
    mesh: object
    group: object
    made: bool


def start_tp(args) -> TPRun:
    """Join torchrun's group (NCCL on ``cuda:LOCAL_RANK``; gloo under
    ``--device cpu``; a group made before is joined as it is) and lay the
    ranks out as a (dp 1, model N) mesh."""
    import torch.distributed as dist

    from .parallel import mesh as M
    from .parallel.replay import replay_group

    made = not dist.is_initialized()
    dev = M.init_distributed(args.device)
    return TPRun(M.make_mesh(dp=1, model=args.tp, device=dev), replay_group(), made)


def end_tp(tp: TPRun) -> None:
    import torch.distributed as dist

    if tp.made:
        dist.destroy_process_group()
    else:
        dist.destroy_process_group(tp.group)


def build_server(args, tp: Optional[TPRun] = None) -> TTSServer:
    """The API, the weights' options and the voices of ``args`` in a
    server (nothing listens yet); under ``tp`` on the mesh's device, the
    LLM and the flow split over it after the voices are set, and on rank 0
    a server that sends its device sections to the followers."""
    refuse_queued_flags(args)
    if args.aot_cache is not None:
        from .utils import aot

        try:
            print(f"library cache: {aot.set_cache_dir(args.aot_cache)}")
        except aot.UntrustedCacheDir as e:
            raise SystemExit(f"--aot-cache refused: {e}") from None
    from .api import CosyVoice, CosyVoice2
    from .config import InferenceConfig, replace
    from .params import load_torch_checkpoint

    override_flow = None
    if args.flow_weights:
        override_flow = load_torch_checkpoint(args.flow_weights)
    fnorm = resolve_finetuned_norm(args.flow_weights, override_flow, args.finetuned_norm,
                                   args.cosyvoice2)
    icfg = None
    if args.sampler == "meanflow" or args.int8:
        # the model dir's yaml knobs survive the sampler and int8 overrides
        yaml_path = os.path.join(args.model_dir, "cosyvoice.yaml")
        if not args.cosyvoice2 and os.path.exists(yaml_path):
            from .compat.yaml_config import inference_config_from_yaml

            icfg = inference_config_from_yaml(yaml_path)
        icfg = replace(icfg or InferenceConfig(), int8_decode=args.int8)
        if args.sampler == "meanflow":
            icfg = replace(icfg, sampler="meanflow", meanflow_steps=2 if args.meanflow_steps
                           is None else args.meanflow_steps)
    kw = dict(infer_cfg=icfg, device=args.device if tp is None else tp.mesh.device,
              flow_state=override_flow)
    try:  # the pipeline holds the sampler against the flow weights
        api = (CosyVoice2(args.model_dir, **kw) if args.cosyvoice2
               else CosyVoice(args.model_dir, finetuned_norm=fnorm, **kw))
    except ValueError as e:
        raise SystemExit(f"error: {e}") from None
    model = api.model
    if override_flow is not None:
        print(f"flow weights <- {args.flow_weights}")
    if args.sampler == "meanflow":
        print(f"flow sampler: meanflow, {icfg.meanflow_steps} steps")
    if args.int8:
        print("decode: weight-only int8")
    if args.attn_window:
        if args.cosyvoice2:
            model.fcfg = replace(model.fcfg, estimator=replace(
                model.fcfg.estimator, attn_window=args.attn_window))
        else:
            model.cfg = replace(model.cfg, flow=replace(model.cfg.flow, estimator=replace(
                model.cfg.flow.estimator, attn_window=args.attn_window)))
    if args.voices:
        voices, llm_s, flow_s = parse_voices(args.voices)
        model.set_voices(voices, llm_scale=llm_s, flow_scale=flow_s)
        print(f"voices: {list(voices)} (un-merged adapter routing)")
    if tp is None:
        return TTSServer(api, engine_slots=args.engine_slots,
                         engine_prefetch=args.engine_prefetch)
    n_llm, n_flow = model.shard(tp.mesh)
    print(f"LLM+flow tensor-parallel over {args.tp} ranks ({n_llm} llm + {n_flow} flow split "
          "params)")
    leader = tp.mesh.coord("model") == 0
    return TTSServer(api, engine_slots=args.engine_slots,
                     replay_group=tp.group if leader else None,
                     engine_prefetch=args.engine_prefetch)


def main(argv=None):
    """Serve until SIGTERM / SIGINT.  Under ``--tp`` returns this rank's
    replay count: ``{"sent": n}`` on rank 0, ``{"replayed": n, "errors":
    [...]}`` on a follower."""
    args = build_parser().parse_args(argv)
    refuse_queued_flags(args)
    tp = start_tp(args) if args.tp > 1 else None
    return serve(build_server(args, tp), args, tp)


def serve(server: TTSServer, args, tp: Optional[TPRun] = None):
    """``main`` after the server is built: listen on ``args.port`` until a
    signal drains it (a follower runs rank 0's sections until its stop)."""
    if tp is not None and server.replay is None:
        return _follow(server, tp)
    if args.warmup:
        print("warmup: one request of each route ...", flush=True)
        print(f"warmup done in {warmup(server):.1f} s", flush=True)
    httpd = ThreadingHTTPServer(("0.0.0.0", args.port),
                                make_handler(server, server.api.sample_rate))
    import signal

    def _drain(signum, frame):
        print(f"signal {signum}: draining ({server.active_requests} in flight) ...", flush=True)
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)
    print(f"cosy_tpu_torch TTS server on :{args.port}", flush=True)
    httpd.serve_forever()  # returns after shutdown()
    deadline = time.time() + args.drain_timeout
    while server.active_requests > 0 and time.time() < deadline:
        time.sleep(0.1)
    httpd.server_close()
    if server.engine is not None:
        server.engine.stop()
    print(f"drained; served {sum(server.stats()['requests'].values())} requests total")
    if tp is not None:
        server.replay.stop()
        print(f"sent {server.replay.sent} device sections to {args.tp - 1} follower(s)",
              flush=True)
        end_tp(tp)
        return {"sent": server.replay.sent}


def _follow(server: TTSServer, tp: TPRun) -> dict:
    """A follower's whole serve: it runs rank 0's device sections until rank
    0's stop.  A signal does not stop it: rank 0's drain does."""
    import signal

    from .parallel.replay import follow

    before = {sig: signal.signal(sig, signal.SIG_IGN) for sig in (signal.SIGTERM, signal.SIGINT)}
    print(f"rank {tp.mesh.coord('model')}: following rank 0", flush=True)
    try:
        res = follow(tp.group, server.api.model, server.engine)
    finally:
        for sig, handler in before.items():
            signal.signal(sig, handler)
    print(f"rank {tp.mesh.coord('model')}: replayed {res['replayed']} device sections "
          f"({len(res['errors'])} raised, as on rank 0)", flush=True)
    end_tp(tp)
    return res


if __name__ == "__main__":
    main()
