"""The port's HTTP server and client over a tiny CosyVoice on the CPU, real
sockets, a timeout on every wait: ``wav_bytes`` byte-equal to the JAX
package's; whole and chunked round trips; concurrent requests sharing a
batch; the cohort route with its error isolation and worker respawn, and
cohorts interleaving at segment boundaries; the engine route with a zero
speaker embedding; keep-alive framing and bad bodies; the device lock
released between chunks; voice routing with its 400s; /stats, /metrics and
TTFA records; ``resolve_finetuned_norm`` on weight-meta sidecars (the cases
of tests/test_weight_meta.py); the client round trip and a server that is
down; the flags whose modules are queued, refused; ``--int8`` with and
without ``--voices`` over a socket."""

import http.client
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from cosy_tpu.config import tiny_model_config as j_tiny
from cosy_tpu.serve import wav_bytes as j_wav_bytes
from cosy_tpu_torch.api import CosyVoice
from cosy_tpu_torch.client import TTSClient
from cosy_tpu_torch.config import InferenceConfig, LoRAConfig
from cosy_tpu_torch.data.frontend import Frontend
from cosy_tpu_torch.infer.pipeline import TTSPipeline
from cosy_tpu_torch.lora import init_lora
from cosy_tpu_torch.params import load_weight_meta, save_torch_checkpoint, save_weight_meta
from cosy_tpu_torch.serve import (TTSServer, build_parser, build_server, make_handler,
                                  resolve_finetuned_norm, wav_bytes)
from test_torch_common import port_config, port_modules, tiny_flats
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

SR = 22050
WAIT = 120  # seconds: the bound of every wait here


def _voice(params, seed):
    lo = init_lora(torch.Generator().manual_seed(seed), params, LoRAConfig(r=2, alpha=4,
                                                                           dropout=0.0))
    return {k: (v * 8 if ".lora_B" in k else v).detach() for k, v in lo.items()}


@pytest.fixture(scope="module")
def api():
    """One tiny CosyVoice for the module (each test wraps its own server):
    byte ids from the frontend's fallback, two registered voices."""
    jcfg = j_tiny()
    tcfg = port_config(jcfg)
    mods = port_modules(tcfg, tiny_flats(jcfg, seed=40))
    a = CosyVoice.__new__(CosyVoice)
    a.model_dir, a.cfg, a.sample_rate, a.device = "unused", tcfg, SR, torch.device("cpu")
    a.frontend = Frontend(None, SR, device="cpu")
    # decodes of at most 3 tokens a text id keep the round trips cheap
    a.model = TTSPipeline(tcfg, *mods, InferenceConfig(max_token_text_ratio=3.0),
                          finetuned_norm=True)
    a.model.set_voices({n: {"llm": _voice(mods[0].p.d, s), "flow": None}
                        for n, s in (("alice", 7), ("bob", 8))})
    a._seed, a._n = 0, 0
    a.frontend.spk2info["spk_a"] = {"embedding": np.ones((1, 192), np.float32)}
    return a


class _Live:
    """A server on 127.0.0.1 port 0 in a daemon thread; shut down on exit."""

    def __init__(self, server):
        self.server = server
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server, SR))
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self.server.engine is not None:
            self.server.engine.stop(timeout=WAIT)

    def post(self, body: dict):
        req = urllib.request.Request(f"{self.url}/tts", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            return r.headers, r.read()

    def get(self, path: str):
        with urllib.request.urlopen(f"{self.url}{path}", timeout=WAIT) as r:
            return r.read()


def _wait_for(pred, timeout=10.0):
    """Request accounting runs after the client has read the response:
    poll briefly instead of asserting the instant view."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _join(threads):
    for th in threads:
        th.join(timeout=WAIT)
        assert not th.is_alive(), "a request thread did not finish"


def _pcm_ok(body: bytes):
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE" and len(body) > 44
    assert (len(body) - 44) % 2 == 0


def test_wav_bytes_equal_jax():
    wav = np.sin(np.linspace(0, 10, 1001)).astype(np.float32) * 1.3
    assert wav_bytes(wav, SR) == j_wav_bytes(wav, SR)
    assert len(wav_bytes(wav, 24000)) == 44 + 2002


def test_whole_and_chunked_round_trips(api):
    with _Live(TTSServer(api)) as live:
        assert live.get("/healthz") == b"ok"
        hdr, body = live.post({"text": "hi."})
        _pcm_ok(body)
        assert hdr["Content-Length"] == str(len(body))
        hdr, body = live.post({"text": "hello.", "stream": True})
        assert hdr["Transfer-Encoding"] == "chunked"
        _pcm_ok(body)
        _, body = live.post({"text": "hi.", "spk_id": "spk_a"})  # inference_sft
        _pcm_ok(body)
        with pytest.raises(urllib.error.HTTPError) as ei:
            live.post({})
        assert ei.value.code == 400
        assert _wait_for(lambda: sum(live.server.stats()["requests"].values()) == 4)
        s = live.server.stats()
        assert s["requests"] == {"batched": 1, "stream_cohort": 1, "solo_sft": 1,
                                 "bad_request": 1}


def test_concurrent_requests_share_a_batch(api):
    server = TTSServer(api, batch_window_ms=300.0)
    results, errs = {}, []

    def one(i):
        try:
            results[i] = server.synthesize_batched(f"hey {i}.")
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(3)]
    for th in threads:
        th.start()
    _join(threads)
    assert not errs and len(results) == 3
    assert all(w.ndim == 1 and w.size > 0 and np.isfinite(w).all() for w in results.values())
    assert server.batches_run <= 2


def test_concurrent_streams_share_a_cohort(api):
    with _Live(TTSServer(api, batch_window_ms=1500.0)) as live:
        results = {}
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, live.post({"text": f"number {i}.", "stream": True})[1])) for i in range(2)]
        for th in threads:
            th.start()
        _join(threads)
        assert set(results) == {0, 1}
        for body in results.values():
            _pcm_ok(body)
        assert live.server.batches_run == 1


def test_cohort_error_isolation_and_worker_respawn(api, monkeypatch):
    """A failure after one stream finished leaves that stream clean and
    fails only the unfinished one; a dead dispatcher is respawned."""
    server = TTSServer(api, batch_window_ms=200.0)

    def dying(ids_list, spks, seed=0):
        yield 0, np.zeros((1, 640), np.float32), True
        yield 1, np.zeros((1, 640), np.float32), False
        raise RuntimeError("boom")

    monkeypatch.setattr(api.model, "synthesize_stream_batch", dying)
    results = {}

    def one(i):
        try:
            results[i] = list(server.synthesize_stream_batched(f"text {i}"))
        except RuntimeError as e:
            results[i] = e

    threads = [threading.Thread(target=one, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    _join(threads)
    assert sorted(type(r).__name__ for r in results.values()) == ["RuntimeError", "list"]
    assert [len(r) for r in results.values() if isinstance(r, list)] == [1]

    def fine(ids_list, spks, seed=0):
        for b in range(len(ids_list)):
            yield b, np.zeros((1, 640), np.float32), True

    monkeypatch.setattr(api.model, "synthesize_stream_batch", fine)
    dead = threading.Thread(target=lambda: None)
    dead.start()
    dead.join()
    server._stream_thread = dead
    th = threading.Thread(target=lambda: list(server.synthesize_stream_batched("again")))
    th.start()
    _join([th])


def test_cohorts_interleave_at_segment_boundaries(api, monkeypatch):
    """A stream arriving mid-cohort gets its audio while the first cohort
    still decodes: cohorts hold the device lock per segment.  Events order
    the threads: the second request starts once the first cohort has made
    its first segment, and the first cohort's thread waits for the second
    stream's end before it takes the device lock for its next segment."""
    first_made, second_ended = threading.Event(), threading.Event()
    first_thread = []

    class HoldingLock:
        """The device lock; the first cohort's thread waits, outside it,
        for the second stream's end before each later segment."""

        def __init__(self):
            self.lock = threading.Lock()

        def __enter__(self):
            if first_thread and threading.current_thread() is first_thread[0]:
                assert second_ended.wait(timeout=WAIT), "the second stream never ended"
            return self.lock.__enter__()

        def __exit__(self, *exc):
            return self.lock.__exit__(*exc)

    server = TTSServer(api, lock=HoldingLock(), batch_window_ms=50.0)

    def slow_or_fast(ids_list, spks, seed=0):
        tag = int(ids_list[0][0, 0])
        n = 10 if tag == 0 else 1
        for seg in range(n):
            if tag == 0 and seg == 0:  # inside next(): under the device lock
                first_thread.append(threading.current_thread())
                first_made.set()
            for b in range(len(ids_list)):
                yield b, np.zeros((1, 640), np.float32), seg == n - 1

    monkeypatch.setattr(api.model, "synthesize_stream_batch", slow_or_fast)
    monkeypatch.setattr(api.frontend, "normalize", lambda text, split=False: text)
    monkeypatch.setattr(api.frontend, "extract_text_token",
                        lambda text: np.asarray([[int(text), 5]], np.int32))
    t0 = threading.Thread(target=lambda: list(server.synthesize_stream_batched("0")))
    t0.start()
    assert first_made.wait(timeout=WAIT), "the first cohort made no segment"
    t1 = threading.Thread(target=lambda: list(server.synthesize_stream_batched("1")))
    t1.start()
    _join([t1])
    assert t0.is_alive(), "the first cohort ended before the second: no interleaving"
    second_ended.set()
    _join([t0])
    assert server.batches_run == 2


def test_engine_route_with_zero_speaker(api):
    """--engine-slots: prompt-free streams go through the engine (not a
    cohort), submitted with the zero speaker embedding every other
    prompt-free route uses."""
    server = TTSServer(api, engine_slots=2)
    server.engine.max_len = 64
    seen = []
    real = server.engine.submit
    server.engine.submit = lambda ids, spk=None, seed=0: (seen.append(spk), real(ids, spk,
                                                                                  seed))[1]
    with _Live(server) as live:
        results = {}
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, live.post({"text": f"hi {i}.", "stream": True})[1])) for i in range(2)]
        for th in threads:
            th.start()
        _join(threads)
        for body in results.values():
            _pcm_ok(body)
        assert server.engine.segments_run >= 1 and server.batches_run == 0
        assert len(seen) == 2 and all(s.shape == (1, 192) and not s.any() for s in seen)
        assert _wait_for(lambda: server.stats()["requests"].get("stream_engine") == 2)
        assert server.stats()["engine"]["slots"] == 2


def test_keepalive_framing_and_bad_bodies(api):
    with _Live(TTSServer(api)) as live:
        conn = http.client.HTTPConnection("127.0.0.1", live.port, timeout=WAIT)
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        assert r.status == 200 and r.getheader("Content-Length") == "2" and r.read() == b"ok"
        conn.request("GET", "/nope")
        r = conn.getresponse()
        assert r.status == 404 and r.getheader("Content-Length") is not None
        r.read()
        for body in (b"[1, 2]", json.dumps({"text": "hi.", "speed": "fast"}).encode(),
                     b"{not json"):
            conn.request("POST", "/tts", body=body)
            r = conn.getresponse()
            assert r.status == 400
            r.read()
        conn.request("GET", "/healthz")
        assert conn.getresponse().read() == b"ok"
        conn.close()


def test_lock_released_between_chunks(api):
    server = TTSServer(api)
    gen = server.synthesize("hello there friend.", stream=True)
    assert next(gen).size > 0
    assert server.lock.acquire(timeout=WAIT), "the device lock was held across a yield"
    server.lock.release()
    for _ in gen:
        pass


def test_voice_routing_and_its_400s(api):
    with _Live(TTSServer(api)) as live:
        _, a = live.post({"text": "hello.", "voice": "alice"})
        _, b = live.post({"text": "hello.", "voice": "bob"})
        _pcm_ok(a)
        _pcm_ok(b)
        assert a != b
        _, s = live.post({"text": "hello.", "voice": "alice", "stream": True})
        _pcm_ok(s)
        for body, msg in (({"text": "hi.", "voice": "mallory"}, b"unknown voice"),
                          ({"text": "hi.", "voice": "alice", "spk_id": "x"},
                           b"mutually exclusive")):
            with pytest.raises(urllib.error.HTTPError) as ei:
                live.post(body)
            assert ei.value.code == 400 and msg in ei.value.read()


def test_stats_metrics_and_ttfa(api):
    with _Live(TTSServer(api)) as live:
        s0 = json.loads(live.get("/stats"))
        assert s0["requests"] == {} and s0["active_requests"] == 0
        live.post({"text": "hi.", "speed": 1.1})
        live.post({"text": "hello.", "stream": True})
        with pytest.raises(urllib.error.HTTPError):
            live.post({})

        def stats():
            return json.loads(live.get("/stats"))

        assert _wait_for(lambda: sum(stats()["requests"].values()) == 3)
        s = stats()
        assert s["requests"] == {"batched": 1, "stream_cohort": 1, "bad_request": 1}
        assert s["errors"] == {"bad_request": 1}
        assert s["audio_seconds"] > 0 and s["rtf"]["window"] == 2
        assert s["ttfa_s"]["window"] == 1 and s["ttfa_s"]["p50"] > 0
        text = live.get("/metrics").decode()
        assert 'cosy_tpu_requests_total{route="batched"} 1' in text
        assert 'cosy_tpu_errors_total{route="bad_request"} 1' in text
        assert "cosy_tpu_rtf{quantile=" in text and "cosy_tpu_ttfa_seconds{quantile=" in text


def test_failure_counts_against_the_real_route(api):
    server = TTSServer(api)

    def boom(text, spk_id="", speed=1.0, stream=False, voice=""):
        raise ValueError("synthesis exploded")
        yield  # a generator

    server.synthesize = boom
    with _Live(server) as live:
        try:
            live.post({"text": "hi.", "spk_id": "spk_a"})
        except (urllib.error.URLError, http.client.HTTPException, OSError):
            pass  # the handler dies mid-response; the stats are the point
        assert _wait_for(lambda: server.stats()["errors"].get("solo_sft") == 1)
        assert "bad_request" not in server.stats()["errors"]


def test_client_round_trip_and_down(api):
    with _Live(TTSServer(api)) as live:
        c = TTSClient(live.url, timeout=WAIT)
        assert c.healthz()
        wav, sr = c.tts("hi.", speed=1.1)
        assert sr == SR and wav.dtype == np.float32 and wav.size > 0
        assert np.abs(wav).max() <= 1.0
        chunks = list(c.tts_stream("hi.", voice="alice"))
        assert chunks and all(ch.dtype == np.float32 for ch in chunks)
        assert c.last_sample_rate == SR
        assert _wait_for(lambda: sum(c.stats()["requests"].values()) == 2)
    assert TTSClient("http://127.0.0.1:9", timeout=5).healthz() is False


# -- weight provenance -----------------------------------------------------


def test_weight_meta_round_trip(tmp_path):
    path = str(tmp_path / "w.pt")
    save_torch_checkpoint({"a.weight": np.zeros((2, 2), np.float32)}, path)
    assert load_weight_meta(path) is None
    save_weight_meta(path, mel_space="normalized", producer="test")
    assert load_weight_meta(path) == {"mel_space": "normalized", "producer": "test"}
    assert list(torch.load(path, weights_only=True)) == ["a.weight"]


@pytest.mark.parametrize("case", ["explicit", "sidecar_normalized", "sidecar_raw",
                                  "distilled", "unknown", "defaults"])
def test_resolve_finetuned_norm(tmp_path, case):
    path = str(tmp_path / "w.pt")
    key = ("decoder.estimator.time_mlp_s.linear_1.weight" if case == "distilled"
           else "a.weight")
    w = {key: torch.zeros(2)}
    save_torch_checkpoint(w, path)
    if case == "explicit":
        save_weight_meta(path, mel_space="normalized")
        assert resolve_finetuned_norm(path, w, 0, False) is False
        assert resolve_finetuned_norm(path, w, 1, False) is True
    elif case.startswith("sidecar"):
        space = case.split("_")[1]
        save_weight_meta(path, mel_space=space)
        assert resolve_finetuned_norm(path, w, None, False) is (space == "normalized")
    elif case == "distilled":
        assert resolve_finetuned_norm(path, w, None, False) is True
    elif case == "unknown":
        with pytest.raises(SystemExit, match="finetuned-norm"):
            resolve_finetuned_norm(path, w, None, False)
    else:
        assert resolve_finetuned_norm(None, None, None, False) is False
        assert resolve_finetuned_norm(path, w, None, True) is False  # CosyVoice2


def test_export_merged_writes_the_flow_sidecar(tmp_path):
    from cosy_tpu_torch.config import TrainConfig
    from cosy_tpu_torch.train.trainer import JointTrainer

    jcfg = j_tiny()
    tcfg = port_config(jcfg)
    llm, flow, _ = port_modules(tcfg, tiny_flats(jcfg, seed=50))
    tr = JointTrainer(tcfg, TrainConfig(training_mode="joint", bf16=False), llm, flow,
                      out_dir=str(tmp_path), total_steps=1)
    tr.export_merged(tr.init_state(torch.Generator().manual_seed(0)), save=True)
    flow_pt = str(tmp_path / "flow_merged_joint.pt")
    assert load_weight_meta(flow_pt)["mel_space"] == "normalized"
    assert resolve_finetuned_norm(flow_pt, {}, None, False) is True
    assert load_weight_meta(str(tmp_path / "llm_merged_joint.pt")) is None


# -- the command line ------------------------------------------------------


@pytest.mark.parametrize("flags, item", [
    (["--tp", "2"], "A16"), (["--int8", "--tp", "2"], "A16"), (["--aot-cache", None], "writable"),
    (["--sampler", "euler", "--meanflow-steps", "1"], "A14"), (["--meanflow-steps", "2"], "A14"),
    (["--engine-prefetch"], "A9"), (["--voices", "a=b.pt", "--cosyvoice2"], "CosyVoice")])
def test_refused_flags(flags, item, tmp_path):
    if None in flags:  # a library cache any user could write a library into
        open_dir = tmp_path / "open"
        open_dir.mkdir()
        open_dir.chmod(0o777)
        flags = [str(open_dir) if f is None else f for f in flags]
    with pytest.raises(SystemExit, match=item):
        build_server(build_parser().parse_args(["--model-dir", "nowhere"] + flags))


def test_int8_server_answers_over_a_socket(tmp_path, monkeypatch):
    """``--int8``, and ``--int8 --voices``, on a model dir over 127.0.0.1:
    every decode step reads the pipeline's int8 view (six int8 matrices a
    block), and a voiced request's steps carry its adapters."""
    import cosy_tpu_torch.api as TAPI
    import cosy_tpu_torch.models.llm as TL

    jcfg = j_tiny()
    tcfg = port_config(jcfg)
    flats = tiny_flats(jcfg, seed=41)
    for part, flat in flats.items():
        save_torch_checkpoint(flat, str(tmp_path / f"{part}.pt"))
    voice = _voice(port_modules(tcfg, flats)[0].p.d, 7)
    adapters = str(tmp_path / "adapters_a.pt")
    save_torch_checkpoint({**{"llm." + k: v.numpy() for k, v in voice.items()},
                           "llm._scaling": np.array(2.0, np.float32)}, adapters)
    real = TAPI.CosyVoice
    # the tiny topology: the model dir has no cosyvoice.yaml
    monkeypatch.setattr(TAPI, "CosyVoice", lambda d, **kw: real(d, model_cfg=tcfg, **kw))
    seen = []
    step = TL.llm_decode_step_batch

    def spy(p, *a):
        seen.append((p.d, a[-1].lora is not None))
        return step(p, *a)

    monkeypatch.setattr(TL, "llm_decode_step_batch", spy)
    common = ["--model-dir", str(tmp_path), "--device", "cpu", "--finetuned-norm", "1", "--int8"]
    for extra, body in (([], {"text": "hi."}),
                        (["--voices", f"a={adapters}"], {"text": "hi.", "voice": "a"})):
        server = build_server(build_parser().parse_args(common + extra))
        model = server.api.model
        assert model.icfg.int8_decode
        assert sum(v.dtype == torch.int8 for v in model.llm_step_p.d.values()) \
            == 6 * tcfg.llm.llm.num_blocks
        seen.clear()
        with _Live(server) as live:
            _pcm_ok(live.post(body)[1])
        assert seen and all(d is model.llm_step_p.d and lora == bool(extra) for d, lora in seen)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_no_card_without_device_cpu_raises(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        build_server(build_parser().parse_args(["--model-dir", str(tmp_path)]))
