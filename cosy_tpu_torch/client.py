"""HTTP client for the TTS server (``cosy_tpu_torch.serve``; the port's copy
of the JAX package's ``client.py``, numpy and the standard library only).

Library:

    from cosy_tpu_torch.client import TTSClient
    c = TTSClient("http://localhost:8080")
    wav, sr = c.tts("你好。")                      # complete utterance
    for chunk in c.tts_stream("长文本 ..."):        # float32 chunks as produced
        play(chunk)
    c.stats()                                      # serving statistics

CLI:

    python -m cosy_tpu_torch.client --text "你好。" --out out.wav [--stream]
        [--url http://localhost:8080] [--voice name] [--spk-id x] [--speed 1.0]

The reference has no serving client (its serving story is the vLLM plugin,
cosyvoice/vllm/cosyvoice2.py); this completes the server/client pair.
"""

from __future__ import annotations

import argparse
import json
import struct
import urllib.request
from typing import Iterator, Tuple

import numpy as np

__all__ = ["TTSClient"]

_WAV_HEADER_LEN = 44


def _pcm16_to_float(data: bytes) -> np.ndarray:
    return np.frombuffer(data, "<i2").astype(np.float32) / 32767.0


class TTSClient:
    def __init__(self, base_url: str = "http://localhost:8080",
                 timeout: float = 600.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    # -- health / observability ----------------------------------------

    def healthz(self) -> bool:
        try:
            with urllib.request.urlopen(f"{self.base_url}/healthz",
                                        timeout=min(self.timeout, 10)) as r:
                return r.read() == b"ok"
        except OSError:
            return False

    def stats(self) -> dict:
        with urllib.request.urlopen(f"{self.base_url}/stats",
                                    timeout=self.timeout) as r:
            return json.loads(r.read())

    # -- synthesis ------------------------------------------------------

    def _request(self, text: str, stream: bool, spk_id: str, speed: float,
                 voice: str):
        body = {"text": text, "stream": stream}
        if spk_id:
            body["spk_id"] = spk_id
        if voice:
            body["voice"] = voice
        if speed != 1.0:
            body["speed"] = speed
        return urllib.request.Request(
            f"{self.base_url}/tts", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})

    def tts(self, text: str, spk_id: str = "", speed: float = 1.0,
            voice: str = "") -> Tuple[np.ndarray, int]:
        """Synthesize a complete utterance.  Returns (float32 wav, rate)."""
        req = self._request(text, False, spk_id, speed, voice)
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            blob = r.read()
        if blob[:4] != b"RIFF":
            raise RuntimeError(f"unexpected response: {blob[:80]!r}")
        sr = struct.unpack("<I", blob[24:28])[0]
        return _pcm16_to_float(blob[_WAV_HEADER_LEN:]), sr

    def tts_stream(self, text: str, spk_id: str = "", voice: str = "",
                   speed: float = 1.0,
                   chunk_bytes: int = 8192) -> Iterator[np.ndarray]:
        """Stream synthesis: yields float32 chunks as the server produces
        them (chunked WAV; the header is consumed here).  An odd-length read
        carries its trailing byte into the next chunk so PCM16 framing holds."""
        req = self._request(text, True, spk_id, speed, voice)
        r = urllib.request.urlopen(req, timeout=self.timeout)
        try:
            hdr = r.read(_WAV_HEADER_LEN)
            if hdr[:4] != b"RIFF":
                raise RuntimeError(f"unexpected stream head: {hdr[:40]!r}")
            self.last_sample_rate = struct.unpack("<I", hdr[24:28])[0]
            carry = b""
            while True:
                data = r.read(chunk_bytes)
                if not data:
                    break
                data = carry + data
                cut = len(data) - (len(data) % 2)
                carry = data[cut:]
                if cut:
                    yield _pcm16_to_float(data[:cut])
        finally:
            r.close()

    def sample_rate(self, text: str = ".") -> int:
        """One tiny round trip to learn the server's output rate."""
        _, sr = self.tts(text)
        return sr


def main(argv=None):
    ap = argparse.ArgumentParser(description="TTS client")
    ap.add_argument("--url", default="http://localhost:8080")
    ap.add_argument("--text", required=True)
    ap.add_argument("--out", default="out.wav")
    ap.add_argument("--stream", action="store_true",
                    help="consume chunked streaming (writes the same file; "
                         "prints time-to-first-audio)")
    ap.add_argument("--spk-id", default="")
    ap.add_argument("--voice", default="")
    ap.add_argument("--speed", type=float, default=1.0)
    ap.add_argument("--stats", action="store_true",
                    help="print server /stats after synthesis")
    args = ap.parse_args(argv)

    import time

    c = TTSClient(args.url)
    t0 = time.time()
    if args.stream:
        chunks, ttfa = [], None
        for ch in c.tts_stream(args.text, spk_id=args.spk_id,
                               voice=args.voice, speed=args.speed):
            if ttfa is None:
                ttfa = time.time() - t0
            chunks.append(ch)
        wav = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
        sr = getattr(c, "last_sample_rate", 22050)
        print(f"TTFA {ttfa:.2f}s" if ttfa is not None else "no audio")
    else:
        wav, sr = c.tts(args.text, spk_id=args.spk_id, speed=args.speed,
                        voice=args.voice)
    wall = time.time() - t0
    from .serve import wav_bytes

    with open(args.out, "wb") as f:
        f.write(wav_bytes(wav, sr))
    dur = len(wav) / sr if sr else 0.0
    print(f"{args.out}: {dur:.2f}s audio in {wall:.2f}s "
          f"(RTF {wall / dur:.3f})" if dur else f"{args.out}: empty")
    if args.stats:
        print(json.dumps(c.stats(), indent=1))


if __name__ == "__main__":
    main()
