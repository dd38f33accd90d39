"""Seconds of audio the window's whole token2wav calls produced over the
seconds from the first call's start to the last one's synchronised end."""


def read(rec):
    return rec.audio_s / rec.window_s if rec.audio_s > 0 else None
