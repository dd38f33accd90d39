"""Kernel and graph launch calls in the traced window a second of audio
delivered in it."""

from portbench.readers import launches_per_audio_s as read  # noqa: F401
