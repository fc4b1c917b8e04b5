"""Compute ops: IQ codec, windows, spectral analysis, detection, GCC-PHAT."""

from radio_mapper_tpu.ops import fft
from radio_mapper_tpu.ops import iq
from radio_mapper_tpu.ops import windows
from radio_mapper_tpu.ops import spectral
from radio_mapper_tpu.ops import detect
from radio_mapper_tpu.ops import gcc_phat

__all__ = ["fft", "iq", "windows", "spectral", "detect", "gcc_phat"]
