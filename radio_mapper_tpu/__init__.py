"""radio_mapper_tpu — a batched TDOA geolocation framework on an accelerator.

A from-scratch JAX/XLA re-design of the capabilities of the reference
system ``physiii/radio-mapper`` (a distributed RTL-SDR "buoy" network that
detects radio signals via FFT power spectra and triangulates emitters with
time-difference-of-arrival hyperbolic positioning; see
``/root/reference/README.md``).

Instead of per-dongle Python threads and a 35-second serial frequency
schedule, this framework processes *batched* channels on one device
(an NVIDIA GPU) or a mesh of them:

- IQ ingest lands in device memory as ``uint8`` interleaved I/Q and is decoded on
  device (:mod:`radio_mapper_tpu.ops.iq`).
- The power-spectrum detector (reference ``buoy_node.py:401-433``) becomes a
  batched windowed-FFT PSD + static top-k peak kernel
  (:mod:`radio_mapper_tpu.ops.detect`).
- TDOA is measured at the *waveform* level with batched GCC-PHAT
  cross-correlation and sub-sample parabolic peak interpolation
  (:mod:`radio_mapper_tpu.ops.gcc_phat`) — the capability the reference
  specifies but never implemented (``Documents/TDOA_README.md:66-67``).
- Position fixes come from a batched, damped Gauss-Newton hyperbolic
  least-squares solver (:mod:`radio_mapper_tpu.solver`) replacing the
  reference's unstable scipy BFGS (``tdoa_processor.py:281-286``).
- Channels and time blocks shard over a ``jax.sharding.Mesh`` with
  overlap-save halo exchange via collective permutes
  (:mod:`radio_mapper_tpu.parallel`).
"""

from radio_mapper_tpu.version import __version__

from radio_mapper_tpu import constants
from radio_mapper_tpu import geo
from radio_mapper_tpu import ops
from radio_mapper_tpu import sim
from radio_mapper_tpu import solver

__all__ = [
    "__version__",
    "constants",
    "geo",
    "ops",
    "sim",
    "solver",
]
