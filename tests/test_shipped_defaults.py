"""Pin the defaults the GPU bring-up chose.

The pipeline has one route per stage: XLA's FFT for every transform, exact
gathers for the pair spectra, stock XLA reductions (safe mode off). A
refactor that brought back a matmul DFT, a one-hot gather or a platform
branch would change what runs on the card; these tests fail first."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp

from test_fft import primitives

REPO = Path(__file__).resolve().parents[1]


def test_kernel_routing_defaults():
    from radio_mapper_tpu.ops import safe
    from radio_mapper_tpu.ops import split_complex as sc_ops

    # stock reductions/gathers everywhere unless a caller opts in
    assert safe._MODE is None and safe.enabled() is False
    # the pair stage is FFT → elementwise → inverse FFT, no dot_general
    # (the only dots left on the path are the solver's 3×3 algebra)
    re_ = jnp.zeros((2, 4, 1024), jnp.float32)
    jaxpr = jax.make_jaxpr(
        lambda a, b: sc_ops.gcc_phat_all_pairs_split(a, b, sample_rate_hz=2.4e6, max_lag=64)
    )(re_, re_)
    prims = primitives(jaxpr.jaxpr)
    assert prims.count("fft") == 2, prims  # one forward, one inverse
    assert "dot_general" not in prims


def test_precision_policies():
    from radio_mapper_tpu.models.wideband import WidebandConfig, WidebandTDOAPipeline
    from radio_mapper_tpu.ops import fft as fft_ops

    # no precision knobs remain: XLA's FFT has no matmul precision
    for gone in ("set_precision", "set_inverse_precision", "MAX_DIRECT", "set_backend"):
        assert not hasattr(fft_ops, gone), gone
    # the wideband pair spectra are exact row gathers, not one-hot dots
    pipe = WidebandTDOAPipeline(WidebandConfig(
        num_buoys=6, wide_rate_hz=2_048_000.0, num_subchannels=4,
        sub_block=256, max_lag=16,
    ))
    x = jnp.zeros((6, 256), jnp.float32)
    prims = primitives(jax.make_jaxpr(pipe._pair_stage)(x, x).jaxpr)
    assert "gather" in prims and "dot_general" not in prims


def test_bench_scan_default():
    # scan depth 64 stays the bench default until it is measured on the GPU
    src = (REPO / "bench.py").read_text()
    m = re.search(r'BENCH_SCAN_BLOCKS", "(\d+)"', src)
    assert m and m.group(1) == "64", m
