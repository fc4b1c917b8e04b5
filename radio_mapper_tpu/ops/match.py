"""Snippet pattern matching: normalized circular cross-correlation.

The reference extracts 256-sample IQ snippets from each detection "for
signal pattern matching" (`iq_stream_client.py:306-315`) and ships them in
the detection payload, but never implements the matching itself — searches
gate only on frequency/time (`iq_stream_client.py:317-344`,
`central_processor.py:205-235`). This op supplies the capability: score a
query snippet against a batch of stored snippets, invariant to circular
time shift, amplitude, and carrier phase, so "find this signal again"
works on waveforms rather than metadata.

Shape: one batched 256-point FFT per side, an elementwise cross-spectrum
and an inverse transform, in the framework's split re/im float32
representation.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from radio_mapper_tpu.ops import fft as fft_ops


def snippet_match_scores(
    hist_re: jnp.ndarray,
    hist_im: jnp.ndarray,
    query_re: jnp.ndarray,
    query_im: jnp.ndarray,
    *,
    eps: float = 1e-12,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Score stored snippets ``[M, N]`` against a query ``[N]``.

    Returns ``(scores [M], lags [M])``: ``scores`` is the peak magnitude of
    the circular cross-correlation normalized by both energies — 1.0 for
    the same waveform at any circular shift / gain / carrier phase, near 0
    for unrelated noise (Cauchy–Schwarz bounds it to [0, 1]). ``lags`` is
    the circular shift (in samples, range [-N/2, N/2)) at which the peak
    occurs: positive means the stored snippet is delayed vs the query.
    """
    n = hist_re.shape[-1]
    h_re = jnp.asarray(hist_re, jnp.float32)
    h_im = jnp.asarray(hist_im, jnp.float32)
    q_re = jnp.asarray(query_re, jnp.float32)
    q_im = jnp.asarray(query_im, jnp.float32)

    H_re, H_im = fft_ops.fft_re_im(h_re, h_im)
    Q_re, Q_im = fft_ops.fft_re_im(q_re, q_im)

    # Cross spectrum C = H · conj(Q), broadcast query over the batch.
    c_re = H_re * Q_re + H_im * Q_im
    c_im = H_im * Q_re - H_re * Q_im

    y_re, y_im = fft_ops.ifft_re_im(c_re, c_im)
    corr_mag = jnp.sqrt(y_re**2 + y_im**2)

    norm = jnp.sqrt(
        (jnp.sum(h_re**2 + h_im**2, axis=-1))
        * jnp.sum(q_re**2 + q_im**2, axis=-1)
    )
    scores = jnp.max(corr_mag, axis=-1) / (norm + eps)

    peak = jnp.argmax(corr_mag, axis=-1)
    lags = jnp.where(peak >= n // 2, peak - n, peak)
    return scores, lags


def snippet_match_scores_np(history, query):
    """Host convenience wrapper: complex numpy in, numpy (scores, lags) out."""
    import numpy as np

    hist = np.atleast_2d(np.asarray(history, np.complex64))
    q = np.asarray(query, np.complex64)
    scores, lags = snippet_match_scores(
        jnp.asarray(hist.real), jnp.asarray(hist.imag),
        jnp.asarray(q.real), jnp.asarray(q.imag),
    )
    return np.asarray(scores), np.asarray(lags)
