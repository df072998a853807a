"""RTL-SDR 8-bit interleaved I/Q <-> complex conversion.

The RTL-SDR emits unsigned 8-bit interleaved I/Q at a DC offset of 127.4;
conversion is ``(x - 127.4)/128`` (reference thrifty/block_data.py:38-67,
fastcard/rawconv.c:10-11).  Both a numpy host version and a JAX device
version (batched, fused by XLA into the FFT input) are provided.
"""

from __future__ import annotations

import numpy as np

DC_OFFSET = 127.4
SCALE = 1.0 / 128.0


def raw_to_iq(raw: np.ndarray) -> np.ndarray:
    """uint8 interleaved I/Q [..., 2N] -> complex64 [..., N] (host numpy)."""
    raw = np.asarray(raw, dtype=np.uint8)
    f = raw.astype(np.float32)
    i = (f[..., 0::2] - DC_OFFSET) * SCALE
    q = (f[..., 1::2] - DC_OFFSET) * SCALE
    return (i + 1j * q).astype(np.complex64)


def iq_to_raw(iq: np.ndarray) -> np.ndarray:
    """complex64 [..., N] -> uint8 interleaved I/Q [..., 2N] (host numpy)."""
    iq = np.asarray(iq, dtype=np.complex64)
    out = np.empty(iq.shape[:-1] + (2 * iq.shape[-1],), dtype=np.float32)
    out[..., 0::2] = iq.real
    out[..., 1::2] = iq.imag
    # Clip to the ADC range: values outside [0, 255] would wrap modulo
    # 256 in the uint8 cast and corrupt synthesized captures.  The
    # truncating cast (floor, ~-0.5 LSB bias) is deliberate parity
    # with the reference's complex_to_raw
    # (thrifty/block_data.py:55-67), which the committed golden
    # captures were generated through.
    return np.clip(out * 128.0 + DC_OFFSET, 0.0, 255.0).astype(np.uint8)


def raw_to_iq_jax(raw):
    """Device-side uint8 [..., 2N] -> complex64 [..., N].

    The interleaved I/Q pair is read as one uint16 (bitcast of the byte
    pair) and split with element-wise shift/mask instead of strided
    slicing (``[..., 0::2]``): pure element-wise work that XLA fuses
    into the consumer (typically the first FFT's input read).
    """
    import jax
    import jax.numpy as jnp

    pairs = raw.reshape(raw.shape[:-1] + (raw.shape[-1] // 2, 2))
    v = jax.lax.bitcast_convert_type(pairs, jnp.uint16)
    return u16_to_iq_jax(v)


def u16_to_iq_jax(v):
    """Device-side packed-sample uint16 [..., N] -> complex64 [..., N].

    Each uint16 is one interleaved I/Q byte pair in little-endian
    packing (low byte = I, the first byte on the wire) -- the same
    layout `np.ndarray.view(np.uint16)` produces on a little-endian
    host and `raw_to_iq_jax`'s bitcast produces on device.  Split out
    so the device-side overlap-save gather can move 2-byte samples
    and convert after gathering.
    """
    import jax
    import jax.numpy as jnp

    i = ((v & 0xFF).astype(jnp.float32) - DC_OFFSET) * SCALE
    q = ((v >> 8).astype(jnp.float32) - DC_OFFSET) * SCALE
    return jax.lax.complex(i, q)
