"""Circular correlation and convolution, HolE's core op.

    cconv(a, b) = ifft(fft(a) * fft(b)).real
    ccorr(a, b) = ifft(conj(fft(a)) * fft(b)).real

Inputs are real, so both run as `torch.fft.rfft`/`irfft` with `n` set to
the last axis's length (cuFFT on the card), batched over the leading axes,
as `skge_tpu.ops.circulant` runs them through `jnp.fft`. They give the
adjoint identities HolE scores a pool or every entity with:

    score(s, o, p) = <r_p, ccorr(e_s, e_o)> = <e_o, cconv(e_s, r_p)>
                                            = <e_s, ccorr(r_p, e_o)>
"""

from __future__ import annotations

import torch


def cconv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Circular convolution along the last axis, batched over leading axes."""
    n = a.shape[-1]
    return torch.fft.irfft(torch.fft.rfft(a, n=n) * torch.fft.rfft(b, n=n), n=n)


def ccorr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Circular correlation along the last axis, batched over leading axes."""
    n = a.shape[-1]
    return torch.fft.irfft(
        torch.conj(torch.fft.rfft(a, n=n)) * torch.fft.rfft(b, n=n), n=n
    )
