"""The signal chain: bandpass -> notch -> common-average reference
(``preprocess``, the serving path's), then the STFT log-spectrogram
(``features``).

Port of ``imagined_speech_translation_tpu.frontend.frontend``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import FrontendConfig

from .filters import design_bandpass, design_notch, sosfilt
from .stft import log_spectrogram


def common_average_reference(x: torch.Tensor, channel_mask=None) -> torch.Tensor:
    """Subtract the cross-channel mean at each timepoint; ``channel_mask``
    (over the -2 axis) excludes padded channels from the average."""
    if channel_mask is None:
        return x - x.mean(dim=-2, keepdim=True)
    m = torch.as_tensor(channel_mask, device=x.device).to(x.dtype)[..., :, None]
    mean = (x * m).sum(dim=-2, keepdim=True) / m.sum(dim=-2, keepdim=True).clamp_min(1.0)
    return torch.where(m > 0, x - mean, x)


class SignalFrontend:
    """Host-designed filters + the fused on-device IIR, then CAR.

    ``preprocess``: float32 ``(..., C, T)`` -> filtered, re-referenced signal.
    ``features``: adds the STFT log-spectrogram -> ``(..., C, F, bins)``.
    """

    def __init__(self, cfg: FrontendConfig | None = None):
        self.cfg = cfg or FrontendConfig()
        c = self.cfg
        self.sos_bandpass = design_bandpass(
            c.bandpass_low_hz, c.bandpass_high_hz, c.sample_rate_hz, c.bandpass_order
        ).astype(np.float32)
        self.sos_notch = design_notch(c.notch_hz, c.notch_q, c.sample_rate_hz).astype(
            np.float32
        )

    def preprocess(self, x: torch.Tensor, channel_mask=None) -> torch.Tensor:
        y = sosfilt([self.sos_bandpass, self.sos_notch], x)
        if self.cfg.car:
            y = common_average_reference(y, channel_mask)
        return y

    def features(self, x: torch.Tensor, channel_mask=None) -> torch.Tensor:
        y = self.preprocess(x, channel_mask)
        c = self.cfg
        return log_spectrogram(y, nperseg=c.stft_nperseg, hop=c.stft_hop,
                               window=c.stft_window, eps=c.log_eps)
