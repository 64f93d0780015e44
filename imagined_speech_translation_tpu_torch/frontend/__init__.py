"""Signal frontend: IIR bandpass + notch (CUDA kernel), common-average
reference and STFT log-spectrogram features."""

from .filters import (  # noqa: F401
    design_bandpass,
    design_notch,
    sos_sections,
    sosfilt,
    sosfilt_reference,
)
from .frontend import SignalFrontend, common_average_reference  # noqa: F401
from .stft import frame_signal, log_spectrogram, stft_magnitude  # noqa: F401
