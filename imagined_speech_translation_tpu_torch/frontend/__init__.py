"""Signal frontend: IIR bandpass + notch (CUDA kernel) and common-average reference."""

from .filters import (  # noqa: F401
    design_bandpass,
    design_notch,
    sos_sections,
    sosfilt,
    sosfilt_reference,
)
from .frontend import SignalFrontend, common_average_reference  # noqa: F401
