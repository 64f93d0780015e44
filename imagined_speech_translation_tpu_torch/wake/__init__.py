"""Wake-event detector: native C++ library bindings + PyTorch twin
(reference: ``wake_model/`` — an on-device detector that gates when the
expensive decoder runs).  Port of ``imagined_speech_translation_tpu.wake``;
the same names, with ``WakeMLP`` and ``make_wake_train_step`` in torch."""

from .native import NativeWakeModel, build_native_library, find_native_library  # noqa: F401
from .twin import WakeMLP, make_wake_train_step  # noqa: F401
