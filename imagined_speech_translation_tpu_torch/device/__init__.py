"""Acquisition-device firmware twin (native ``device_native/``).

The reference's hardware layer ships as design files only (STM32 CubeMX
pin config + ECAD, ``main_model/hardware/``; SURVEY.md L-2) — 48
micro-needle electrodes into 6x ADS1299 24-bit AFEs over SPI, an
STM32H750 pump, WiFi uplink.  ``device_native/`` is the executable
counterpart: a datasheet-faithful ADS1299 register/command/frame
simulator and a board-level firmware twin that produces the exact binary
wire frames the runtime server consumes.  This package is the ctypes
binding: build the shared library on demand and drive the board from
Python (tests, load generators, protocol documentation-as-code).

A copy of ``imagined_speech_translation_tpu.device`` (it imports no jax), so
the port imports nothing of the JAX package; a test holds its code to the
original's.
"""

from .native import NativeBoard, build_native_library, find_native_library

__all__ = ["NativeBoard", "build_native_library", "find_native_library"]
