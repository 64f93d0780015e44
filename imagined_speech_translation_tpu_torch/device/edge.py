"""Edge-side wake gating: the device transmits only while awake.

The reference design (SURVEY.md L-1/L-2; paper ¶170-171) runs the wake
CNN on the edge so the radio and the expensive server decode only see
EEG the user intends to translate.  The framework's server keeps its own
gate (``runtime.streaming.ThresholdWakeGate``) for devices that stream
raw, but this module closes the loop for the reference topology: a
:class:`NativeBoard` (the 6x-ADS1299 firmware twin) + any wake scorer
(the native C++ detector ``wake.NativeWakeModel``, its torch twin, or a
plain RMS threshold) -> wire frames emitted only during awake segments,
with ``eeg_end`` marking each utterance boundary on return to sleep.

A scorer is any ``(channels, window) microvolts -> bool`` callable;
adapters for the shipped detectors are below.

A copy of ``imagined_speech_translation_tpu.device.edge`` (it imports no
jax), so the port imports nothing of the JAX package; a test holds its code
to the original's.
"""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np

from .native import N_CHANNELS, NativeBoard

WakeScorer = Callable[[np.ndarray], bool]


def rms_scorer(threshold_uv: float) -> WakeScorer:
    """Amplitude gate (the server-side ThresholdWakeGate's contract)."""

    def score(window: np.ndarray) -> bool:
        return float(np.sqrt(np.mean(np.square(window)))) >= threshold_uv

    return score


def wake_model_scorer(
    model, features: Callable[[np.ndarray], np.ndarray], wake_class: int = 1
) -> WakeScorer:
    """Adapter for ``wake.NativeWakeModel`` / the twin: ``features``
    maps a raw ``(48, window)`` chunk to the detector's input rows."""

    def score(window: np.ndarray) -> bool:
        pred, _ = model.forward(features(window))
        return int(pred) == wake_class

    return score


class EdgeDevice:
    """Wake-gated uplink state machine over the firmware twin.

    Pull :meth:`poll` in the device loop: it pumps the board, scores the
    trailing window every ``hop`` samples, and yields wire frames —
    ``eeg|key|chunk`` while awake, one ``eeg_end|key|`` when the wake
    state falls, nothing while asleep.  On the wake rising edge the
    look-back window itself is transmitted (the utterance onset is inside
    it — the detector can only fire after seeing it).
    """

    def __init__(
        self,
        board: NativeBoard,
        scorer: WakeScorer,
        *,
        auth_key: str,
        window: int = 256,
        hop: int = 64,
    ):
        if hop > window:
            raise ValueError("hop must divide the window into overlap")
        self.board = board
        self.scorer = scorer
        self.auth_key = auth_key
        self.window = window
        self.hop = hop
        self.awake = False
        self._buf = np.zeros((N_CHANNELS, 0), np.float32)

    # ------------------------------------------------------------------
    def poll(self, n_samples: int) -> list[bytes]:
        """Pump ``n_samples`` conversions and return the wire frames the
        device would transmit for them."""
        produced = self.board.pump(n_samples)
        if produced == 0:
            return []
        chunk = self.board.drain(produced)
        self._buf = np.concatenate([self._buf, chunk], axis=1)
        frames: list[bytes] = []
        # score at hop granularity over the trailing window
        while self._buf.shape[1] >= self.window:
            look = self._buf[:, : self.window]
            rising = self.scorer(look)
            if rising and not self.awake:
                self.awake = True
                # transmit the look-back window: the onset lives in it
                frames.append(self._wire(look))
                self._buf = self._buf[:, self.window:]
                continue
            emit, self._buf = (
                self._buf[:, : self.hop],
                self._buf[:, self.hop:],
            )
            if self.awake and rising:
                frames.append(self._wire(emit))
            elif self.awake and not rising:
                self.awake = False
                frames.append(
                    ("eeg_end|" + self.auth_key + "|").encode()
                )
        return frames

    def _wire(self, samples: np.ndarray) -> bytes:
        head = ("eeg|" + self.auth_key + "|").encode()
        return head + np.ascontiguousarray(samples, np.float32).tobytes()

    def stream(self, chunks: int, chunk_samples: int) -> Iterator[bytes]:
        """Convenience generator over :meth:`poll`."""
        for _ in range(chunks):
            yield from self.poll(chunk_samples)
