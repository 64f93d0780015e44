"""Faults planted in the program under test, to see that ``correct`` comes
out false: each is a context manager that breaks the timed path underneath
the harness, in the port's modules, and mends it on exit."""

from __future__ import annotations

import contextlib

import torch

import imagined_speech_translation_tpu_torch.decode.generate as generate
import imagined_speech_translation_tpu_torch.models.eeg_model as eeg_model
import imagined_speech_translation_tpu_torch.training.optimizer as optimizer
import imagined_speech_translation_tpu_torch.training.train_step as train_step


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def token():
    """A token altered where it is produced: the beam search's best
    hypothesis gets a neighbouring id at its middle position."""
    search = generate.beam_search

    def altered(*args, **kw):
        ids = search(*args, **kw).clone()
        mid = ids.shape[1] // 2
        ids[:, mid] = torch.where(ids[:, mid] > 200, ids[:, mid] - 1, ids[:, mid] + 1)
        return ids

    return _patched(generate, "beam_search", altered)


def roll():
    """Answers sent back to the wrong window: the beam search's rows rolled
    by one within each batch, so window ``i`` gets window ``i - 1``'s
    text."""
    search = generate.beam_search

    def rolled(*args, **kw):
        return search(*args, **kw).roll(1, dims=0)

    return _patched(generate, "beam_search", rolled)


def encoder():
    """The encoder's projection zeroed: every window reaches the decoder as
    the same states (the projection's LayerNorm of zeros), whatever its
    signal."""
    encode = eeg_model.EEGDecodingModel.encode

    def zeroed(self, eeg, channel_mask=None, generator=None):
        feat, _ = encode(self, eeg, channel_mask, generator)
        proj = self.eeg_to_bart_ln(torch.zeros_like(self.eeg_to_bart_fc(feat)))
        return feat, eeg_model.pseudo_encoder_sequence(proj, self.cfg.bart.encoder_layers)

    return _patched(eeg_model.EEGDecodingModel, "encode", zeroed)


def half():
    """Half of each micro-batch left out, the loss's mean taken over the
    rest."""
    make = train_step.make_loss_fn

    def make_half(*args, **kw):
        loss_fn = make(*args, **kw)

        def halved(params, micro, generator, weights):
            n = micro["eeg"].shape[0] // 2
            micro = {k: (v if k == "channel_mask" else v[:n]) for k, v in micro.items()}
            return loss_fn(params, micro, generator, weights)

        return halved

    return _patched(train_step, "make_loss_fn", make_half)


def unchanged():
    """A step that returns its state unchanged: the optimizer computes the
    gradient norm and updates nothing."""

    def update(self, params, grads, state, **kw):
        return optimizer.global_norm(grads.values())

    return _patched(optimizer.FusedAdamW, "update", update)


FAULTS = {"token": token, "roll": roll, "encoder": encoder, "half": half,
          "unchanged": unchanged}
