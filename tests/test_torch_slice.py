"""The port's serving slice end to end vs the JAX package, and its imports.

``build_decode_fn`` on raw ``(N, 125, T)`` windows against a JAX composition
of unchanged JAX-package functions: the sequential Pallas IIR (interpret)
-> common-average reference -> region gather -> ``build_generate_fn``.
T = 124, so the region encoders' token sequences (T + 4 = 128) take the flash
route.  Decoded token ids must be identical."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from imagined_speech_translation_tpu.data.synthetic import make_synthetic_montage
from imagined_speech_translation_tpu.decode import DecodeParams as JaxDecodeParams
from imagined_speech_translation_tpu.decode import build_generate_fn as jax_build_generate_fn
from imagined_speech_translation_tpu.frontend import SignalFrontend as JaxFrontend
from imagined_speech_translation_tpu.frontend import common_average_reference as jax_car
from imagined_speech_translation_tpu.frontend.filters import sosfilt_pallas
from imagined_speech_translation_tpu.models import EEGDecodingModel as JaxModel
from imagined_speech_translation_tpu.models.folding import fold_batch_norm as jax_fold
from imagined_speech_translation_tpu_torch.cli.serve import (
    build_decode_fn,
    build_decode_fn_from_args,
)
from imagined_speech_translation_tpu_torch.convert import load_flax_variables
from imagined_speech_translation_tpu_torch.data import ChineseCharTokenizer, RegionSpec
from imagined_speech_translation_tpu_torch.models import EEGDecodingModel
from tests.helpers import TINY_VOCAB, tiny_config
from tests.test_torch_models import seeded_flax_variables
from tests.test_torch_models import few_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
T = 124
VOCAB = list(dict.fromkeys(TINY_VOCAB))


class RecordingTokenizer(ChineseCharTokenizer):
    """Keeps the token ids the decode function hands to ``batch_decode``."""

    def batch_decode(self, batch_ids, **kw):
        self.ids = np.asarray(batch_ids)
        return super().batch_decode(batch_ids, **kw)


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    tok = RecordingTokenizer(VOCAB, eos_token="[EOS]")
    cfg = tiny_config(tok.vocab_size, n_timepoints=T)
    labels = make_synthetic_montage(tmp_path_factory.mktemp("montage") / "m.csv")
    spec = RegionSpec.from_channel_names(labels)
    raw = (np.random.default_rng(0).normal(size=(2, len(labels), T)) * 20.0).astype(np.float32)
    jm = JaxModel(cfg.model)
    variables = seeded_flax_variables(
        jm, np.zeros((1, 4, 16, T), np.float32), np.zeros((1, 4), np.int32), spec.channel_mask,
        seed=1,
    )
    g = cfg.generation
    dp = JaxDecodeParams(
        max_length=g.max_length, min_length=g.min_length, num_beams=g.num_beams,
        pad_token_id=tok.pad_token_id, eos_token_id=tok.sep_token_id,
        decoder_start_token_id=tok.bos_token_id,
    )
    generate = jax_build_generate_fn(jm, dp)
    fe = JaxFrontend(cfg.frontend)
    clean = jax_car(sosfilt_pallas([fe.sos_bandpass, fe.sos_notch], jnp.asarray(raw), interpret=True))
    R, C = spec.channel_mask.shape
    stacked = clean[:, spec.gather_indices.reshape(-1), :].reshape(raw.shape[0], R, C, T)
    stacked = jnp.where(spec.channel_mask[None, :, :, None], stacked, 0.0)
    return dict(tok=tok, cfg=cfg, spec=spec, raw=raw, variables=variables,
                generate=generate, stacked=stacked)


@pytest.mark.parametrize("fold_bn", [False, True])
def test_decode_fn_matches_jax_composition(slice_setup, fold_bn):
    s = slice_setup
    variables = jax_fold(s["variables"]) if fold_bn else s["variables"]
    want = np.asarray(s["generate"](variables, s["stacked"], jnp.asarray(s["spec"].channel_mask)))
    model = load_flax_variables(EEGDecodingModel(s["cfg"].model, T).eval(), s["variables"])
    decode_fn = build_decode_fn(s["cfg"], s["tok"], s["spec"], model, device="cpu", fold_bn=fold_bn)
    texts = decode_fn(s["raw"])
    np.testing.assert_array_equal(s["tok"].ids, want)
    assert texts == [t.strip() for t in s["tok"].batch_decode(want)]
    assert (want[:, 1:] != s["tok"].pad_token_id).any()


def test_decode_fn_from_args_random_init(tmp_path):
    cfg = tiny_config(len(VOCAB), n_timepoints=T)
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    labels = make_synthetic_montage(tmp_path / "m.csv")
    decode_fn = build_decode_fn_from_args(
        vocab=str(tmp_path / "vocab.txt"), montage=str(tmp_path / "m.csv"),
        config=str(tmp_path / "cfg.json"), random_init=True, max_batch=2, device="cpu",
    )
    texts = decode_fn(np.random.default_rng(0).normal(size=(2, len(labels), T)).astype(np.float32))
    assert len(texts) == 2 and all(isinstance(t, str) for t in texts)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import imagined_speech_translation_tpu_torch as port\n"
        "names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.')]\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "assert 'jax' not in sys.modules and 'flax' not in sys.modules\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 20


def test_chip_smoke_needs_a_card():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
