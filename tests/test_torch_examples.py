"""The port's demos (``imagined_speech_translation_tpu_torch/examples``) on
the CPU, against the JAX package's ``examples/``.

* ``device_page_demo`` with ``--out``: its transcript equals
  ``examples/device_page_transcript.json`` with ``createdTime`` masked (the
  ``qr_svg`` pointer names the SVG the port wrote, under ``--out``), and its
  SVG equals ``examples/wifi_provision_qr.svg`` byte for byte; nothing is
  written into ``examples/``.
* ``streaming_demo`` (numpy noise and the board twin) and
  ``product_journey_demo``, in float32 with BatchNorm unfolded on weights
  converted from JAX's (``convert.py``), give the same utterance texts as
  the JAX path fed the same frames: the streaming demo's chunks through the
  JAX runtime's ``DecodePipeline``, and the JAX demo's own ``journey`` with
  its decode function on the same weights.  The JAX decode runs the IIR
  kernel in interpret mode, as the port's serving tests do.

Weights: ``tests.test_torch_models.seeded_flax_variables`` from a numpy seed.
"""

import asyncio
import copy
import importlib.util
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from imagined_speech_translation_tpu.config import Config as JaxConfig
from imagined_speech_translation_tpu.data import ChineseCharTokenizer as JaxTokenizer
from imagined_speech_translation_tpu.decode import DecodeParams as JaxDecodeParams
from imagined_speech_translation_tpu.decode import build_generate_fn as jax_build_generate_fn
from imagined_speech_translation_tpu.frontend import SignalFrontend as JaxFrontend
from imagined_speech_translation_tpu.frontend import common_average_reference as jax_car
from imagined_speech_translation_tpu.frontend.filters import sosfilt_pallas
from imagined_speech_translation_tpu.models import EEGDecodingModel as JaxModel
from imagined_speech_translation_tpu.runtime import DecodePipeline as JaxPipeline
from imagined_speech_translation_tpu.runtime import RingBuffer as JaxRingBuffer
from imagined_speech_translation_tpu.runtime import ThresholdWakeGate as JaxWakeGate
from imagined_speech_translation_tpu.runtime import Windower as JaxWindower
from imagined_speech_translation_tpu_torch.convert import load_flax_variables
from imagined_speech_translation_tpu_torch.examples import (
    device_page_demo,
    product_journey_demo,
    streaming_demo,
)
from imagined_speech_translation_tpu_torch.models import EEGDecodingModel
from tests.test_torch_models import few_threads  # noqa: F401
from tests.test_torch_models import seeded_flax_variables

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"


def _masked(transcript) -> str:
    return re.sub(r'"createdTime": "[^"]*"', '"createdTime": "*"', json.dumps(transcript))


def test_device_page_transcript_and_qr_equal_jax(tmp_path):
    before = sorted(p.name for p in EXAMPLES.iterdir())
    got = device_page_demo.run(tmp_path)
    want = json.loads((EXAMPLES / "device_page_transcript.json").read_text())
    svg = tmp_path / "wifi_provision_qr.svg"
    wifi = next(step for step in got if step[0] == "POST /api/wifi")[1]
    assert wifi["qr_svg"] == f"-> {svg}"
    wifi["qr_svg"] = "-> examples/wifi_provision_qr.svg"
    assert _masked(got) == _masked(want)
    assert svg.read_bytes() == (EXAMPLES / "wifi_provision_qr.svg").read_bytes()
    written = json.loads((tmp_path / "device_page_transcript.json").read_text())
    assert written[0] == want[0] and len(written) == len(want)
    assert sorted(p.name for p in EXAMPLES.iterdir()) == before


def _weights(cfg, spec, seed):
    """JAX variables for ``cfg`` from a numpy seed and the port's state_dict
    converted from them."""
    T = cfg.data.n_timepoints
    jcfg = JaxConfig.from_json(cfg.to_json())
    variables = seeded_flax_variables(
        JaxModel(jcfg.model), np.zeros((1, 4, 16, T), np.float32), np.zeros((1, 4), np.int32),
        spec.channel_mask, seed=seed)
    model = load_flax_variables(EEGDecodingModel(cfg.model, T).eval(), variables)
    return jcfg, variables, model.state_dict()


def jax_decode_fn(jcfg, spec, variables, tok):
    """The JAX serving computation on ``variables``, BatchNorm unfolded, in
    float32, with the IIR kernel in interpret mode."""
    T = jcfg.data.n_timepoints
    g = jcfg.generation
    generate = jax_build_generate_fn(JaxModel(jcfg.model), JaxDecodeParams(
        max_length=g.max_length, min_length=g.min_length, num_beams=g.num_beams,
        pad_token_id=tok.pad_token_id, eos_token_id=tok.sep_token_id,
        decoder_start_token_id=tok.bos_token_id), jit=False)
    fe = JaxFrontend(jcfg.frontend)
    gather, mask = jnp.asarray(spec.gather_indices.reshape(-1)), jnp.asarray(spec.channel_mask)
    R, C = spec.channel_mask.shape
    variables = jax.tree.map(jnp.asarray, variables)

    @jax.jit
    def run(raw):
        clean = jax_car(sosfilt_pallas([fe.sos_bandpass, fe.sos_notch], raw, interpret=True))
        stacked = clean[:, gather, :].reshape(raw.shape[0], R, C, T)
        stacked = jnp.where(mask[None, :, :, None], stacked, 0.0)
        return generate(variables, stacked, mask)

    def decode_fn(windows):
        tokens = np.asarray(run(jnp.asarray(windows, jnp.float32)))
        return [t.strip() for t in tok.batch_decode(tokens)]

    return decode_fn


@pytest.mark.parametrize("source", ["noise", "device"])
def test_streaming_demo_decodes_the_jax_texts(source):
    tok = streaming_demo.demo_tokenizer()
    cfg, spec = streaming_demo.demo_config(tok), streaming_demo.demo_spec(source)
    jcfg, variables, state_dict = _weights(cfg, spec, seed=3)
    got = streaming_demo.run(source=source, chunks=12, device="cpu", state_dict=state_dict,
                             fold_bn=False)
    assert len(got["chunks"]) == 12 and got["utterances"]
    if source == "device":  # the board's 48 electrodes, no filler rows
        assert got["n_channels"] == 48 and got["chunks"][3].std() < got["chunks"][2].std()

    T = streaming_demo.T
    jtok = JaxTokenizer(streaming_demo.VOCAB, eos_token="[EOS]")
    pipe = JaxPipeline(windower=JaxWindower(JaxRingBuffer(got["n_channels"], capacity=4 * T),
                                            window=T, hop=T),
                       decode_fn=jax_decode_fn(jcfg, spec, variables, jtok),
                       wake_gate=JaxWakeGate(0.05), max_batch=1)
    want = [t for chunk in got["chunks"] for t in pipe.feed(chunk)] + pipe.flush()
    assert got["utterances"] == want


def _jax_journey_module():
    spec = importlib.util.spec_from_file_location(
        "jax_product_journey_demo", EXAMPLES / "product_journey_demo.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_product_journey_decodes_the_jax_texts(tmp_path, monkeypatch):
    window = 128
    tok = product_journey_demo.demo_tokenizer()
    cfg, spec = product_journey_demo.demo_config(tok, window), product_journey_demo.demo_spec(125)
    jcfg, variables, state_dict = _weights(cfg, spec, seed=5)

    args = product_journey_demo.parse_args(["--device", "cpu", "--workdir",
                                            str(tmp_path / "port")])
    got = asyncio.run(product_journey_demo.journey(args, state_dict=state_dict, fold_bn=False))
    assert got["recordings"] == 1 and len(got["utterances"]) == 2

    jax_demo = _jax_journey_module()
    jtok = JaxTokenizer(product_journey_demo.VOCAB, eos_token="[EOS]")
    monkeypatch.setattr(jax_demo, "build_tiny_decode_fn",
                        lambda n_ch, w: jax_decode_fn(jcfg, spec, variables, jtok))
    jax_args = copy.copy(args)
    jax_args.workdir = str(tmp_path / "jax")
    want = asyncio.run(jax_demo.journey(jax_args))
    assert got["utterances"] == want["utterances"]
    assert got["recordings"] == want["recordings"]
