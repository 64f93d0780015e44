"""Data-parallel serving (ROADMAP 1.7a) on the CPU: the port's decode
function over a serving mesh of two CPU replicas against one replica, as
``tests/test_parallel.py::test_sharded_serving_decode_matches_single_device``
holds the JAX package's sharded decode to its unsharded one.

* ``build_decode_fn(mesh=make_mesh(2, 1, devices=["cpu", "cpu"]))``: the
  same ids and texts as ``build_decode_fn(device="cpu")`` on 8 windows; a
  batch of 3 raises "not divisible"; behind a ``BatchScheduler(max_batch=8)``
  5 live windows (padded to 8) decode to the single replica's texts;
* ``build_decode_fn_from_args(data_parallel=2, device="cpu")`` and
  ``devices=[...]`` build the same replicas; ``cli.serve.main
  --data-parallel 2`` serves through them;
* each replica holds a folded copy of the caller's model;
* ``device_prefetch(sharding=)`` over a serving mesh yields each batch as
  its shards, in order.

Sizes: ``tests.helpers.tiny_config`` at T = 124 (the region encoders'
128 tokens take the flash route), the synthetic 125-channel montage,
random weights from a seed.  Ids and texts must be identical.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

from imagined_speech_translation_tpu_torch import config
from imagined_speech_translation_tpu_torch.cli import serve
from imagined_speech_translation_tpu_torch.data import (
    ChineseCharTokenizer,
    RegionSpec,
    make_synthetic_montage,
)
from imagined_speech_translation_tpu_torch.data.feed import device_prefetch
from imagined_speech_translation_tpu_torch.models import build_model
from imagined_speech_translation_tpu_torch.parallel import make_mesh
from imagined_speech_translation_tpu_torch.runtime import BatchScheduler
from imagined_speech_translation_tpu_torch.runtime.server import WssService
from tests.helpers import TINY_VOCAB, tiny_config

T = 124
VOCAB = list(dict.fromkeys(TINY_VOCAB))


class RecordingTokenizer(ChineseCharTokenizer):
    """Keeps every id batch it decodes, in order."""

    def batch_decode(self, batch_ids, **kw):
        self.history = getattr(self, "history", []) + [np.asarray(batch_ids)]
        return super().batch_decode(batch_ids, **kw)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this module's tiny shapes: under six
    pytest-xdist workers the default (one a core) oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_dp")
    cfg = config.Config.from_json(tiny_config(len(VOCAB), n_timepoints=T).to_json())
    (root / "cfg.json").write_text(cfg.to_json())
    (root / "vocab.txt").write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    labels = make_synthetic_montage(root / "montage.csv")
    spec = RegionSpec.from_channel_names(labels)
    model = build_model(cfg.model, T, seed=2, device="cpu")
    windows = np.random.default_rng(7).normal(size=(8, len(labels), T)).astype(np.float32)
    return dict(root=root, cfg=cfg, spec=spec, model=model, windows=windows, n_ch=len(labels))


def _decode_fn(s, **kw):
    tok = RecordingTokenizer(VOCAB, eos_token="[EOS]")
    return serve.build_decode_fn(s["cfg"], tok, s["spec"], s["model"], **kw), tok


@pytest.fixture(scope="module")
def reference(setup):
    """The single replica's texts and ids on the 8 windows."""
    fn, tok = _decode_fn(setup, device="cpu")
    return fn(setup["windows"]), tok.history[-1]


@pytest.fixture(scope="module")
def two_replicas(setup):
    return _decode_fn(setup, mesh=make_mesh(2, 1, devices=["cpu", "cpu"]))


def test_two_replicas_decode_the_single_replica_ids(setup, reference, two_replicas):
    fn, tok = two_replicas
    assert fn(setup["windows"]) == reference[0]
    np.testing.assert_array_equal(tok.history[-1], reference[1])


def test_a_batch_that_does_not_split_is_refused(setup, two_replicas):
    fn, _ = two_replicas
    with pytest.raises(ValueError, match="batch of 3 rows not divisible by the mesh's 2 batch shards"):
        fn(setup["windows"][:3])


def test_two_replicas_behind_the_batch_scheduler(setup, reference, two_replicas):
    """Pooled windows pad to the static batch of 8 and split over both
    replicas; each live window gets the single replica's text."""
    fn, _ = two_replicas

    async def flow():
        async with BatchScheduler(fn, max_batch=8, max_delay_ms=20) as s:
            return await asyncio.gather(*(s.submit(w) for w in setup["windows"][:5]))

    assert asyncio.run(flow()) == reference[0][:5]


def test_replicas_hold_their_own_weights(setup, reference):
    """Each replica holds a folded copy: zeroing the caller's model after
    the build leaves the decode unchanged."""
    fn, _ = _decode_fn(setup, mesh=make_mesh(2, 1, devices=["cpu", "cpu"]))
    saved = {k: v.clone() for k, v in setup["model"].state_dict().items()}
    try:
        with torch.no_grad():
            for p in setup["model"].parameters():
                p.zero_()
        assert fn(setup["windows"]) == reference[0]
    finally:
        setup["model"].load_state_dict(saved)


def test_build_decode_fn_takes_a_device_or_a_serving_mesh(setup):
    with pytest.raises(ValueError, match="one of them"):
        _decode_fn(setup)
    with pytest.raises(ValueError, match="one of them"):
        _decode_fn(setup, device="cpu", mesh=make_mesh(2, 1, devices=["cpu", "cpu"]))
    with pytest.raises(ValueError, match="devices of its replicas"):
        _decode_fn(setup, mesh=make_mesh(1, 1))


def _args(root, **kw):
    return dict(vocab=str(root / "vocab.txt"), montage=str(root / "montage.csv"),
                config=str(root / "cfg.json"), device="cpu", random_init=True, **kw)


@pytest.mark.parametrize("kw", [dict(data_parallel=2, max_batch=3),
                                dict(devices=["cpu", "cpu"])], ids=["data_parallel", "devices"])
def test_build_decode_fn_from_args_serves_replicas(setup, kw):
    """Two CPU replicas from plain arguments (the warm-up batch rounds up to
    a multiple of 2) decode as one replica of the same random weights."""
    root = setup["root"]
    one = serve.build_decode_fn_from_args(**_args(root))
    two = serve.build_decode_fn_from_args(**_args(root, **kw))
    windows = setup["windows"][:4]
    assert two(windows) == one(windows)
    with pytest.raises(ValueError, match="not divisible"):
        two(windows[:1])


def test_build_decode_fn_from_args_refuses_a_mismatched_device_list(setup):
    with pytest.raises(ValueError, match="data_parallel=3 with 2 devices"):
        serve.build_decode_fn_from_args(**_args(setup["root"], data_parallel=3,
                                                devices=["cpu", "cpu"]))


def test_main_serves_two_cpu_replicas(setup, monkeypatch):
    """``main --device cpu --data-parallel 2 --max-batch 4``:
    ``WssService.serve`` is replaced by a client that authenticates, streams
    two windows and asks for ``latency``."""
    n_ch, seen = setup["n_ch"], {}

    async def fake_serve(self, host, port):
        key = json.loads((await self.handle_text("authentication¬tok")).split("¬")[2])
        eeg = np.random.default_rng(8).normal(size=(n_ch, 2 * T)).astype(np.float32)
        seen["texts"] = await self.handle_binary(b"eeg|" + key.encode() + b"|" + eeg.tobytes())
        seen["latency"] = json.loads((await self.handle_text(f"latency¬{key}")).split("¬")[2])

    monkeypatch.setattr(WssService, "serve", fake_serve)
    root = setup["root"]
    serve.main(["--vocab", str(root / "vocab.txt"), "--montage", str(root / "montage.csv"),
                "--config", str(root / "cfg.json"), "--random-init", "--device", "cpu",
                "--data-parallel", "2", "--max-batch", "4", "--max-delay-ms", "5"])
    assert len(seen["texts"]) == 2 and all(isinstance(t, str) for t in seen["texts"])
    assert seen["latency"]["pooled"]["count"] == 2


def test_device_prefetch_yields_a_serving_mesh_shards(setup):
    mesh = make_mesh(2, 1, devices=["cpu", "cpu"])
    batches = [{"eeg": setup["windows"][:4], "channel_mask": setup["spec"].channel_mask},
               {"eeg": setup["windows"][4:], "channel_mask": setup["spec"].channel_mask}]
    got = list(device_prefetch(iter(batches), sharding=mesh))
    assert len(got) == 2
    for batch, shards in zip(batches, got):
        assert len(shards) == 2
        for i, shard in enumerate(shards):
            np.testing.assert_array_equal(shard["eeg"].numpy(), batch["eeg"][2 * i:2 * i + 2])
            np.testing.assert_array_equal(shard["channel_mask"].numpy(), batch["channel_mask"])
            assert shard["eeg"].device == torch.device("cpu")
