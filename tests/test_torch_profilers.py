"""The port's segment profilers (``cli.train_profile``, ``cli.train_bench``,
``cli.encoder_profile``, ``cli.beam_profile``, ``cli.decode_profile``) held
to the JAX package and to the step they decompose:

* the encoder programs of ``cli.encoder_profile`` (the full encoder, two and
  one attention layers with ``attn_heads[:n]``, ``cnn_only``, and the region
  encoders alone) against JAX's ``BrainRegionEncoder`` at the same
  configuration, and the region encoders alone against the construction of
  ``tools/encoder_profile.py:158-171`` rebuilt here, on converted weights,
  BatchNorm folded in the port as the profiler folds it: ATOL 1e-4 in
  float32 (one XLA compile for all five);
* the training segments decompose the real step bit for bit in float32 on
  the CPU: the update applied to ``grads_only``'s gradients gives the
  parameters, BatchNorm statistics, optimizer state and metrics of one
  ``window``, ``fwd_only``'s loss components are the window's, and every
  program, as the profiler runs it, leaves the state it started from;
* each CLI, run with ``--device cpu`` at ``tests.helpers.tiny_config``,
  reports exactly the JAX tool's keys (listed below with the lines they
  come from) plus the port's device-time and launch keys.

Sizes: hidden 48, 2 decoder layers; the encoders at T = 124 and B = 2 (token
sequences of 128), the training segments at T = 64, micro-batch 2 x
accumulation 2.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from imagined_speech_translation_tpu.models import BrainRegionEncoder as JaxBrainEncoder
from imagined_speech_translation_tpu.models.layers import (
    RegionConvAttentionEncoder as JaxRegionEncoder,
)
from imagined_speech_translation_tpu_torch.cli import (
    beam_profile,
    decode_profile,
    encoder_profile,
    train_bench,
    train_profile,
)
from imagined_speech_translation_tpu_torch.config import replace_nested
from imagined_speech_translation_tpu_torch.convert import load_flax_variables
from tests.helpers import tiny_config, tiny_tokenizer
from tests.test_torch_models import few_threads, seeded_flax_variables  # noqa: F401

T, B = 124, 2
ATOL = 1e-4


class _RegionsOnly(nn.Module):
    """``tools/encoder_profile.py:158-171``: the four vmapped region encoders
    alone, behind the channel mask."""

    cfg: object

    @nn.compact
    def __call__(self, eeg, channel_mask=None):
        x = jnp.where(channel_mask[None, :, :, None], eeg, 0.0)
        x = jnp.swapaxes(x, -1, -2)
        V = nn.vmap(
            JaxRegionEncoder,
            in_axes=(1, None), out_axes=1,
            variable_axes={"params": 0, "batch_stats": 0},
            split_rngs={"params": True, "dropout": True},
            methods=["__call__"],
        )
        return V(self.cfg.region_encoder, self.cfg.hidden_dim, name="region_encoders")(x, False)


@pytest.fixture(scope="module")
def encoders():
    """Each program's JAX output and the port's, on the same weights."""
    cfg = tiny_config(tiny_tokenizer().vocab_size, n_timepoints=T)
    rng = np.random.default_rng(0)
    mask = np.zeros((4, 16), bool)
    for r, n in enumerate(cfg.model.region_channel_counts):
        mask[r, :n] = True
    eeg = rng.normal(size=(B, 4, 16, T)).astype(np.float32)
    configs = encoder_profile.program_configs(cfg.model.brain_encoder)
    jax_modules, variables, ours = {}, {}, {}
    for seed, name in enumerate(encoder_profile.PROGRAMS):
        cls = _RegionsOnly if name == "regions_only" else JaxBrainEncoder
        jax_modules[name] = cls(configs[name])
        variables[name] = seeded_flax_variables(jax_modules[name], eeg, mask, seed=10 + seed)
        module = encoder_profile.encoder_module(name, cfg.model.brain_encoder, cfg, T)
        model = encoder_profile.prepare(load_flax_variables(module, variables[name]),
                                        torch.float32)
        with torch.no_grad():
            ours[name] = model(torch.from_numpy(eeg), torch.from_numpy(mask)).numpy()

    @jax.jit
    def apply_all(variables, x, m):
        return {n: jax_modules[n].apply(v, x, m) for n, v in variables.items()}

    want = jax.tree.map(np.asarray, apply_all(variables, eeg, mask))
    return dict(cfg=cfg, want=want, ours=ours)


@pytest.mark.parametrize("name", encoder_profile.PROGRAMS)
def test_encoder_program_matches_jax(encoders, name):
    np.testing.assert_allclose(encoders["ours"][name], encoders["want"][name], atol=ATOL)


def test_encoder_programs_are_the_jax_tools_configs(encoders):
    """``tools/encoder_profile.py:140-155``: layers n with attn_heads[:n],
    cnn_only for the stem; and the flash launches the card check derives."""
    be = encoders["cfg"].model.brain_encoder
    configs = encoder_profile.program_configs(be)
    for n in (1, 2):
        re = configs[f"layers{n}"].region_encoder
        assert (re.num_attn_layers, re.attn_heads) == (n, be.region_encoder.attn_heads[:n])
    assert configs["stem"].region_encoder.cnn_only
    assert configs["full"] == configs["regions_only"] == be
    assert [encoder_profile.flash_launches(configs[n]) for n in encoder_profile.PROGRAMS] == \
        [5, 3, 1, 0, 5]


@pytest.fixture(scope="module")
def segments():
    """The training segments' programs at float32 on the CPU."""
    cfg = tiny_config(tiny_tokenizer().vocab_size, n_timepoints=64)
    cfg = replace_nested(train_profile.profile_config(2, 2, cfg), "training.mixed_precision",
                         False)
    return train_profile.build_programs(cfg, torch.device("cpu"))


def _state_tensors(progs) -> dict:
    s = progs.state
    out = {f"p.{n}": t.detach().clone() for n, t in s.module.named_parameters()}
    out.update({f"b.{n}": t.clone() for n, t in s.module.named_buffers()})
    out.update({f"mu.{n}": t.clone() for n, t in s.opt_state.mu.items()})
    out.update({f"nu.{n}": t.clone() for n, t in s.opt_state.nu.items()})
    return out


def _assert_bitwise(a: dict, b: dict):
    assert a.keys() == b.keys()
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    assert not differ, differ[:5]


def test_update_on_grads_only_gives_the_window(segments):
    metrics = segments.programs["window"]()
    window = _state_tensors(segments)
    segments.restore()
    grads, comps = segments.programs["grads_only"]()
    ours = segments.step.update(segments.state, grads, comps)
    split = _state_tensors(segments)
    assert segments.state.opt_state.count == segments.state.step == 1
    segments.restore()
    _assert_bitwise(split, window)
    assert ours.keys() == metrics.keys()
    for k in metrics:
        assert torch.equal(torch.as_tensor(ours[k]), torch.as_tensor(metrics[k])), k


def test_fwd_only_components_equal_the_window_metrics(segments):
    grads, comps = segments.run("fwd_only")
    metrics = segments.run("window")
    assert grads is None
    assert set(comps) == set(metrics) - {"loss", "grad_norm"}
    for k, v in comps.items():
        assert torch.equal(v, metrics[k]), (k, v, metrics[k])


@pytest.mark.parametrize("name", train_profile.SEGMENTS)
def test_segment_leaves_the_state_it_started_from(segments, name):
    before = _state_tensors(segments)
    segments.run(name)
    _assert_bitwise(_state_tensors(segments), before)
    assert segments.state.step == segments.state.opt_state.count == 0


# every key of the JAX tools' reports, with the line that makes it, and the
# port's keys beside them
PORT_SEGMENT_KEYS = {"device_ms", "launches", "kernel_launches"}
JAX_KEYS = {
    "train_profile": {
        "segments_ms": {
            "rtt": "tools/train_profile.py:135", "window": ":139", "grads_only": ":197",
            "fwd_only": ":198", "micro_grad": ":219", "ce_only": ":224", "cast": ":235",
            "optimizer": ":258",
        },
        "derived_ms": {
            "clip+adamw+apply (window - grads_only)": ":267",
            "backward (grads_only - fwd_only)": ":270",
            "accum overhead (grads_only - 2*micro_grad)": ":273",
            "aux loss heads (window - ce_only)": ":277",
        },
    },
    # tools/tpu_train_bench.py:143-144 prints these four per mode
    "train_bench": {"window_ms", "samples_per_sec", "compile_s", "loss"},
    "encoder_profile": {
        "batch": "tools/encoder_profile.py:127", "timepoints": ":127", "iters": ":127",
        "platform": ":128", "roundtrip_ms": ":129", "full_ms": ":140", "layers2_ms": ":141",
        "layers1_ms": ":146", "stem_ms": ":151", "regions_only_ms": ":177", "derived": ":180",
        "analytic_tflop_per_fwd": ":204", "effective_tflops": ":205",
    },
    "beam_profile": {
        "roundtrip_ms": "tools/beam_profile.py:92", "step16_ms": ":118", "lmhead16_ms": ":136",
        "topk16_ms": ":152", "gather16_ms": ":178", "beam_ms": ":196",
    },
    "decode_profile": {
        "config_heads": "tools/decode_profile.py:101", "batch": ":102",
        "roundtrip_ms": ":108", "frontend_ms": ":115", "encoder_ms": ":126", "beam_ms": ":149",
        "full_ms": ":161", "windows_per_sec": ":162",
    },
}
PORT_KEYS = {
    # windows/s of the window, from the JAX tool's printed samples/s (:284)
    "train_profile": PORT_SEGMENT_KEYS | {"windows_per_sec", "derived_device_ms",
                                          "peak_memory_gib", "card"},
    "train_bench": PORT_SEGMENT_KEYS | {"peak_memory_gib"},
    "encoder_profile": PORT_SEGMENT_KEYS | {"peak_share", "peak_memory_gib", "card"},
    "beam_profile": PORT_SEGMENT_KEYS | {"topk16_library_ms", "peak_memory_gib", "card"},
    "decode_profile": PORT_SEGMENT_KEYS | {"peak_memory_gib", "card"},
}
KERNEL_NAMES = {"sosfilt", "flash_fwd", "flash_bwd", "flash_bwd_dq", "flash_bwd_dkv",
                "dropout_mask"}


def _run_cli(name, tmp_path, monkeypatch, capsys):
    cfg = tiny_config(tiny_tokenizer().vocab_size, n_timepoints=64)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("BATCH", "2")
    monkeypatch.setenv("ITERS", "1")
    monkeypatch.setenv("BENCH_BATCH", "2")
    small = ["--micro", "2", "--accum", "2", "--iters", "1"]
    argv = {"train_profile": small, "train_bench": small}.get(name, []) + ["--device", "cpu"]
    module = {"train_profile": train_profile, "train_bench": train_bench,
              "encoder_profile": encoder_profile, "beam_profile": beam_profile,
              "decode_profile": decode_profile}[name]
    assert module.main(argv, cfg=cfg) == 0
    assert capsys.readouterr().out.splitlines()[0] == "cpu"
    return json.loads((tmp_path / module.DEFAULT_OUT).read_text())


@pytest.mark.parametrize("name", list(JAX_KEYS))
def test_cli_reports_the_jax_tools_keys(name, tmp_path, monkeypatch, capsys):
    report = _run_cli(name, tmp_path, monkeypatch, capsys)
    jax_keys = JAX_KEYS[name]
    if name == "train_bench":
        assert set(report) == {"fp32", "bf16", "card"}
        rows = [report["fp32"], report["bf16"]]
        for row in rows:
            assert set(row) == jax_keys | PORT_KEYS[name]
            assert set(row["kernel_launches"]) == KERNEL_NAMES
        return
    assert set(report) == set(jax_keys) | PORT_KEYS[name]
    if name == "train_profile":
        for part, keys in jax_keys.items():
            assert set(report[part]) == set(keys)
        programs = train_profile.SEGMENTS
    else:
        programs = {k.removesuffix("_ms") for k in report if k.endswith("_ms")
                    and k not in ("roundtrip_ms", "device_ms")}
    if name == "encoder_profile":
        assert set(report["derived"]) == {"attn_layer3_marginal_ms", "attn_layer2_marginal_ms",
                                          "mlp_tokens_layer1_ms", "fusion_ms"}
    for key in PORT_SEGMENT_KEYS:
        assert set(report[key]) == set(programs), key
    for counts in report["kernel_launches"].values():
        assert counts == dict.fromkeys(KERNEL_NAMES, 0)  # the CPU runs the plain twins
