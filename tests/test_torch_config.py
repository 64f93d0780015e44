"""The port's copies of the JAX package's jax-free modules (``config`` and
``runtime.batcher.BatchScheduler``) behave as the originals, and the port
imports nothing of the JAX package."""

import asyncio
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from imagined_speech_translation_tpu import config as jax_config
from imagined_speech_translation_tpu.runtime.batcher import BatchScheduler as JaxScheduler
from imagined_speech_translation_tpu_torch import config
from imagined_speech_translation_tpu_torch.runtime import BatchScheduler

REPO = Path(__file__).resolve().parent.parent


def test_default_config_copy_matches():
    assert dataclasses.asdict(config.default_config()) == dataclasses.asdict(
        jax_config.default_config()
    )
    names = {n for n in dir(jax_config) if n.endswith("Config") or n == "Config"}
    assert names == {n for n in dir(config) if n.endswith("Config") or n == "Config"}
    ours = config.default_config()
    assert config.Config.from_json(ours.to_json()) == ours


@pytest.mark.parametrize("path, value", [
    ("training.seed", 7),
    ("training.optimizer.warmup_steps", 0),
    ("training.optimizer.mu_dtype", None),
    ("model.brain_encoder.region_encoder.attn_heads", (8, 4, 4)),
    ("generation.min_length", 16),
    ("model_name", "other"),
])
def test_replace_nested_copy_matches(path, value):
    ours = config.replace_nested(config.default_config(), path, value)
    theirs = jax_config.replace_nested(jax_config.default_config(), path, value)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_replace_nested_copy_raises_alike():
    for mod in (config, jax_config):
        with pytest.raises((AttributeError, TypeError)):
            mod.replace_nested(mod.default_config(), "training.no_such_field", 1)


def _run_scheduler(cls, arrivals):
    """Submit windows at the given (delay_ms, id) arrivals to a scheduler
    over a fake decode function; returns the answers and the batches."""
    batches = []

    def decode(batch):
        ids = [int(w[0, 0]) for w in batch]
        batches.append(ids)
        return [f"w{i}" for i in ids]

    async def run():
        async with cls(decode, max_batch=4, max_delay_ms=40) as sched:
            async def one(delay, i):
                await asyncio.sleep(delay / 1e3)
                return await sched.submit(np.full((2, 3), i, np.float32))

            texts = await asyncio.gather(*(one(d, i) for d, i in arrivals))
            return texts, sched.stats()

    texts, stats = asyncio.run(run())
    return texts, batches, stats


def test_batch_scheduler_copy_matches():
    # a burst of 6 (one full batch, one deadline batch) then two late windows
    arrivals = [(0, i) for i in range(6)] + [(200, 6), (205, 7)]
    ours = _run_scheduler(BatchScheduler, arrivals)
    theirs = _run_scheduler(JaxScheduler, arrivals)
    assert ours[0] == theirs[0] == [f"w{i}" for i in range(8)]
    assert ours[1] == theirs[1]
    assert ours[2]["batches"] == theirs[2]["batches"] == len(ours[1])
    assert ours[2]["mean_fill"] == theirs[2]["mean_fill"]


def test_port_imports_nothing_of_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import imagined_speech_translation_tpu_torch as port\n"
        "names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "importlib.import_module('chip_smoke')\n"
        "experiments = {port.__name__ + '.cli.' + m for m in\n"
        "               ('train_proof', 'ablation_sweep', 'accum_curve_check',\n"
        "                'train_profile', 'train_bench', 'encoder_profile', 'beam_profile',\n"
        "                'decode_profile', 'streaming_soak', 'kernel_check',\n"
        "                'multiproc_proof')}\n"
        "experiments |= {port.__name__ + '.examples.' + m for m in\n"
        "                ('streaming_demo', 'product_journey_demo', 'device_page_demo')}\n"
        "assert experiments <= set(names), experiments - set(names)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'optax', 'imagined_speech_translation_tpu', 'tools',\n"
        "        'examples')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
