"""The port's kernel gate (``cli/kernel_check.py``) on the CPU, against the
JAX tool (``tools/tpu_kernel_check.py``).

* ``--quick --device cpu`` passes every gate (the kernels' plain twins) and
  writes its JSON;
* its gate's check names are the JAX tool's, parsed from the tool's
  ``gate.leq`` / ``gate.true`` calls (an f-string name expanded over the
  loop that makes it), and every constant bound is the tool's;
* the probe's plain twin at the tool's tile ((256, 512), seed 77, tile ids
  (3, 1, 2)) equals JAX's ``_tile_keep_mask`` in a ``pallas_call`` run in
  interpret mode, at rates 0.1 and 0.5, and a rate of 1e-10 rounds to a
  zero threshold in both packages.
"""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

from imagined_speech_translation_tpu.ops import pallas_attention as pa
from imagined_speech_translation_tpu_torch.cli import kernel_check
from imagined_speech_translation_tpu_torch.ops.dropout_mask import (
    dropout_threshold,
    tile_keep_mask,
)
from tests.test_torch_models import few_threads  # noqa: F401

TOOL = Path(__file__).resolve().parent.parent / "tools" / "tpu_kernel_check.py"


@pytest.fixture(scope="module")
def quick_report(tmp_path_factory):
    out = tmp_path_factory.mktemp("kernel_check") / "kc.json"
    assert kernel_check.main(["--quick", "--device", "cpu", "--json", str(out)]) == 0
    return json.loads(out.read_text())


def _loop_values(node: ast.For):
    """The values a ``for`` target's first name takes, for the tool's two
    loop forms: ``zip("qkv", ...)`` and a tuple of constants."""
    it = node.iter
    if isinstance(it, ast.Call) and getattr(it.func, "id", "") == "zip":
        return list(ast.literal_eval(it.args[0]))
    return list(ast.literal_eval(it))


def jax_gate_calls():
    """``{check name: constant bound or None}`` of the JAX tool's gate."""
    tree = ast.parse(TOOL.read_text())
    parents = {child: node for node in ast.walk(tree) for child in ast.iter_child_nodes(node)}
    out = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and getattr(node.func.value, "id", "") == "gate"
                and node.func.attr in ("leq", "true")):
            continue
        name, bound = node.args[0], None
        if node.func.attr == "leq":
            try:
                bound = ast.literal_eval(node.args[2])
            except ValueError:
                bound = None  # an expression (the mean's 1/sqrt(n) bound)
        if isinstance(name, ast.Constant):
            out[name.value] = bound
            continue
        loop = parents[node]
        while not isinstance(loop, ast.For):
            loop = parents[loop]
        var = loop.target.elts[0].id if isinstance(loop.target, ast.Tuple) else loop.target.id
        for value in _loop_values(loop):
            text = "".join(
                str(value) if isinstance(part, ast.FormattedValue) and part.value.id == var
                else part.value for part in name.values)
            out[text] = bound
    return out


def test_quick_cpu_passes_every_gate(quick_report):
    assert quick_report["ok"]
    assert all(c["ok"] for c in quick_report["checks"].values())
    assert all(c["ok"] for c in quick_report["port_checks"].values())
    assert "timing" not in quick_report  # --quick, as the JAX tool
    ports = quick_report["port_checks"]
    assert ports["probe_bits_equal_plain_rate0.1"]["value"] is True
    assert ports["rate_to_zero_takes_fused_route"]["value"] is True


def test_gate_names_are_the_jax_tools(quick_report):
    jax_checks = jax_gate_calls()
    assert len(jax_checks) == 18
    assert set(quick_report["checks"]) == set(jax_checks)


def test_gate_bounds_are_the_jax_tools(quick_report):
    for name, bound in jax_gate_calls().items():
        got = quick_report["checks"][name]["bound"]
        if bound is not None:
            assert got == bound, name
    # the mean over seeds: the tool's 3 x 0.15 / sqrt(n) at --quick's 4
    assert quick_report["checks"]["dropout_mean_convergence"]["bound"] == pytest.approx(
        3 * 0.15 / np.sqrt(4))


def _jax_probe_tile(rate):
    """The tool's ``_mask_kernel`` over ``_tile_keep_mask``, in interpret
    mode (the hash the port's kernels draw)."""
    def mask_kernel(seed_ref, out_ref):
        keep = pa._tile_keep_mask(seed_ref, jnp.int32(3), jnp.int32(1), jnp.int32(2),
                                  out_ref.shape, rate, True)
        out_ref[:] = keep.astype(jnp.float32)

    seed_row = jnp.broadcast_to(jnp.int32(kernel_check.PROBE_SEED), (1, 128))
    return np.asarray(pl.pallas_call(
        mask_kernel,
        out_shape=jax.ShapeDtypeStruct((256, 512), jnp.float32), interpret=True,
    )(seed_row))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_probe_tile_is_jax_tile_keep_mask(rate):
    want = _jax_probe_tile(rate)
    got = tile_keep_mask(kernel_check.PROBE_SEED, **kernel_check.PROBE_TILE, rate=rate,
                         device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert abs(got.mean() - (1 - rate)) <= 5e-3


def test_rate_to_zero_threshold_in_both_packages():
    assert dropout_threshold(1e-10) == 0 == int(pa._dropout_threshold(1e-10))
    assert dropout_threshold(0.1) == int(pa._dropout_threshold(0.1))
