"""The rate-0 flash backward: the port against the JAX package's split dQ /
dK+dV kernels, the dispatch between split and fused, and the kernels'
registration.

On the CPU the port's ``flash_attention`` runs its plain twin and autograd
differentiates it; the JAX side runs ``flash_attention(..., interpret=True)``
with its default blocks, which at rate 0 take the whole key range as one
block and send the backward to ``_bwd_call_split``.  Tolerance: 1e-5
absolute in float32 on outputs and gradients of order 0.1-1 (the same sums
in another order).
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from imagined_speech_translation_tpu.ops import pallas_attention as pa
from imagined_speech_translation_tpu_torch import _kernels
from imagined_speech_translation_tpu_torch.ops import flash_attention
from imagined_speech_translation_tpu_torch.ops.flash_attention import (
    backward_dkv,
    backward_dq,
    backward_fused,
    backward_route,
    backward_split,
)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("b, h, s_q, s_kv, d", [
    (1, 2, 200, 333, 40),
    (1, 1, 130, 257, 64),
])
def test_rate0_gradients_match_jax_split_kernels(monkeypatch, b, h, s_q, s_kv, d):
    split_calls = []
    real_split = pa._bwd_call_split

    def spy(*args, **kw):
        split_calls.append(kw["block_k"])
        return real_split(*args, **kw)

    monkeypatch.setattr(pa, "_bwd_call_split", spy)
    rng = np.random.default_rng(d)
    q = rng.normal(size=(b, h, s_q, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, h, s_kv, d)).astype(np.float32) for _ in range(2))
    v += 0.5  # a mean that makes the delta term count
    g = rng.normal(size=(b, h, s_q, d)).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: pa.flash_attention(*a, interpret=True), q, k, v)
    want = vjp(g)
    assert split_calls == [-(-s_kv // 128) * 128], "the JAX side did not run the split kernels"

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tout = flash_attention(tq, tk, tv)[0]
    got = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out), atol=1e-5)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-5, err_msg=name)


@pytest.mark.parametrize("rate, kernels", [
    (0.0, ("flash_bwd_dq", "flash_bwd_dkv")),
    (1e-6, ("flash_bwd",)),
    (0.1, ("flash_bwd",)),
    (0.5, ("flash_bwd",)),
])
def test_rate_picks_the_backward_kernels(rate, kernels):
    assert backward_route(rate) == kernels
    names = {k.name for k in _kernels.KERNELS}
    assert set(kernels) <= names


@pytest.mark.parametrize("entry", [backward_dq, backward_dkv, backward_split,
                                   lambda *a: backward_fused(*a, (0.0, 0, 0, 0))])
def test_backward_entry_points_refuse_cpu_tensors(entry):
    q = torch.zeros((1, 1, 128, 16))
    lse = torch.zeros((1, 128))
    with pytest.raises(ValueError, match="need one CUDA device"):
        entry(q, q, q, q, lse, lse, 0.25)


@pytest.mark.parametrize("name, source, func", [
    ("flash_bwd", "flash_bwd.cu", "_bwd_fused_kernel"),
    ("flash_bwd_dq", "flash_bwd_split.cu", "_bwd_dq_kernel"),
    ("flash_bwd_dkv", "flash_bwd_split.cu", "_bwd_dkv_kernel"),
])
def test_backward_kernels_name_their_source_and_tpu_kernel(name, source, func):
    kernel = next(k for k in _kernels.KERNELS if k.name == name)
    assert kernel.source.endswith("csrc/" + source) and source in _kernels.SOURCES
    path, line = kernel.replaces.split(":")
    assert (REPO / path).read_text().splitlines()[int(line) - 1].startswith(f"def {func}(")
    assert f"int {kernel.entry}(" in (REPO / kernel.source).read_text()


def _c_entry_points():
    """``name -> number of parameters`` of every ``extern "C"`` function in
    the kernel sources."""
    found = {}
    for src in _kernels.SOURCES:
        text = (_kernels.CSRC / src).read_text()
        body = text[text.index('extern "C" {'):]
        for m in re.finditer(r"^(?:int|const char\*) (ist_\w+)\(([^)]*)\)", body, re.M):
            params = [p for p in m.group(2).split(",") if p.strip()]
            found[m.group(1)] = len(params)
    return found


def test_ctypes_signatures_match_the_c_entry_points():
    found = _c_entry_points()
    for name, argtypes in _kernels._SIGNATURES.items():
        assert found.get(name) == len(argtypes), name
    assert {"ist_flash_bwd_dq", "ist_flash_bwd_dkv"} <= set(found)


def test_library_hash_covers_every_included_header():
    """An edit to any header a kernel source includes must rebuild the
    library, so every local include is one of ``_kernels.HEADERS``."""
    included = set()
    for name in _kernels.SOURCES + _kernels.HEADERS:
        included |= set(re.findall(r'^#include "([^"]+)"', (_kernels.CSRC / name).read_text(),
                                   re.M))
    assert included <= set(_kernels.HEADERS)
    assert "sm90.cuh" in included


def test_ptxas_info_groups_the_lines_of_each_entry(monkeypatch):
    log = "\n".join([
        "--- flash_bwd.cu",
        "ptxas info    : Compiling entry function '_Z4other' for 'sm_90a'",
        "ptxas info    : Function properties for _Z4other",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_Z22flash_bwd_wgmma_kernelILi2E' for 'sm_90a'",
        "ptxas info    : Function properties for _Z22flash_bwd_wgmma_kernelILi2E",
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 168 registers, used 3 barriers",
    ])
    monkeypatch.setattr(_kernels, "build_log", log)
    assert _kernels.ptxas_info("flash_bwd_wgmma_kernel") == {
        "_Z22flash_bwd_wgmma_kernelILi2E": [
            "0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
            "ptxas info    : Used 168 registers, used 3 barriers",
        ]}
    assert _kernels.ptxas_info("no_such_kernel") == {}
