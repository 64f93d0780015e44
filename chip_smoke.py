#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing loudly (non-zero exit, no final line):

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the port's CUDA kernels from ``csrc/`` (one ``nvcc`` per
   source, in parallel);
3. kernels: each kernel against its plain PyTorch twin on the card, at the
   shapes the serving path gives it, with times; the IIR at B = 16 and B = 1
   (2000 and 125 series of 1651 samples) within 2e-4 x max |x| of its
   sequential twin, a bound that the chunked scheme with its carry dropped
   must exceed, and on ragged shapes (fewer samples than chunks, T not a
   multiple of its chunk, a series count not a multiple of the block's, a
   series longer than shared memory holds), its ptxas report without
   spills; the forward's ptxas report
   of its bf16 (Hopper) and f32 (3xTF32) kernels (no spills); the forward's
   out within max |err| / max |ref| 1e-4 f32 / 1e-2 bf16 of the twin in
   float32 on the same input values, at flat and peaky inputs, a bound that
   the twin with V's rows permuted and an all-zero output must exceed, and
   in f32 the twin with one-pass TF32 products too (or, where it does not,
   4x the kernel's error), with two f32 launches bit-identical; and at head
   dims 8-256 (12, 24 and 100 among them; every multiple of 16) on ragged
   lengths, each case naming the variant it runs;
4. train kernels: the bf16 (Hopper) and f32 (3xTF32) backward kernels'
   ptxas reports (no spills) and SASS (dQ by 4-float vector reductions
   only, none without dQ); at the training shapes, the dropout keep-mask
   probe bit for bit, the flash forward with dropout 0.1 (max |err| / max
   |ref| within 1e-4 f32 / 1e-2 bf16, a bound that the plain version without
   the mask or with another seed's mask must exceed), and the fused flash
   backward (rates 0 and 0.1) against autograd through the plain version,
   in float32 and bfloat16, with times beside
   ``F.scaled_dot_product_attention``'s; in float32 also the plain
   gradients with one-pass TF32 products (beyond the bound, or 4x the
   kernel's error) and two launches' dK and dV bit-identical; the f32
   forward with dropout at head dims 8-256 on ragged lengths, with logical
   tiles that are multiples of its warp tiles and tiles that are not; the
   f32 backward there at every multiple of 8 up to 256 and at 12 and 100,
   each case naming its variant and whether it hoists the mask; the bf16
   forward and backward at every head dim 16-256 that is a multiple of 16,
   and with logical dropout tiles that are not multiples of their own, on
   ragged lengths (the backward also at head dims 12, 24 and 100); two
   launches of the bf16 split dK/dV kernel bit-identical;
4b. split kernels: the f32 3xTF32 kernels' and the bf16 Hopper dQ
   kernel's ptxas reports (no spills); the rate-0 backward's dQ and dK/dV
   kernels at the eval-mode gradient's shapes and at head dims 8-192 (12,
   24 and 100 among them; in bf16 every multiple of 16 up to 256, on 200 x
   333 and 1655 x 1580 tokens), in float32
   and bfloat16, against autograd through the plain version in float32 on
   the same input values (max |err| / max |ref| within 1e-4 f32 / 2e-2
   bf16, a bound the gradients without the delta term must exceed, and in
   float32 also the plain gradients with one-pass TF32 products); two
   launches bit-identical; the fused kernel at rate 0 within the same
   bound; times;
5. slice: the full-width model (random weights from a seed, BatchNorm folded,
   bf16) decodes 16 raw windows through ``cli.serve.build_decode_fn``; the
   serving kernels' launch counters must rise;
6. card vs CPU: the same port and weights on one window in float32 on the
   card and on the CPU; the fused encoder features must agree;
7. serving: the decode function behind the runtime's ``BatchScheduler``;
8. train: 3 optimizer steps of ``training.make_train_step`` at full width
   (``default_config()``: 8 micro-steps of 4 windows, mixed precision, fused
   AdamW); finite losses, weights still at step 0 (learning rate 0) and
   moved at step 1, and 5 flash forward and 5 flash backward launches per
   micro-step; then the same in float32 (``training.mixed_precision``
   off, the reference's numerics, whose backward runs the f32 fused
   kernel);
9. train card vs CPU: a small float32 configuration's loss and gradients
   (eval-mode forward, dropout off, so the split backward) on the card and
   on the CPU;
10. profile train: ``cli/profile.py --what train`` at full width
   (``default_config()``, B = 8, T = 1651, float32, 3 traced iterations
   after one warm-up): finite gradients, 5 flash forward, 5 split dQ and 5
   split dK/dV launches per iteration and no fused backward; then the same
   with ``--tiny`` (head dims 12 and 24) for one iteration;
11. trainer: ``cli.train`` at full width on a synthetic corpus of 80
   windows (2 epochs of 2 optimizer steps, an evaluation with beam search
   and a checkpoint each), ``cli.train --resume`` for a third epoch and
   ``cli.evaluate`` of the last checkpoint: finite metrics, exact launch
   counts, a checkpoint restored bit for bit, and the evaluate CLI equal to
   the trainer's own test evaluation;
12. server: the serving entry point on the trainer's last checkpoint at
   full width (``default_config()``, T = 1651, beam 3 pinned to length 16,
   BatchNorm folded, bf16): ``cli.serve.build_decode_fn_from_args`` loads it
   strictly, ``cli.serve.build_service`` wires the websocket service as
   ``cli.serve main`` does (one ``BatchScheduler``, max batch 16 and a 25 ms
   deadline, shared by a ``BatchingDecodePipeline`` a session; the command
   table with ``latency``), and 16 authenticated sessions stream 2 windows
   each as ``eeg`` frames of 125 x 250 samples, concurrently, then
   ``eeg_end``: 32 utterances, each session's in order, exactly 1 IIR and 5
   flash forward launches per decode batch, each window's ids equal to the
   decode function's on a batch of the same 16 windows, the ``latency``
   command's stats; the float16 wire gives identical ids on windows exact in
   float16; a ``DecodeWorker`` child answers as in-process decoding does,
   before and after one forced recycle; a second round of 16 new sessions
   gives the same utterances.  Windows/s through the service and
   window-to-utterance p50 and p99 of both rounds, the child's start
   seconds and RSS;
13. graft: the pretrained-decoder path at full width on the trainer's
   corpus: a seeded HF-layout checkpoint at ``fnlp/bart-base-chinese``'s
   widths written as ``pytorch_model.bin`` and ``model.safetensors``, both
   converted by ``cli.convert_hf`` (equal bit for bit), grafted into a
   fresh state whose tokenizer is smaller (overlap copy, in place, other
   parameters untouched, moved by the optimizer's second step),
   ``build_bart_generate_fn`` on the grafted decoder (beam 3 and greedy,
   ids equal to a search without the cross-attention hoist), and
   ``cli.train --bart-params`` for one epoch (finite metrics, exact launch
   counts);
13b. reproduce: ``cli.reproduce`` on that checkpoint (with a ``config.json``
   of its widths) and the trainer's corpus: ``--dry-run`` exits 0, the
   blocked path (``probe_egress`` replaced in-process by a failing probe)
   exits 3 with the ``blocked`` / ``no-egress`` JSON line, and the local
   chain on ``--device cuda`` converts (equal to the graft's conversion) and
   holds ``build_bart_generate_fn`` on the card to HF ``generate`` on the CPU
   over six seeds, greedy and beam 3, identity 1.0 (``--train`` is left to
   the graft phase's ``cli.train --bart-params``);
14. feed: ``data.feed.device_prefetch`` over the trainer's corpus, batches
   bit-equal to the host's, copies on a side stream, batches/s beside a
   plain ``.to`` loop;
15. features: ``SignalFrontend.features`` on (16, 125, 1651) against the
   CPU plain path, one IIR launch a call, ms a call;
16. multi_device: data parallelism on the one card.  The flash forward
   with dropout 0.1 and the fused backward on one rank's half of a
   training micro-batch, launched with the global head mapping, equal to
   the full launch's rows (out, lse, dK, dV bit for bit, dQ within its
   atomic sums' order) in bf16 and f32, and unequal with the identity
   mapping; the probe's mapped tiles equal to its twin's.  Then
   ``cli.train`` at full width in float32 for 1 epoch of 2 optimizer steps
   with an evaluation and a checkpoint, in one process and as two ranks
   (``IST_COORDINATOR``, ``IST_NUM_PROCESSES=2``, ``IST_PROCESS_ID``,
   ``IST_BACKEND=gloo``, ``parallel.data_axis=2``): every step's losses
   within 2e-4 relative, the final weights by the learning-rate rule, the
   module and BatchNorm statistics equal on both ranks, the checkpoint
   written once and restored on both ranks, 5 + 5 flash launches a
   micro-step on each rank.  Then ``cli.serve.build_decode_fn_from_args``
   on that checkpoint with two replicas on the card
   (``devices=["cuda:0", "cuda:0"]``): the single replica's ids on 16
   windows and behind a ``BatchScheduler``, "not divisible" for 15, 2 IIR
   and 10 flash forward launches a batch.  Seconds a step, the all-reduce's
   share, peak memory a rank, windows/s: correctness, not scaling;
17. tp_cp: tensor parallelism and ring attention on the one card.
   ``cli.train`` at full width in float32 as two gloo ranks with
   ``parallel.model_axis=2`` against the multi_device phase's one-process
   run: every step's losses within 2e-4 relative, the final weights by the
   learning-rate rule, the checkpoint written once and whole (the
   one-process run's keys and shapes) and restored into each rank's
   slices, 5 + 5 flash launches a micro-step on each rank, the checkpoint
   served in float32 with the one-process checkpoint's ids.  Then, on two
   more ranks, ``ring_attention`` alone at (16, 6, 1656, 128) in float32
   against plain attention (out and gradients within 1e-4 of max |ref|),
   and the full-width ``BrainRegionEncoder`` with ``seq_shards=2`` against
   ``seq_shards=1`` with the attention's plain twin (out and every
   parameter's gradient within 1e-4 of the largest; the flash kernels'
   path reported beside it).  Seconds and peak memory a rank: correctness,
   not scaling.  ``multi_card_tp`` (not run by ``main``) does the same
   over four cards on NCCL, as 2 data x 2 model ranks.
18. wake: ``cli.wake_train --device cuda`` on a corpus of 48 events written
   in the lunar catalog's CSV layout (finite losses falling, the accuracy,
   the ``torch.save`` file reloaded, no kernel launched); the same weights'
   logits on the card and on the CPU within 1e-4 of max |ref| with equal
   predictions; then the twin's Adam step at the published lunar catalog's
   shape, (76, 81,770, 2) synthetic impulse sequences at batch 32 (fc1
   1,308,288 x 128): finite losses falling, s/step and peak memory.

The last line is ``{"ok": true, "device": {...}}``; the line before it is the
kernels' JSON summary, with each kernel's launches on the serving path, the
bf16 and f32 training paths, the profile-train path, the trainer path, the
server path, the graft path (``cli.train --bart-params``), the features
path, the data-parallel training path (both ranks' ``cli.train``), the
data-parallel serving path (one batch over two replicas), the
tensor-parallel training path (both ranks' ``cli.train``), the
context-parallel encoder (both ranks; the ring launches no kernel), the
reproduce path (the local chain's convert and parity) and the wake path
(``cli.wake_train``, which launches none) (and, for the
flash forward and the fused backward, the variants their checks ran and
the multi_device phase's mapping checks), and the one before that the
card's name and power limit.
``dropout_mask`` is a check-only probe: the mask it writes is the
``__device__`` function every flash launch with dropout evaluates, so its
own launch count is 0 on every path.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time

DEVICE = "cuda"
SERVING_KERNELS = ("sosfilt", "flash_fwd")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def strict_f32():
    """float32 products and convolutions without TF32 inside the block (the
    earlier setting restored after): for comparisons of the card with the
    CPU."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def kernel_ms(fn, fragment: str, iters: int = 20) -> float:
    """Mean device milliseconds per call of the kernels whose name contains
    ``fragment``, from the profiler: for a kernel shorter than the host work
    of the call that launches it."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages() if fragment in e.key)
    if us <= 0:
        raise AssertionError(f"the profiler saw no device time of {fragment}")
    return us / iters / 1e3


# Published peaks of one H100 SXM (dense): bf16 tensor cores, HBM bandwidth,
# and for float32 the rate of f32-accurate products on the tensor cores by
# 3xTF32 (three TF32 products of 495 TFLOP/s each; the split backward's f32
# kernels run so), which is above the CUDA cores' 67 TFLOP/s and so the least
# time the card could take.  A kernel's bound is the larger of its FLOPs over
# the peak for its type and its bytes (each input read once, each output
# written once) over the bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12


def least_time(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """(least milliseconds on the card, what bounds it)."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# the serving forward's bounds: max |err| / max |ref| against the plain twin
# in float32 on the same input values, and the absolute bound on out and lse
FWD_REL = {"float32": 1e-4, "bfloat16": 1e-2}
FWD_ABS = {"float32": 5e-4, "bfloat16": 3e-2}


def forward_check(q, k, v, rel_bound, **kw):
    """``flash_attention(q, k, v, **kw)`` against the plain twin in float32
    on the same input values: max |err| of out and lse, max |ref|, max |err|
    / max |ref|, and the same measure for two wrong outputs that the check
    must reject, the twin with V's rows permuted along the key axis and
    zeros."""
    import torch

    from imagined_speech_translation_tpu_torch.ops import (
        flash_attention,
        flash_attention_reference,
    )

    out, lse = flash_attention(q, k, v, **kw)
    qf, kf, vf = q.float(), k.float(), v.float()
    ref, ref_lse = flash_attention_reference(qf, kf, vf, **kw)
    top = ref.abs().max().item()
    err = (out.float() - ref).abs().max().item()
    perm = torch.randperm(v.shape[2], generator=torch.Generator().manual_seed(0))
    permuted = flash_attention_reference(qf, kf, vf[:, :, perm.to(v.device)], **kw)[0]
    return dict(max_abs_err=err, max_abs_ref=top, rel_err=err / top,
                lse_max_abs_err=(lse - ref_lse).abs().max().item(),
                rel_err_permuted_v=(permuted - ref).abs().max().item() / top,
                rel_err_zeros=(torch.zeros_like(ref) - ref).abs().max().item() / top)


def forward_variant(dtype: str, d: int) -> str:
    """The kernel ``ist_flash_fwd`` runs for 16-byte aligned tensors of
    ``dtype`` at head dim ``d`` (``csrc/flash_fwd.cu``'s dispatch)."""
    if dtype == "float32" and d % 8 == 0:
        return "flash_fwd_tf32_kernel"  # tensor cores, 3xTF32 mma.sync
    if dtype == "bfloat16" and d % 16 == 0:
        return "flash_fwd_wgmma_kernel"  # Hopper: TMA and wgmma
    return "flash_fwd_kernel"  # CUDA cores


def backward_variant(dtype: str, d: int) -> str:
    """The kernel ``ist_flash_bwd`` runs for 16-byte aligned tensors of
    ``dtype`` at head dim ``d`` (``csrc/flash_bwd.cu``'s dispatch)."""
    if dtype == "float32" and d % 8 == 0:
        return "flash_bwd_tf32_kernel"  # tensor cores, 3xTF32 mma.sync
    if dtype == "bfloat16" and d % 16 == 0:
        return "flash_bwd_wgmma_kernel"  # Hopper: TMA and wgmma
    return "flash_bwd_kernel"  # CUDA cores


def split_dq_variant(dtype: str, d: int) -> str:
    """The kernel ``ist_flash_bwd_dq`` runs for 16-byte aligned tensors of
    ``dtype`` at head dim ``d`` (``csrc/flash_bwd_split.cu``'s dispatch)."""
    if dtype == "float32" and d % 8 == 0:
        return "flash_bwd_dq_tf32_kernel"  # tensor cores, 3xTF32 mma.sync
    if dtype == "bfloat16" and d % 16 == 0:
        return "flash_bwd_dq_wgmma_kernel"  # Hopper: TMA and wgmma
    return "flash_bwd_dq_kernel"  # CUDA cores


def ptxas_no_spills(fragment: str, tag: str) -> None:
    """Log the ptxas report of each compiled kernel whose name contains
    ``fragment``; fail if there is none or one spills."""
    from imagined_speech_translation_tpu_torch import _kernels

    report = _kernels.ptxas_info(fragment)
    if not report:
        raise AssertionError(f"no ptxas report of {fragment} in the build log")
    for entry, lines in sorted(report.items()):
        log(f"[{tag}] ptxas {entry}: " + "; ".join(lines))
        spills = [int(n) for line in lines for n in re.findall(r"(\d+) bytes spill", line)]
        if not spills or any(spills):
            raise AssertionError(f"{entry} spills or has no spill line: {lines}")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi}")
    log(
        f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}"
    )
    return smi


def phase_build():
    from imagined_speech_translation_tpu_torch import _kernels

    t0 = time.perf_counter()
    _kernels.library()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_kernels.build_seconds:.2f} s)")
    for line in _kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"[build] {line.strip()}")


def phase_kernels():
    """Each kernel vs its plain twin at serving shapes; returns per-kernel checks."""
    import numpy as np
    import torch

    import torch.nn.functional as F

    from imagined_speech_translation_tpu_torch.frontend import (
        SignalFrontend,
        sosfilt,
        sosfilt_reference,
    )
    from imagined_speech_translation_tpu_torch.frontend.filters import (
        chunk_length,
        sosfilt_chunked_reference,
    )
    from imagined_speech_translation_tpu_torch.ops import (
        flash_attention,
        flash_attention_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    checks = {"sosfilt": [], "flash_fwd": []}

    # sosfilt: the serving batch (16 x 125 channels x 1651 samples, float32)
    # and a single window (B = 1: 125 series), against the sequential twin
    # within 2e-4 x max |x|; the chunked scheme with its carry dropped (every
    # chunk from a zero state) must lie beyond that bound.  Time: the kernel's
    # own, from the profiler's device time (a call of the wrapper also
    # computes the carry on the host), and a call's, by CUDA events.
    fe = SignalFrontend()
    banks = [fe.sos_bandpass, fe.sos_notch]
    ptxas_no_spills("sosfilt_chunked_kernel", "kernels")
    for n_series in (16 * 125, 125):
        x = torch.from_numpy(rng.normal(size=(n_series, 1651)).astype(np.float32)).to(dev)
        got = sosfilt(banks, x)
        ref = sosfilt_reference(banks, x)
        err = (got - ref).abs().max().item()
        bound = 2e-4 * x.abs().max().item()
        dropped = sosfilt_chunked_reference(banks, x, chunk_length(1651), carry=False)
        err_dropped = (dropped - ref).abs().max().item()
        ms = kernel_ms(lambda: sosfilt(banks, x), "sosfilt")
        call = cuda_ms(lambda: sosfilt(banks, x), iters=20)
        plain = cuda_ms(lambda: sosfilt_reference(banks, x), iters=2, warmup=1)
        least, by = least_time(50 * x.numel(), 2 * 4 * x.numel(), "float32")
        checks["sosfilt"].append(dict(shape=list(x.shape), dtype="float32", max_abs_err=err,
                                      bound=bound, max_abs_err_without_carry=err_dropped,
                                      ms=ms, call_ms=call, plain_ms=plain, library_ms=None,
                                      bound_ms=least, bound_by=by))
        log(f"[kernels] sosfilt {tuple(x.shape)} f32: max|err| {err:.3e} (bound {bound:.3e}), "
            f"the twin without the carry {err_dropped:.3e} (must exceed it); kernel {ms:.4f} ms "
            f"(a call {call:.4f} ms), plain {plain:.3f} ms, bound {least:.4f} ms ({by})")
        if not err <= bound < err_dropped:
            raise AssertionError(f"sosfilt disagrees with its plain twin, or the check cannot "
                                 f"tell a dropped carry: {err}, {err_dropped}, bound {bound}")
    # ragged: fewer samples than chunks (T = 1, 20), T not a multiple of its
    # chunk (333: 30 x 11 + 3; 1650: 31 x 53 + 7), a series count that is not
    # a multiple of the block's (1001), and a series longer than shared
    # memory holds (70000 samples, read in device memory)
    ragged = {}
    for shape in ((5, 1), (7, 20), (9, 333), (11, 1650), (1001, 1651), (3, 70000)):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        got = sosfilt(banks, x.to(dev)).cpu()
        err = (got - sosfilt_reference(banks, x)).abs().max().item()
        bound = 2e-4 * x.abs().max().item()
        ragged[shape] = err / bound
        if not err <= bound:
            raise AssertionError(f"sosfilt {shape}: {err} > {bound}")
    log("[kernels] sosfilt ragged, max|err| / bound by shape: "
        + ", ".join(f"{k}: {v:.2f}" for k, v in ragged.items()))

    # the forward's tensor-core kernels as ptxas built them, bf16 (Hopper)
    # and f32 (3xTF32): no spills
    for fragment in ("flash_fwd_wgmma_kernel", "flash_fwd_tf32_kernel"):
        ptxas_no_spills(fragment, "kernels")

    # flash forward: (b*h, 1655, d) for the self-attention (d=128, 6 heads)
    # and the shared cross-scale attention (d=256, 3 heads), batch 16 x 4
    # regions.  Out against the plain twin in float32 on the same input
    # values, max |err| / max |ref| within FWD_REL (and the absolute bound
    # on out and lse), at flat inputs (q, k ~ N(0, 0.3^2): a softmax so even
    # that max |ref| ~ 0.03 with v ~ N(0, 0.3^2)) and peaky ones (q, k ~
    # N(0, 1): max |ref| ~ 0.15); the twin with V's rows permuted along the
    # key axis and an all-zero output must lie farther.  In float32 the
    # kernel runs 3xTF32, so the twin with every product in one TF32 pass
    # must lie beyond the bound or, where it does not, beyond 4x the kernel's
    # own error (a kernel that dropped 3xTF32's small terms would land
    # there), and two launches must give the same bits.
    for heads, d in ((6, 128), (3, 256)):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).removeprefix("torch.")
            bound, rel_bound = FWD_ABS[name], FWD_REL[name]
            shape = (64, heads, 1655, d)
            for inputs, qk_scale in (("flat", 0.3), ("peaky", 1.0)):
                q, k = (torch.from_numpy(rng.normal(size=shape).astype(np.float32) * qk_scale)
                        .to(dev, dtype) for _ in range(2))
                v = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.3).to(dev, dtype)
                c = forward_check(q, k, v, rel_bound)
                extra = {}
                if dtype == torch.float32:
                    ref = flash_attention_reference(q, k, v)[0]
                    torch.backends.cuda.matmul.allow_tf32 = True
                    try:
                        one_pass = flash_attention_reference(q, k, v)[0]
                    finally:
                        torch.backends.cuda.matmul.allow_tf32 = False
                    tf32 = (one_pass - ref).abs().max().item() / c["max_abs_ref"]
                    same = torch.equal(flash_attention(q, k, v)[0], flash_attention(q, k, v)[0])
                    del ref, one_pass
                    extra = dict(rel_err_tf32_twin=tf32, deterministic=same,
                                 tf32_twin_beyond=("the bound" if tf32 > rel_bound else
                                                   "4x the kernel's error"))
                    log(f"[kernels] flash_fwd ({64 * heads}, 1655, {d}) f32 {inputs}: the 1xTF32 "
                        f"twin at {tf32:.2e} (must exceed {rel_bound:.0e} or 4x "
                        f"{c['rel_err']:.2e}); two launches "
                        f"{'bit-identical' if same else 'DIFFER'}")
                    if not (tf32 > rel_bound or tf32 > 4 * c["rel_err"]):
                        raise AssertionError(f"flash_fwd f32 check cannot tell 1xTF32 products: "
                                             f"{tf32} against {c['rel_err']}")
                    if not same:
                        raise AssertionError("flash_fwd f32: two launches gave different bits")
                ms = cuda_ms(lambda: flash_attention(q, k, v), iters=5)
                plain = cuda_ms(lambda: flash_attention_reference(q, k, v), iters=5)
                lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=5)
                least, by = least_time(4 * q.numel() * 1655, 4 * q.numel() * q.element_size(),
                                       name)
                checks["flash_fwd"].append(dict(
                    shape=[64 * heads, 1655, d], dtype=name, variant=forward_variant(name, d),
                    inputs=inputs, bound=bound, rel_bound=rel_bound, **c, **extra, ms=ms,
                    plain_ms=plain, library_ms=lib, bound_ms=least, bound_by=by,
                ))
                log(f"[kernels] flash_fwd ({64 * heads}, 1655, {d}) {name} "
                    f"[{forward_variant(name, d)}] {inputs}: max|err| "
                    f"{c['max_abs_err']:.3e} (max|ref| {c['max_abs_ref']:.3e}), lse max|err| "
                    f"{c['lse_max_abs_err']:.3e} (bound {bound:.0e}); max|err|/max|ref| "
                    f"{c['rel_err']:.2e} (bound {rel_bound:.0e}), the twin with V permuted "
                    f"{c['rel_err_permuted_v']:.2e} and zeros {c['rel_err_zeros']:.2e} (must "
                    f"exceed it); kernel {ms:.3f} ms, plain {plain:.3f} ms, sdpa {lib:.3f} ms "
                    f"({ms / lib:.2f}x), bound {least:.3f} ms ({by})")
                if not (c["max_abs_err"] <= bound and c["lse_max_abs_err"] <= bound
                        and c["rel_err"] <= rel_bound):
                    raise AssertionError(f"flash_fwd disagrees with its plain twin: {c}")
                if not min(c["rel_err_permuted_v"], c["rel_err_zeros"]) > rel_bound:
                    raise AssertionError(f"flash_fwd check cannot tell a wrong output from the "
                                         f"right one: {c}")
                del q, k, v
                torch.cuda.empty_cache()

    # other head dims and ragged lengths (200 queries x 333 keys), peaky
    # inputs, correctness only: both dtypes; 8-100 and the reference heads'
    # (8,4,4) 96/192 include head dims that are not multiples of 16 (the
    # CUDA-core variant in bf16, the 3xTF32 one in f32) and of 8 (12 and
    # 100 on the CUDA cores in both dtypes: cli/profile.py --tiny has 12 and
    # 24); and in both dtypes every multiple of 16 up to 256
    worst = {}
    cases = [(d, dt) for d in (8, 12, 24, 40, 48, 96, 100, 192)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(d, dt) for d in range(16, 257, 16) for dt in (torch.float32, torch.bfloat16)
              if (d, dt) not in cases]
    for d, dtype in cases:
        name = str(dtype).removeprefix("torch.")
        q = torch.from_numpy(rng.normal(size=(2, 3, 200, d)).astype(np.float32))
        kv = torch.from_numpy(rng.normal(size=(2, 2, 3, 333, d)).astype(np.float32))
        q, k, v = q.to(dev, dtype), kv[0].to(dev, dtype), kv[1].to(dev, dtype)
        c = forward_check(q, k, v, FWD_REL[name])
        worst[(d, name, forward_variant(name, d).removeprefix("flash_fwd_"))] = c["rel_err"]
        if not (c["rel_err"] <= FWD_REL[name] < min(c["rel_err_permuted_v"], c["rel_err_zeros"])
                and c["lse_max_abs_err"] <= FWD_ABS[name]):
            raise AssertionError(f"flash_fwd d={d} {dtype}: {c}")
    log("[kernels] flash_fwd (6, 200 x 333, d) max|err|/max|ref| by (d, dtype, variant): "
        + ", ".join(f"{k}: {v:.1e}" for k, v in worst.items()))
    return checks


def sass_reductions(fragment: str,
                    opcodes: str = r"\b(?:RED|ATOM)G?\.[\w.]+") -> dict[str, dict[str, int]]:
    """Global reduction and atomic instructions (SASS opcode -> count), or
    those that ``opcodes`` matches, of each function of the loaded kernel
    library whose name contains ``fragment``, as ``cuobjdump -sass`` lists
    them."""
    from torch.utils.cpp_extension import CUDA_HOME

    from imagined_speech_translation_tpu_torch import _kernels

    sass = subprocess.run([f"{CUDA_HOME}/bin/cuobjdump", "-sass", _kernels.library()._name],
                          capture_output=True, text=True, check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if fragment in m.group(1) else None
            if fn:
                out[fn] = {}
        elif fn and (m := re.search(opcodes, line)):
            out[fn][m.group(0)] = out[fn].get(m.group(0), 0) + 1
    return out


def phase_train_kernels():
    """The training path's kernels against their plain twins at its shapes
    (micro-batch 4 x 4 regions: (96, 1655, 128) self-attention and
    (48, 1655, 256) cross-scale attention): the keep-mask probe bit for bit,
    the forward with dropout 0.1, and the fused backward at rates 0 and 0.1
    against autograd through the plain version (in f32 also apart from the
    one-pass TF32 twin, dK and dV bit-identical over two launches); then the
    f32 and bf16 backward at every head dim they take and with logical tiles
    that are not multiples of their own, and the bf16 dK/dV kernel's bits
    over two launches.  Before them, the bf16 and f32 backward kernels'
    build: no spills, dQ by vector reductions.
    Times: kernel, plain, and ``F.scaled_dot_product_attention`` with the
    same dropout rate (a yardstick only; the port never calls it)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from imagined_speech_translation_tpu_torch.ops import (
        flash_attention,
        flash_attention_reference,
        tile_keep_mask,
    )
    from imagined_speech_translation_tpu_torch.ops.dropout_mask import (
        dropout_blocks,
        tile_keep_mask_reference,
    )
    from imagined_speech_translation_tpu_torch.ops.flash_attention import (
        backward_dkv,
        backward_fused,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(10)
    rate, seed, S = 0.1, 1234, 1655
    checks = {"dropout_mask": [], "flash_fwd": [], "flash_bwd": []}

    # the bf16 backward's Hopper kernel and the f32 one on the tensor cores
    # (3xTF32; with dQ the fused backward, without it the split dK/dV) as
    # ptxas built them: no spills
    for fragment in ("flash_bwd_wgmma_kernel", "flash_bwd_tf32_kernel"):
        ptxas_no_spills(fragment, "train-kernels")
    # and as the card runs them: dQ (kDQ, the last template flag of the bf16
    # kernel, the second last of the f32 one) only by 4-float vector
    # reductions, the dK/dV-only kernels without any
    reductions = sorted(sass_reductions("flash_bwd_wgmma_kernel").items())
    reductions += sorted(sass_reductions("flash_bwd_tf32_kernel").items())
    for entry, ops in reductions:
        flags = re.search(r"_kernelI(?:Li\d+E)+Lb([01])ELb([01])E", entry)
        dq = flags.group(1 if "tf32" in entry else 2) == "1"
        log(f"[train-kernels] sass {entry}: global reductions {ops}")
        vector_only = bool(ops) and all("F32x4" in op for op in ops)
        if (dq and not vector_only) or (not dq and ops):
            raise AssertionError(f"{entry}: global reductions {ops}, want "
                                 + ("only F32x4 ones" if dq else "none"))

    # keep-mask probe: every logical tile of heads 0-3 and 95, both tilings
    for dtype in (torch.bfloat16, torch.float32):
        bq, bk = dropout_blocks(96, S, S, dtype)
        tiles = [(bh, qi, ki) for bh in (0, 1, 2, 3, 95)
                 for qi in range(-(-S // bq)) for ki in range(-(-S // bk))]
        kept = torch.zeros((), dtype=torch.float64, device=dev)
        mismatches = torch.zeros((), dtype=torch.int64, device=dev)
        for bh, qi, ki in tiles:
            got = tile_keep_mask(seed, bh, qi, ki, block_q=bq, block_k=bk, rate=rate, device=dev)
            want = tile_keep_mask_reference(seed, bh, qi, ki, block_q=bq, block_k=bk, rate=rate,
                                            device=dev)
            mismatches += (got != want).sum()
            kept += got.sum(dtype=torch.float64)
        frac = kept.item() / (len(tiles) * bq * bk)
        n_bad = int(mismatches.item())
        args = (seed, 3, 1, 2)
        kw = dict(block_q=bq, block_k=bk, rate=rate)
        ms = cuda_ms(lambda: tile_keep_mask(*args, **kw, device=dev), iters=50)
        plain = cuda_ms(lambda: tile_keep_mask_reference(*args, **kw, device=dev), iters=20)
        name = str(dtype).removeprefix("torch.")
        least, by = least_time(12 * bq * bk, 4 * bq * bk, "float32")  # ~12 integer ops each
        checks["dropout_mask"].append(dict(
            tile=[bq, bk], storage=name, tiles=len(tiles), mismatches=n_bad,
            keep_fraction=frac, max_abs_err=float(n_bad > 0), ms=ms, plain_ms=plain,
            library_ms=None, bound_ms=least, bound_by=by,
        ))
        log(f"[train-kernels] dropout_mask ({bq}, {bk}) x {len(tiles)} tiles: {n_bad} "
            f"mismatches, keep fraction {frac:.6f} (0.9 +- 1e-3); probe {ms:.4f} ms, "
            f"plain {plain:.4f} ms")
        if n_bad or not abs(frac - 0.9) <= 1e-3:
            raise AssertionError(f"dropout_mask probe: {n_bad} mismatches, keep {frac}")

    # forward with dropout: out against the plain version on the same input
    # values in float32 (the dtype's own logical tiles), max |err| / max |ref|
    # within fwd_rel; the same measure against the plain version without
    # the mask, and with the next seed's mask, must exceed fwd_rel, so the
    # bound tells a right mask from a missing or wrong one.  Out and lse are
    # also held to the serving phase's absolute bounds.
    for heads, d in ((6, 128), (3, 256)):
        shape = (16, heads, S, d)
        bh = 16 * heads
        for dtype, fwd_bound, fwd_rel, bwd_bound in ((torch.float32, 5e-4, 1e-4, 1e-4),
                                                     (torch.bfloat16, 3e-2, 1e-2, 3e-2)):
            name = str(dtype).removeprefix("torch.")
            q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.3)
                       .to(dev, dtype) for _ in range(3))
            dout = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dtype)
            kw = dict(dropout_rate=rate, dropout_seed=seed)
            out, lse = flash_attention(q, k, v, **kw)
            out = out.float()
            tiles = dict(zip(("block_q", "block_k"), dropout_blocks(bh, S, S, dtype)))
            qf, kf, vf = q.float(), k.float(), v.float()
            ref, ref_lse = flash_attention_reference(qf, kf, vf, **kw, **tiles)
            top = ref.abs().max().item()
            err = (out - ref).abs().max().item()
            rel = err / top
            lse_err = (lse - ref_lse).abs().max().item()
            del ref, ref_lse
            wrong = []
            for r, s in ((0.0, seed), (rate, seed + 1)):
                other = flash_attention_reference(qf, kf, vf, dropout_rate=r, dropout_seed=s,
                                                  **tiles)[0]
                wrong.append((out - other).abs().max().item() / top)
                del other
            del out, lse, qf, kf, vf
            ms = cuda_ms(lambda: flash_attention(q, k, v, **kw), iters=5)
            plain = cuda_ms(lambda: flash_attention_reference(q, k, v, **kw), iters=3)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, dropout_p=rate),
                          iters=5)
            flops = 4 * bh * S * S * d
            io = q.numel() * q.element_size()  # bytes of one (bh, S, d) tensor
            least, by = least_time(flops, 4 * io + 4 * bh * S, name)
            checks["flash_fwd"].append(dict(
                shape=[bh, S, d], dtype=name, variant=forward_variant(name, d), dropout=rate,
                max_abs_err=err, lse_max_abs_err=lse_err, bound=fwd_bound, rel_err=rel,
                rel_bound=fwd_rel,
                rel_err_vs_no_mask=wrong[0], rel_err_vs_next_seed=wrong[1], ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=least, bound_by=by,
            ))
            log(f"[train-kernels] flash_fwd ({bh}, {S}, {d}) {name} [{forward_variant(name, d)}] "
                f"dropout {rate}: max|err| "
                f"{err:.3e} (max|ref| {top:.3e}), lse {lse_err:.3e} (bound {fwd_bound:.0e}); "
                f"max|err|/max|ref| {rel:.2e} (bound {fwd_rel:.0e}), against no mask "
                f"{wrong[0]:.2e} and the next seed's {wrong[1]:.2e} (must exceed it); "
                f"kernel {ms:.3f} ms, plain {plain:.3f} ms, sdpa {lib:.3f} ms")
            if not (err <= fwd_bound and lse_err <= fwd_bound and rel <= fwd_rel):
                raise AssertionError(f"flash_fwd with dropout disagrees with its twin: {rel}")
            if not min(wrong) > fwd_rel:
                raise AssertionError(f"flash_fwd check cannot tell a missing or wrong mask "
                                     f"from the right one: {wrong} <= {fwd_rel}")

            # backward at rate 0 and rate 0.1; the rate-0.1 gradients must
            # also differ from the rate-0 ones by more than the bound.  Rate 0
            # dispatches to the split kernels (phase 4b), so the fused kernel
            # is called directly there.
            dropfree = None
            for r in (0.0, rate):
                kw = dict(dropout_rate=r, dropout_seed=seed)
                qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
                out, lse = flash_attention(qg, kg, vg, **kw)
                if r == 0.0:
                    delta = (dout.float() * out.float()).sum(dim=-1).reshape(bh, S)
                    fused = lambda: backward_fused(q, k, v, dout, lse, delta, d**-0.5,  # noqa: E731
                                                   (0.0, 0, 0, 0))
                else:
                    fused = lambda: torch.autograd.grad(out, (qg, kg, vg), dout,  # noqa: E731
                                                        retain_graph=True)
                got = fused()
                ref = flash_attention_reference(qg, kg, vg, **kw)[0]
                want = torch.autograd.grad(ref, (qg, kg, vg), dout, retain_graph=True)
                errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
                rel = [e / b.float().abs().max().item() for e, b in zip(errs, want)]
                apart, extra = None, {}
                if dtype == torch.float32:
                    # the kernel runs 3xTF32: the twin with every product in
                    # one TF32 pass must lie beyond the bound or, where it
                    # does not, beyond 4x the kernel's own error; dK and dV
                    # are each block's own rows, so two launches give the
                    # same bits (dQ's vector reductions come in any order)
                    again = fused()
                    same = all(torch.equal(a, b) for a, b in zip(got[1:], again[1:]))
                    del again
                    torch.backends.cuda.matmul.allow_tf32 = True
                    try:
                        one_pass = torch.autograd.grad(
                            flash_attention_reference(qg, kg, vg, **kw)[0], (qg, kg, vg), dout)
                    finally:
                        torch.backends.cuda.matmul.allow_tf32 = False
                    tf32 = [((a - b).abs().max() / b.abs().max()).item()
                            for a, b in zip(one_pass, want)]
                    del one_pass
                    extra = dict(rel_err_tf32_twin=tf32, deterministic_dk_dv=same)
                    log(f"[train-kernels] flash_bwd ({bh}, {S}, {d}) f32 dropout {r}: the 1xTF32 "
                        "twin dq dk dv " + " ".join(f"{x:.2e}" for x in tf32) + " (must exceed "
                        f"{bwd_bound:.0e} or 4x the kernel's error); two launches' dK and dV "
                        f"{'bit-identical' if same else 'DIFFER'}")
                    if not all(x > bwd_bound or x > 4 * e for x, e in zip(tf32, rel)):
                        raise AssertionError(f"flash_bwd f32 check cannot tell 1xTF32 products: "
                                             f"{tf32} against {rel}")
                    if not same:
                        raise AssertionError("flash_bwd f32: two launches gave different dK/dV")
                if r == 0.0:
                    dropfree = want
                else:
                    apart = [((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                             for a, b in zip(got, dropfree)]
                    dropfree = None
                del got, want
                ms = cuda_ms(fused, iters=5)
                plain = cuda_ms(lambda: torch.autograd.grad(ref, (qg, kg, vg), dout,
                                                            retain_graph=True), iters=3)
                del ref
                sdpa = F.scaled_dot_product_attention(qg, kg, vg, dropout_p=r)
                lib = cuda_ms(lambda: torch.autograd.grad(sdpa, (qg, kg, vg), dout,
                                                          retain_graph=True), iters=5)
                del out, lse, sdpa, fused
                # reads q, k, v, dO, lse, delta; writes dQ, dK, dV
                least, by = least_time(2.5 * flops, 7 * io + 8 * bh * S, name)
                checks["flash_bwd"].append(dict(
                    shape=[bh, S, d], dtype=name, variant=backward_variant(name, d), dropout=r,
                    max_abs_err=max(errs), rel_err_dq_dk_dv=rel, bound=bwd_bound,
                    rel_err_vs_no_mask=apart, **extra, ms=ms, plain_ms=plain, library_ms=lib,
                    bound_ms=least, bound_by=by,
                ))
                log(f"[train-kernels] flash_bwd ({bh}, {S}, {d}) {name} "
                    f"[{backward_variant(name, d)}] dropout {r}: "
                    f"max|err|/max|ref| dq {rel[0]:.2e} dk {rel[1]:.2e} dv {rel[2]:.2e} "
                    f"(bound {bwd_bound:.0e})"
                    + ("" if apart is None else ", against the rate-0 gradients " + " ".join(
                        f"{a:.2e}" for a in apart) + " (must exceed it)")
                    + f"; kernel {ms:.3f} ms, plain {plain:.3f} ms, sdpa bwd {lib:.3f} ms "
                    f"({ms / lib:.2f}x), bound {least:.3f} ms")
                if not max(rel) <= bwd_bound:
                    raise AssertionError(f"flash_bwd disagrees with autograd of its twin: {rel}")
                if apart is not None and not min(apart) > bwd_bound:
                    raise AssertionError(f"flash_bwd check cannot tell the mask's gradients "
                                         f"from the rate-0 ones: {apart} <= {bwd_bound}")
            del q, k, v, dout
            torch.cuda.empty_cache()

    # the f32 forward with dropout on ragged lengths at head dims 8-256 (12
    # and 100 on the CUDA cores, the others 3xTF32), with logical tiles
    # that are multiples of the 3xTF32 kernel's warp tiles (128 x 128: the
    # mask's hash input hoisted per warp tile) and tiles that are not (96 x
    # 40: the per-element mask); out within 1e-4 (max |err| / max |ref|) of
    # the plain version in float32, and farther than that from its rate-0 out
    # (inputs from their own generator, so the later checks keep theirs)
    f32_fwd, f32_rng = {}, np.random.default_rng(11)
    for d in (8, 12, 24, 64, 100, 128, 192, 256):
        for bq, bk in ((128, 128), (96, 40)):
            q = torch.from_numpy(f32_rng.normal(size=(2, 3, 200, d)).astype(np.float32) * 0.3)
            kv = torch.from_numpy(f32_rng.normal(size=(2, 2, 3, 333, d)).astype(np.float32) * 0.3)
            q, k, v = q.to(dev), kv[0].to(dev), kv[1].to(dev)
            kw = dict(dropout_rate=rate, dropout_seed=seed, block_q=bq, block_k=bk)
            out = flash_attention(q, k, v, **kw)[0]
            ref = flash_attention_reference(q, k, v, **kw)[0]
            top = ref.abs().max().item()
            f32_fwd[(d, bq, bk)] = ((out - ref).abs().max().item() / top,
                                    (out - flash_attention_reference(q, k, v)[0]).abs().max()
                                    .item() / top)
            if not f32_fwd[(d, bq, bk)][0] <= FWD_REL["float32"] < f32_fwd[(d, bq, bk)][1]:
                raise AssertionError(f"flash_fwd f32 d={d} tiles {bq}x{bk}: "
                                     f"{f32_fwd[(d, bq, bk)]} from its twin and from rate 0 "
                                     "(bound 1e-4)")
    log("[train-kernels] flash_fwd f32 (6, 200 x 333, d) dropout 0.1, max|err|/max|ref| "
        "(against the rate-0 out, must exceed 1e-4) by (d, block_q, block_k): "
        + ", ".join(f"{c}: {a:.1e} ({b:.2f})" for c, (a, b) in f32_fwd.items()))

    # other head dims (96/192: reference heads (8,4,4); 12/24: cli/profile.py
    # --tiny) and ragged lengths, correctness only: both dtypes and both
    # backward variants (bf16 with d % 16 == 0 takes the tensor cores, other
    # d, 12, 24 and 100 among them, the CUDA cores)
    worst = {}
    for d in (8, 12, 24, 40, 48, 96, 100, 192):
        for dtype, bwd_bound in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
            q = torch.from_numpy(rng.normal(size=(2, 3, 200, d)).astype(np.float32) * 0.3)
            kv = torch.from_numpy(rng.normal(size=(2, 2, 3, 333, d)).astype(np.float32) * 0.3)
            dout = torch.from_numpy(rng.normal(size=(2, 3, 200, d)).astype(np.float32))
            q, k, v = (t.to(dev, dtype).requires_grad_() for t in (q, kv[0], kv[1]))
            dout = dout.to(dev, dtype)
            kw = dict(dropout_rate=rate, dropout_seed=seed, block_q=128, block_k=128)
            got = torch.autograd.grad(flash_attention(q, k, v, **kw)[0], (q, k, v), dout)
            want = torch.autograd.grad(flash_attention_reference(q, k, v, **kw)[0], (q, k, v),
                                       dout)
            rel = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                      for a, b in zip(got, want))
            worst[(d, str(dtype).removeprefix("torch."))] = rel
            if not rel <= bwd_bound:
                raise AssertionError(f"flash_bwd d={d} {dtype}: {rel} > {bwd_bound}")
    log("[train-kernels] flash_bwd (6, 200 x 333, d) dropout 0.1 max|err|/max|ref| by "
        "(d, dtype): " + ", ".join(f"{k}: {v:.1e}" for k, v in worst.items()))

    def rel_err(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    # the f32 backward on ragged lengths at every multiple of 8 up to 256 (the
    # 3xTF32 kernel) and at 12 and 100 (the CUDA-core one), with logical tiles
    # 128 x 128, on which the 3xTF32 kernel hoists the mask's hash input to
    # each warp pair's 16-key x 32-query slice, and 96 x 40, on which it hashes
    # per element; the gradients within 1e-4 (max |err| / max |ref|) of
    # autograd through the plain version and farther than that from its rate-0
    # gradients (inputs from their own generator, so the later checks keep
    # theirs)
    f32_bwd, bwd_rng = {}, np.random.default_rng(12)
    for d in sorted({*range(8, 257, 8), 12, 100}):
        for bq, bk in ((128, 128), (96, 40)):
            q = torch.from_numpy(bwd_rng.normal(size=(2, 3, 200, d)).astype(np.float32) * 0.3)
            kv = torch.from_numpy(bwd_rng.normal(size=(2, 2, 3, 333, d)).astype(np.float32) * 0.3)
            dout = torch.from_numpy(bwd_rng.normal(size=(2, 3, 200, d)).astype(np.float32))
            q, k, v = (t.to(dev).requires_grad_() for t in (q, kv[0], kv[1]))
            dout = dout.to(dev)
            kw = dict(dropout_rate=rate, dropout_seed=seed, block_q=bq, block_k=bk)
            got = torch.autograd.grad(flash_attention(q, k, v, **kw)[0], (q, k, v), dout)
            want = torch.autograd.grad(flash_attention_reference(q, k, v, **kw)[0], (q, k, v),
                                       dout)
            rate0 = torch.autograd.grad(flash_attention_reference(q, k, v)[0], (q, k, v), dout)
            variant = backward_variant("float32", d).removeprefix("flash_bwd_")
            mask = ("per element" if variant != "tf32_kernel" or bq % 32 or bk % 16
                    else "hoisted")
            case = (d, bq, bk, variant, mask)
            f32_bwd[case] = (max(rel_err(a, b) for a, b in zip(got, want)),
                             min(rel_err(a, b) for a, b in zip(got, rate0)))
            if not f32_bwd[case][0] <= 1e-4 < f32_bwd[case][1]:
                raise AssertionError(f"flash_bwd f32 {case}: {f32_bwd[case]} from its twin and "
                                     "from rate 0 (bound 1e-4)")
    log("[train-kernels] flash_bwd f32 (6, 200 x 333, d) dropout 0.1, max|err|/max|ref| "
        "(against the rate-0 gradients, must exceed 1e-4) by (d, block_q, block_k, variant, "
        "mask): " + ", ".join(f"{c}: {a:.1e} ({b:.2f})" for c, (a, b) in f32_bwd.items()))

    # the Hopper kernels (forward and backward) at every head dim they take
    # (multiples of 16 up to 256) on ragged lengths, with logical tiles that
    # are multiples of their tiles (128 x 128: the mask's hash input hoisted
    # per tile) and, at d = 64, 128, 256, with tiles that are not (96 x 160:
    # the per-element mask); the forward's out within 1e-2 (max |err| / max
    # |ref|) of the plain version in float32 on the same input values, the
    # gradients within 3e-2 of autograd through the plain version, and each
    # farther than its bound from the plain version's rate-0 out or gradients
    cases = [(d, 128, 128) for d in range(16, 257, 16)] + [(d, 96, 160) for d in (64, 128, 256)]
    worst, nearest, fwd = {}, {}, {}
    for d, bq, bk in cases:
        q = torch.from_numpy(rng.normal(size=(2, 3, 200, d)).astype(np.float32) * 0.3)
        kv = torch.from_numpy(rng.normal(size=(2, 2, 3, 333, d)).astype(np.float32) * 0.3)
        dout = torch.from_numpy(rng.normal(size=(2, 3, 200, d)).astype(np.float32))
        q, k, v = (t.to(dev, torch.bfloat16).requires_grad_() for t in (q, kv[0], kv[1]))
        dout = dout.to(dev, torch.bfloat16)
        kw = dict(dropout_rate=rate, dropout_seed=seed, block_q=bq, block_k=bk)
        out = flash_attention(q, k, v, **kw)[0]
        got = torch.autograd.grad(out, (q, k, v), dout)
        with torch.no_grad():
            qf, kf, vf = q.float(), k.float(), v.float()
            fwd[(d, bq, bk)] = (rel_err(out, flash_attention_reference(qf, kf, vf, **kw)[0]),
                                rel_err(out, flash_attention_reference(qf, kf, vf)[0]))
        want = torch.autograd.grad(flash_attention_reference(q, k, v, **kw)[0], (q, k, v), dout)
        rate0 = torch.autograd.grad(flash_attention_reference(q, k, v)[0], (q, k, v), dout)
        worst[(d, bq, bk)] = max(rel_err(a, b) for a, b in zip(got, want))
        nearest[(d, bq, bk)] = min(rel_err(a, b) for a, b in zip(got, rate0))
        if not fwd[(d, bq, bk)][0] <= FWD_REL["bfloat16"] < fwd[(d, bq, bk)][1]:
            raise AssertionError(f"flash_fwd bf16 d={d} tiles {bq}x{bk}: {fwd[(d, bq, bk)]} "
                                 "from its twin and from rate 0 (bound 1e-2)")
        if not worst[(d, bq, bk)] <= 3e-2 < nearest[(d, bq, bk)]:
            raise AssertionError(f"flash_bwd bf16 d={d} tiles {bq}x{bk}: {worst[(d, bq, bk)]} "
                                 f"from its twin, {nearest[(d, bq, bk)]} from rate 0 "
                                 "(bound 3e-2)")
    log("[train-kernels] flash_fwd bf16 (6, 200 x 333, d) dropout 0.1, max|err|/max|ref| "
        "(against the rate-0 out, must exceed 1e-2) by (d, block_q, block_k): "
        + ", ".join(f"{c}: {fwd[c][0]:.1e} ({fwd[c][1]:.2f})" for c in cases))
    log("[train-kernels] flash_bwd bf16 (6, 200 x 333, d) dropout 0.1, max|err|/max|ref| "
        "(against the rate-0 gradients, must exceed 3e-2) by (d, block_q, block_k): "
        + ", ".join(f"{c}: {worst[c]:.1e} ({nearest[c]:.2f})" for c in cases))

    # the split dK/dV kernel takes the same Hopper kernel without dQ: two
    # launches at the eval-mode gradient's shapes give the same bits
    for bh, d in ((192, 128), (96, 256)):
        q, k, v, dout = (
            torch.from_numpy(rng.normal(size=(1, bh, S, d)).astype(np.float32) * 0.3)
            .to(dev, torch.bfloat16) for _ in range(4))
        out, lse = flash_attention(q, k, v)
        delta = (dout.float() * out.float()).sum(dim=-1).reshape(bh, S)
        first = backward_dkv(q, k, v, dout, lse, delta, d**-0.5)
        again = backward_dkv(q, k, v, dout, lse, delta, d**-0.5)
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        log(f"[train-kernels] flash_bwd_dkv ({bh}, {S}, {d}) bf16: two launches "
            f"{'bit-identical' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"split dK/dV bf16 ({bh}, {S}, {d}): two launches differ")
        del q, k, v, dout, out, lse, delta, first, again
    torch.cuda.empty_cache()
    return checks


def phase_split_kernels():
    """The rate-0 backward's split kernels at the eval-mode gradient's shapes
    (``cli/profile.py --what train`` at B = 8 x 4 regions: (192, 1655, 128)
    self-attention and (96, 1655, 256) cross-scale attention) and at head
    dims 8-192 on 200 queries x 333 keys, in float32 and bfloat16, and in
    bfloat16 at every multiple of 16 up to 256 there and on 1655 queries x
    1580 keys.  dQ, dK
    and dV against autograd through the plain version in float32 on the same
    input values, max |err| / max |ref| within 1e-4 f32 / 2e-2 bf16.  Inputs:
    q, k ~ N(0, 0.3^2), v ~ N(0.5, 0.3^2), dO ~ N(0, 1); with V's non-zero
    mean the delta term carries most of dS, so the plain gradients computed
    without it must lie farther than the bound.  At the full shapes in
    float32 the plain gradients with every product in one TF32 pass must
    lie farther too: the f32 kernels run 3xTF32, and a kernel that dropped
    its small terms would land there.  Before the checks, the f32 kernels'
    and the bf16 dQ kernel's ptxas reports must show no spills.  Two launches must give the
    same bits, and the fused kernel at rate 0 must agree within the bound.
    Times: dQ, dK/dV and both (kernels alone), the fused kernel at rate 0,
    the plain autograd and ``F.scaled_dot_product_attention``'s backward at
    rate 0 (one ``autograd.grad`` call; a yardstick only)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from imagined_speech_translation_tpu_torch import _kernels
    from imagined_speech_translation_tpu_torch.ops import (
        flash_attention,
        flash_attention_reference,
    )
    from imagined_speech_translation_tpu_torch.ops.flash_attention import (
        backward_dkv,
        backward_dq,
        backward_fused,
        backward_split,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(20)
    checks = {"flash_bwd_dq": [], "flash_bwd_dkv": []}

    # the tensor-core kernels as ptxas built them, f32 (3xTF32) and the bf16
    # dQ (Hopper): no spills; the bf16 dQ's SASS: wgmma products and TMA
    # loads, and no reduction or atomic (each block owns its dQ rows)
    for fragment in ("flash_bwd_dq_tf32_kernel", "flash_bwd_tf32_kernel",
                     "flash_bwd_dq_wgmma_kernel"):
        ptxas_no_spills(fragment, "split-kernels")
    atomics = sass_reductions("flash_bwd_dq_wgmma_kernel")
    ops = sass_reductions("flash_bwd_dq_wgmma_kernel", r"\b(?:HGMMA|UTMALDG)\b")
    log(f"[split-kernels] bf16 dQ SASS: {ops}, reductions and atomics {atomics}")
    if (not ops or any(atomics.values())
            or not all(o.get("HGMMA") and o.get("UTMALDG") for o in ops.values())):
        raise AssertionError(f"bf16 dQ kernel: wgmma and TMA {ops}, reductions {atomics}")
    bounds = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

    def inputs(b, h, s_q, s_kv, d, dtype):
        q = rng.normal(size=(b, h, s_q, d)) * 0.3
        k = rng.normal(size=(b, h, s_kv, d)) * 0.3
        v = rng.normal(size=(b, h, s_kv, d)) * 0.3 + 0.5
        dout = rng.normal(size=(b, h, s_q, d))
        return [torch.from_numpy(a.astype(np.float32)).to(dev, dtype) for a in (q, k, v, dout)]

    def autograd_grads(q, k, v, dout):
        """Autograd through the plain version in float32."""
        qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
        return torch.autograd.grad(flash_attention_reference(qf, kf, vf)[0], (qf, kf, vf),
                                   dout.float())

    def tf32_grads(q, k, v, dout):
        """The same with every product in one TF32 pass (what the f32 kernels
        would give if they dropped 3xTF32's small terms)."""
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return autograd_grads(q, k, v, dout)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    def plain_grads(q, k, v, dout):
        """Autograd through the plain version in float32, and the dQ and dK
        it gives without the delta term (dS = P * dP)."""
        qf, kf, vf = (t.float() for t in (q, k, v))
        scale = q.shape[-1] ** -0.5
        want = autograd_grads(q, k, v, dout)
        with torch.no_grad():
            p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
            ds = p * torch.matmul(dout.float(), vf.transpose(-1, -2))
            del p
            no_delta = (torch.matmul(ds, kf) * scale, torch.matmul(ds.transpose(-1, -2), qf) * scale)
        return want, no_delta

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    for b, h, d in ((32, 6, 128), (32, 3, 256)):
        S = 1655
        bh = b * h
        for dtype in (torch.float32, torch.bfloat16):
            name, bound = str(dtype).removeprefix("torch."), bounds[dtype]
            q, k, v, dout = inputs(b, h, S, S, d, dtype)
            scale = d**-0.5
            out, lse = flash_attention(q, k, v)
            delta = (dout.float() * out.float()).sum(dim=-1).reshape(bh, S)
            args = (q, k, v, dout, lse, delta, scale)
            got = backward_split(*args)
            again = backward_split(*args)
            same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
            del again
            fused = backward_fused(*args, (0.0, 0, 0, 0))
            vs_fused = [rel(a, f) for a, f in zip(got, fused)]
            del fused
            want, no_delta = plain_grads(q, k, v, dout)
            errs = [(a.float() - w).abs().max().item() for a, w in zip(got, want)]
            rels = [rel(a, w) for a, w in zip(got, want)]
            apart = [rel(n, w) for n, w in zip(no_delta, want[:2])]
            del no_delta
            # f32 only: the plain gradients in 1xTF32 must lie beyond the bound
            tf32_apart = ([rel(a, w) for a, w in zip(tf32_grads(q, k, v, dout), want)]
                          if dtype == torch.float32 else None)
            del got, want

            ms_dq = cuda_ms(lambda: backward_dq(*args), iters=5)
            ms_dkv = cuda_ms(lambda: backward_dkv(*args), iters=5)
            ms_split = cuda_ms(lambda: backward_split(*args), iters=5)
            ms_fused = cuda_ms(lambda: backward_fused(*args, (0.0, 0, 0, 0)), iters=5)
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
            ref = flash_attention_reference(qg, kg, vg)[0]
            plain = cuda_ms(lambda: torch.autograd.grad(ref, (qg, kg, vg), dout,
                                                        retain_graph=True), iters=3)
            del ref
            sdpa = F.scaled_dot_product_attention(qg, kg, vg)
            lib = cuda_ms(lambda: torch.autograd.grad(sdpa, (qg, kg, vg), dout,
                                                      retain_graph=True), iters=5)
            del sdpa, out, lse
            flops = 2 * bh * S * S * d  # one (S x S x d) product
            io = q.numel() * q.element_size()
            rows = 8 * bh * S  # lse and delta, float32
            # dQ reads q, k, v, dO, lse, delta and writes dQ; dK/dV writes two
            b_dq = least_time(3 * flops, 5 * io + rows, name)
            b_dkv = least_time(4 * flops, 6 * io + rows, name)
            b_split = least_time(7 * flops, 7 * io + rows, name)
            common = dict(shape=[bh, S, d], dtype=name, variant=split_dq_variant(name, d),
                          bound=bound, deterministic=same,
                          rel_err_vs_fused_rate0=vs_fused, rel_err_tf32_twin=tf32_apart,
                          split_ms=ms_split,
                          fused_rate0_ms=ms_fused, split_bound_ms=b_split[0],
                          plain_ms=plain, library_ms=lib)
            checks["flash_bwd_dq"].append(dict(
                common, max_abs_err=errs[0], rel_err=rels[0], rel_err_without_delta=apart[0],
                ms=ms_dq, bound_ms=b_dq[0], bound_by=b_dq[1]))
            checks["flash_bwd_dkv"].append(dict(
                common, max_abs_err=max(errs[1:]), rel_err_dk_dv=rels[1:],
                rel_err_without_delta=apart[1], ms=ms_dkv, bound_ms=b_dkv[0],
                bound_by=b_dkv[1]))
            log(f"[split-kernels] ({bh}, {S}, {d}) {name}: max|err|/max|ref| dq {rels[0]:.2e} "
                f"dk {rels[1]:.2e} dv {rels[2]:.2e} (bound {bound:.0e}); without delta dq "
                f"{apart[0]:.2e} dk {apart[1]:.2e} (must exceed it); "
                + ("" if tf32_apart is None else "1xTF32 twin dq dk dv "
                   + " ".join(f"{x:.2e}" for x in tf32_apart) + " (must exceed it); ")
                + "two launches "
                f"{'bit-identical' if same else 'DIFFER'}; against the fused kernel at rate 0 "
                + " ".join(f"{x:.2e}" for x in vs_fused)
                + f"; dq {ms_dq:.3f} ms + dkv {ms_dkv:.3f} ms = split {ms_split:.3f} ms "
                f"(bound {b_split[0]:.3f} ms, {b_split[1]}), fused at rate 0 {ms_fused:.3f} ms, "
                f"plain {plain:.3f} ms, sdpa bwd {lib:.3f} ms")
            if not max(rels) <= bound:
                raise AssertionError(f"split backward disagrees with autograd of its twin: {rels}")
            if not min(apart) > bound:
                raise AssertionError(f"split backward check cannot tell a missing delta term: "
                                     f"{apart} <= {bound}")
            if tf32_apart is not None and not min(tf32_apart) > bound:
                raise AssertionError(f"split backward check cannot tell 1xTF32 products: "
                                     f"{tf32_apart} <= {bound}")
            if not same:
                raise AssertionError("split backward: two launches gave different bits")
            if not max(vs_fused) <= bound:
                raise AssertionError(f"split and fused backward disagree at rate 0: {vs_fused}")
            del q, k, v, dout, delta, args, qg, kg, vg
            torch.cuda.empty_cache()

    # other head dims (96/192: reference heads (8,4,4); 12/24: cli/profile.py
    # --tiny) and ragged lengths, through flash_attention's autograd at rate
    # 0, which must launch the split kernels and not the fused one; both
    # dtypes and every variant (bf16 with d % 16 == 0 takes the Hopper dQ
    # kernel, f32 with d % 8 == 0 the 3xTF32 ones, other d, 12 and 100 among
    # them, the CUDA cores).  In bf16 every multiple of 16 from 16 to 256, on
    # 200 queries x 333 keys and at full length with s_q != s_kv (1655 x 1580:
    # neither a multiple of 64)
    worst = {}
    cases = [(d, dtype, 200, 333) for d in (8, 12, 24, 40, 48, 96, 100, 192) for dtype in bounds]
    cases += [(d, torch.bfloat16, s_q, s_kv) for s_q, s_kv in ((200, 333), (1655, 1580))
              for d in range(16, 257, 16) if (d, torch.bfloat16, s_q, s_kv) not in cases]
    _kernels.reset_launch_counts()
    for d, dtype, s_q, s_kv in cases:
        bound = bounds[dtype]
        b, h = (2, 3) if s_q < 1000 else (1, 2)
        q, k, v, dout = inputs(b, h, s_q, s_kv, d, dtype)
        qg, kg, vg = (t.requires_grad_() for t in (q, k, v))
        got = torch.autograd.grad(flash_attention(qg, kg, vg)[0], (qg, kg, vg), dout)
        want, no_delta = plain_grads(q, k, v, dout)
        err = max(rel(a, w) for a, w in zip(got, want))
        apart = min(rel(n, w) for n, w in zip(no_delta, want[:2]))
        name = str(dtype).removeprefix("torch.")
        variant = split_dq_variant(name, d).removeprefix("flash_bwd_")
        worst[(d, name, f"{s_q}x{s_kv}", variant)] = err
        if not err <= bound < apart:
            raise AssertionError(f"split backward d={d} {dtype} {s_q} x {s_kv}: {err} (without "
                                 f"delta {apart}), bound {bound}")
    launches = _kernels.launch_counts()
    want = len(cases)
    if launches["flash_bwd"] or launches["flash_bwd_dq"] != want or (
        launches["flash_bwd_dkv"] != want
    ):
        raise AssertionError(f"rate-0 autograd launched {launches}, want {want} split dQ and "
                             "dK/dV and no fused backward")
    log("[split-kernels] ragged, rate 0: max|err|/max|ref| by (d, dtype, s_q x s_kv, "
        "dQ variant): "
        + ", ".join(f"{k}: {v:.1e}" for k, v in worst.items()))
    return checks


def recording_tokenizer_class():
    """The port's tokenizer class, whose instances keep every id batch they
    decode (``.history``, the last as ``.ids``); ``Recording.instances``
    lists them."""
    import numpy as np

    from imagined_speech_translation_tpu_torch.data import ChineseCharTokenizer

    class Recording(ChineseCharTokenizer):
        instances: list = []

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.history = []
            Recording.instances.append(self)

        @property
        def ids(self):
            return self.history[-1]

        def batch_decode(self, batch_ids, **kw):
            self.history.append(np.asarray(batch_ids))
            return super().batch_decode(batch_ids, **kw)

    return Recording


def phase_slice(smi: str):
    """Full-width serving slice: 16 raw windows -> text, BN folded, bf16."""
    import numpy as np
    import torch

    from imagined_speech_translation_tpu_torch.config import default_config, replace_nested
    from imagined_speech_translation_tpu_torch import _kernels
    from imagined_speech_translation_tpu_torch.cli.profile_slice import (
        synthetic_montage,
        synthetic_vocab,
    )
    from imagined_speech_translation_tpu_torch.cli.serve import build_decode_fn
    from imagined_speech_translation_tpu_torch.data import RegionSpec
    from imagined_speech_translation_tpu_torch.models import build_model

    cfg = default_config()
    # pinned decode length (min == max): every window decodes all 16 tokens
    cfg = replace_nested(cfg, "generation.min_length", cfg.generation.max_length)
    T = cfg.data.n_timepoints
    tok = recording_tokenizer_class()(synthetic_vocab(cfg.model.bart.vocab_size))
    spec = RegionSpec.from_channel_names(synthetic_montage())
    t0 = time.perf_counter()
    model = build_model(cfg.model, T, seed=0, device=DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[slice] model: {n_params / 1e6:.1f}M params, random from seed 0, "
        f"built in {time.perf_counter() - t0:.1f} s")
    decode_fn = build_decode_fn(cfg, tok, spec, model, device=DEVICE, fold_bn=True,
                                compute_dtype=torch.bfloat16)
    windows = np.random.default_rng(1).normal(size=(16, 125, T)).astype(np.float32)
    t0 = time.perf_counter()
    decode_fn(windows)
    log(f"[slice] first batch (warm-up) {time.perf_counter() - t0:.2f} s")

    _kernels.reset_launch_counts()
    texts = decode_fn(windows)
    launches = _kernels.launch_counts()
    log(f"[slice] kernel launches in one batch: {launches}")
    missing = [k for k in SERVING_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"the serving path launched no {missing} kernel")
    ids = np.asarray(tok.ids)
    if len(texts) != 16 or not all(isinstance(t, str) for t in texts):
        raise AssertionError(f"expected 16 strings, got {texts!r}")
    if ids.shape != (16, cfg.generation.max_length) or ids.min() < 0 or (
        ids.max() >= cfg.model.bart.vocab_size
    ):
        raise AssertionError(f"tokens out of shape/range: {ids.shape} [{ids.min()}, {ids.max()}]")
    log(f"[slice] window 0 -> {texts[0][:40]!r}")

    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_fn(windows)
        times.append(time.perf_counter() - t0)
    sec = float(np.median(times))
    log(f"[slice] B=16 T={T} beam {cfg.generation.num_beams} pinned length "
        f"{cfg.generation.max_length}, bf16, BN folded: {sec:.4f} s/batch (median of 5, "
        f"all {[round(t, 4) for t in times]}), {16 / sec:.2f} windows/s on {smi}")
    return decode_fn, launches, dict(cfg=cfg, tok=tok, spec=spec, model=model)


def phase_card_vs_cpu(ctx):
    """One window, float32, BN unfolded, TF32 off: the same port and weights
    on the card and on the CPU."""
    import copy

    import numpy as np
    import torch

    from imagined_speech_translation_tpu_torch.cli.serve import build_decode_fn
    from imagined_speech_translation_tpu_torch.frontend import SignalFrontend

    cfg, tok, spec, model = ctx["cfg"], ctx["tok"], ctx["spec"], ctx["model"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    T = cfg.data.n_timepoints
    window = np.random.default_rng(2).normal(size=(1, 125, T)).astype(np.float32)
    models = {DEVICE: model, "cpu": copy.deepcopy(model).cpu()}
    frontend = SignalFrontend(cfg.frontend)
    R, C = spec.channel_mask.shape
    feats, ids = {}, {}
    for dev, m in models.items():
        t0 = time.perf_counter()
        with torch.inference_mode():
            clean = frontend.preprocess(torch.from_numpy(window).to(dev))
            stacked = clean[:, torch.as_tensor(spec.gather_indices.reshape(-1), device=dev)]
            mask = torch.as_tensor(spec.channel_mask, device=dev)
            feat, _ = m.encode(stacked.reshape(1, R, C, T), mask)
        feats[dev] = feat.float().cpu()
        build_decode_fn(cfg, tok, spec, m, device=dev, fold_bn=False)(window)
        ids[dev] = np.asarray(tok.ids)
        log(f"[card-vs-cpu] {dev}: encode + decode in {time.perf_counter() - t0:.2f} s")
    rel = ((feats[DEVICE] - feats["cpu"]).abs().max() / feats["cpu"].abs().max()).item()
    same = bool((ids[DEVICE] == ids["cpu"]).all())
    log(f"[card-vs-cpu] fused encoder feature max rel err {rel:.3e} (bound 1e-3); "
        f"tokens {'agree' if same else 'differ'}: card {ids[DEVICE][0].tolist()} "
        f"cpu {ids['cpu'][0].tolist()}")
    if not rel <= 1e-3:
        raise AssertionError(f"card and CPU encoder features disagree: {rel}")
    return rel, same


def phase_serving(decode_fn, n_timepoints: int):
    """The decode function behind the runtime's batch scheduler."""
    import asyncio

    import numpy as np

    from imagined_speech_translation_tpu_torch.runtime import BatchScheduler

    windows = np.random.default_rng(3).normal(size=(20, 125, n_timepoints)).astype(np.float32)

    async def run():
        async with BatchScheduler(decode_fn, max_batch=16, max_delay_ms=25) as sched:
            texts = await asyncio.gather(*(sched.submit(w) for w in windows))
        return texts, sched.stats()

    texts, stats = asyncio.run(run())
    if len(texts) != len(windows) or not all(isinstance(t, str) for t in texts):
        raise AssertionError(f"scheduler answered {len(texts)} of {len(windows)}")
    log(f"[serving] {len(texts)}/{len(windows)} windows answered; stats {stats}")
    return stats


def phase_train(smi: str, mixed_precision: bool = True):
    """Full-width training: ``default_config()`` (mixed precision, bf16
    accumulation carry, fused AdamW with bf16 first moment, composite loss),
    random weights from seed 0, 3 optimizer steps of ``make_train_step``
    over synthetic windows (8 micro-steps of 4 windows, T = 1651, labels of
    16 tokens).  The default warmup starts at learning rate 0, so step 0
    must leave the weights as they were and step 1 must move them.  With
    ``mixed_precision=False`` the same in float32 (the reference's own
    numerics), whose attention backward runs the f32 fused kernel."""
    import numpy as np
    import torch

    from imagined_speech_translation_tpu_torch import _kernels
    from imagined_speech_translation_tpu_torch.cli.profile_slice import (
        synthetic_train_batch,
        synthetic_vocab,
    )
    from imagined_speech_translation_tpu_torch.config import default_config, replace_nested
    from imagined_speech_translation_tpu_torch.data import ChineseCharTokenizer
    from imagined_speech_translation_tpu_torch.training import (
        AdaptiveLossScheduler,
        FusedAdamW,
        build_train_module,
        create_train_state,
        get_top_k_vocab_indices,
        make_train_step,
    )

    cfg = replace_nested(default_config(), "training.mixed_precision", mixed_precision)
    tc = cfg.training
    accum, micro, n_steps = tc.grad_accum_steps, tc.batch_size, 3
    tag = "train" if mixed_precision else "train-f32"
    tok = ChineseCharTokenizer(synthetic_vocab(cfg.model.bart.vocab_size))
    bow = get_top_k_vocab_indices(tok, tc.loss.bow_vocab_size)
    t0 = time.perf_counter()
    module = build_train_module(cfg, len(bow), seed=0, device=DEVICE)
    n_params = sum(p.numel() for p in module.parameters())
    names = [n for n, _ in module.named_parameters()]
    opt = FusedAdamW(names, tc.optimizer, total_steps=n_steps)
    state = create_train_state(module, opt, AdaptiveLossScheduler(tc.loss).initial_weights())
    step_fn = make_train_step(module, opt, cfg, bow)
    log(f"[{tag}] model + loss heads: {n_params / 1e6:.1f}M params, random from seed 0, "
        f"built in {time.perf_counter() - t0:.1f} s; mixed precision {tc.mixed_precision}, "
        f"carry {tc.grad_accum_dtype}, mu {tc.optimizer.mu_dtype}, accum {accum} x {micro}")
    probe = dict(module.named_parameters())["model.brain_encoder.region_encoders.attn0.q_proj.weight"]
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    times = []
    for i in range(n_steps):
        batch = {k: v.to(DEVICE) for k, v in
                 synthetic_train_batch(cfg, accum, micro, cfg.data.max_length, 100 + i).items()}
        before = probe.detach().clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch, torch.Generator().manual_seed(i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        m = {k: float(v) for k, v in metrics.items()}
        moved = (probe.detach() - before).abs().max().item()
        log(f"[{tag}] step {i}: loss {m['loss']:.4f} (ce {m['loss_ce']:.4f}, align "
            f"{m['loss_align']:.4f}, bow {m['loss_bow']:.4f}, div {m['loss_div']:.4f}, var "
            f"{m['loss_var']:.4f}), grad norm {m['grad_norm']:.4f}, max |dW| of attn0.q_proj "
            f"{moved:.3e}, {times[-1]:.3f} s")
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"train step {i}: non-finite metrics {m}")
        if (i == 0) != (moved == 0.0):
            raise AssertionError(f"train step {i} (lr {'0' if i == 0 else '> 0'}) moved the "
                                 f"weights by {moved}")
    launches = _kernels.launch_counts()
    want = 5 * accum * n_steps  # 3 self + 2 cross-scale attentions per micro-step
    log(f"[{tag}] kernel launches in {n_steps} steps: {launches} (flash fwd/bwd want {want}, "
        "split dQ and dK/dV 0: every training attention has dropout 0.1)")
    if launches["flash_fwd"] != want or launches["flash_bwd"] != want or (
        launches["flash_bwd_dq"] or launches["flash_bwd_dkv"]
    ):
        raise AssertionError(f"training launched flash {launches}, want {want} forward and "
                             "fused backward each and no split backward")
    sec = float(np.mean(times[1:]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag}] {'bf16 mixed precision' if mixed_precision else 'float32'}: {sec:.3f} s/step "
        f"(mean of steps 1-{n_steps - 1}; all {[round(t, 3) for t in times]}), "
        f"{accum * micro / sec:.2f} windows/s, peak memory {peak:.1f} GiB, on {smi}")
    del state, step_fn, module, opt
    torch.cuda.empty_cache()
    return launches


def phase_train_card_vs_cpu():
    """The loss function's eval-mode forward (dropout off) and its gradients
    on a small float32 configuration, on the card and on the CPU, from the
    same weights and batch; TF32 off.  T = 252, so the region encoders'
    256-token attentions go through the flash kernels on the card, and their
    backward at rate 0 through the split kernels."""
    import copy

    import torch

    from imagined_speech_translation_tpu_torch import _kernels
    from imagined_speech_translation_tpu_torch.cli.profile_slice import synthetic_train_batch
    from imagined_speech_translation_tpu_torch.config import default_config, replace_nested
    from imagined_speech_translation_tpu_torch.training import (
        AdaptiveLossScheduler,
        build_train_module,
        make_loss_fn,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = default_config()
    for path, value in (
        ("data.n_timepoints", 252), ("model.hidden_dim", 64),
        ("model.brain_encoder.hidden_dim", 64), ("model.brain_encoder.fusion_heads", 4),
        ("model.brain_encoder.cross_region_heads", 4),
        ("model.brain_encoder.region_encoder.conv_channels", (16, 16, 32, 32, 64)),
        ("model.brain_encoder.region_encoder.attn_heads", (2, 2, 2)),
        ("model.bart.d_model", 64), ("model.bart.decoder_layers", 2),
        ("model.bart.num_heads", 4), ("model.bart.ffn_dim", 128),
        ("model.bart.vocab_size", 1000), ("training.mixed_precision", False),
        ("training.loss.bow_vocab_size", 16),
    ):
        cfg = replace_nested(cfg, path, value)
    bow = list(range(110, 126))
    module = build_train_module(cfg, len(bow), seed=5, device="cpu")
    batch = {k: v if k == "channel_mask" else v[0]
             for k, v in synthetic_train_batch(cfg, 1, 4, 16, 7).items()}
    weights = AdaptiveLossScheduler(cfg.training.loss).initial_weights()
    out = {}
    for dev, m in (("cpu", module), (DEVICE, copy.deepcopy(module).to(DEVICE))):
        params = dict(m.named_parameters())
        _kernels.reset_launch_counts()
        total, comps = make_loss_fn(m, cfg, bow)(
            params, {k: v.to(dev) for k, v in batch.items()}, None, weights)
        grads = torch.autograd.grad(total, list(params.values()))
        launches = _kernels.launch_counts()
        out[dev] = (torch.stack([total] + list(comps.values())).detach().cpu(),
                    torch.cat([g.flatten() for g in grads]).cpu())
    log(f"[train-card-vs-cpu] card launches: {launches}")
    if not (launches["flash_fwd"] == launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == 5
            and launches["flash_bwd"] == 0):
        raise AssertionError(f"the eval-mode gradient launched {launches}, want 5 flash forward, "
                             "5 split dQ and 5 split dK/dV and no fused backward")
    (l_cpu, g_cpu), (l_card, g_card) = out["cpu"], out[DEVICE]
    loss_rel = ((l_card - l_cpu).abs() / l_cpu.abs()).max().item()
    grad_rel = (torch.linalg.vector_norm(g_card - g_cpu) / torch.linalg.vector_norm(g_cpu)).item()
    n = sum(p.numel() for p in module.parameters())
    log(f"[train-card-vs-cpu] {n / 1e6:.2f}M params f32: loss and components max rel err "
        f"{loss_rel:.3e}, gradient rel err (L2 over all) {grad_rel:.3e} (bound 1e-3 each)")
    if not (loss_rel <= 1e-3 and grad_rel <= 1e-3):
        raise AssertionError(f"train card vs CPU: loss {loss_rel}, grads {grad_rel}")
    return loss_rel, grad_rel


def phase_profile_train(smi: str):
    """The eval-mode gradient at full width through the port's profiling
    entry point, ``cli/profile.py --what train``: ``default_config()``,
    B = 8 (4 if 8 does not fit), T = 1651, float32 weights, one warm-up and
    3 traced iterations.  Every flash attention's backward runs at rate 0,
    so each iteration launches 5 flash forward, 5 split dQ and 5 split dK/dV
    kernels and no fused backward; the last gradients must be finite."""
    import numpy as np
    import torch

    from imagined_speech_translation_tpu_torch import _kernels
    from imagined_speech_translation_tpu_torch.cli import profile

    iters = 3
    for batch in (8, 4):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        try:
            res = profile.main(["--what", "train", "--batch", str(batch), "--iters", str(iters),
                                "--out", "build/profile/smoke_profile_train"])
            break
        except torch.cuda.OutOfMemoryError as e:
            log(f"[profile-train] B={batch} does not fit in float32: {e}")
    else:
        raise AssertionError("profile train: neither B=8 nor B=4 fits in float32")
    launches = _kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    runs = iters + 1  # the warm-up and the traced iterations
    per_iter = {k: n / runs for k, n in launches.items()}
    finite = all(bool(torch.isfinite(g).all()) for g in res["out"])
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in res["out"]]))
    sec = res["seconds"]
    log(f"[profile-train] B={batch} T=1651 f32 eval-mode gradient: {float(np.mean(sec)):.3f} s "
        f"per iteration under the profiler (all {[round(t, 3) for t in sec]}), peak memory "
        f"{peak:.1f} GiB, gradient norm {norm.item():.4e} over {len(res['out'])} tensors "
        f"({'finite' if finite else 'NOT FINITE'}); launches per iteration {per_iter}; "
        f"trace {res['trace']}; on {smi}")
    if not finite:
        raise AssertionError("profile train: non-finite gradients")
    want = {"flash_fwd": 5, "flash_bwd_dq": 5, "flash_bwd_dkv": 5, "flash_bwd": 0}
    if any(launches[k] != n * runs for k, n in want.items()):
        raise AssertionError(f"profile train launched {launches} in {runs} runs, want {want} "
                             "per run")

    # the JAX script's --tiny config (head dims 12, which the kernels take on
    # their CUDA-core variants, and 24, on their 3xTF32 ones), one warm-up
    # and one traced iteration
    _kernels.reset_launch_counts()
    tiny = profile.main(["--what", "train", "--tiny", "--device", "cuda", "--iters", "1",
                         "--out", "build/profile/smoke_profile_train_tiny"])
    tiny_launches = _kernels.launch_counts()
    tiny_finite = all(bool(torch.isfinite(g).all()) for g in tiny["out"])
    log(f"[profile-train] --tiny on the card: {tiny['seconds'][0]:.3f} s, gradients over "
        f"{len(tiny['out'])} tensors {'finite' if tiny_finite else 'NOT FINITE'}, launches "
        f"{tiny_launches}")
    if not tiny_finite or any(tiny_launches[k] != 2 * n for k, n in want.items()):
        raise AssertionError(f"profile train --tiny: finite {tiny_finite}, launched "
                             f"{tiny_launches} in 2 runs, want {want} per run")
    return launches


def _finite_numbers(record: dict, where: str) -> int:
    """Raises unless every number in ``record`` is finite; returns how many
    there were."""
    import math

    n = 0
    for k, v in record.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            if not math.isfinite(v):
                raise AssertionError(f"{where}: {k} = {v}")
            n += 1
    return n


def _assert_states_equal(a, b) -> int:
    """Raises unless two train states hold the same step, optimizer count,
    loss weights and tensors (parameters, BatchNorm statistics, both
    moments), bit for bit; returns the tensor count."""
    import torch

    if (a.step, a.opt_state.count, a.loss_weights) != (b.step, b.opt_state.count, b.loss_weights):
        raise AssertionError(f"restored step/count/weights {a.step} {a.opt_state.count} "
                             f"{a.loss_weights} != {b.step} {b.opt_state.count} {b.loss_weights}")
    n = 0
    for what, x, y in (("module", a.module.state_dict(), b.module.state_dict()),
                       ("mu", a.opt_state.mu, b.opt_state.mu),
                       ("nu", a.opt_state.nu, b.opt_state.nu)):
        if set(x) != set(y):
            raise AssertionError(f"restored {what} keys differ")
        for k in x:
            if x[k].dtype != y[k].dtype or not torch.equal(x[k], y[k]):
                raise AssertionError(f"restored {what}.{k} differs from the live state")
            n += 1
    return n


def phase_trainer(smi: str, tmp):
    """The trainer path at full width through the port's entry points: a
    synthetic corpus of 10 files x 8 windows of 125 channels x 1651 samples
    (seed 0; split 64 / 8 / 8) and ``default_config()`` (mixed precision)
    with 2 epochs, an evaluation and a checkpoint every epoch, one epoch
    checkpoint kept.  (a) ``cli.train``: 2 epochs of 2 windows (8
    micro-steps of 4), each followed by an evaluation of the 8 validation
    windows, then the test evaluation; (b) ``cli.train --resume`` with 3
    epochs: it resumes from ``checkpoint_epoch_2`` at epoch 2 and trains one;
    (c) ``cli.evaluate`` of ``checkpoint_epoch_3`` on the test split.
    Checks: every logged number finite; steps 4 and 6; exact launch counts
    (5 flash forward and 5 fused backward a micro-step, 5 + 5 flash forward
    an evaluation batch: the eval step's encoder and beam search's encode;
    no split backward, no IIR); the last checkpoint restored into a fresh
    state equals the live state bit for bit; (c) equals (b)'s test
    evaluation of the same weights on the same windows (losses within 1e-6
    relative, predictions identical): the trainer, as the JAX one, evaluates
    augmented windows while augmentation is on, and the evaluate CLI plain
    ones, so (c) is held to (b)'s trainer evaluating the plain test windows.
    wandb is disabled for the run.  ``tmp`` is the caller's scratch
    directory (under ``build/``): the corpus, ``montage.csv``, ``vocab.txt``
    and ``out/checkpoints/checkpoint_epoch_3`` stay there for the server
    phase."""
    import json
    import os
    import shutil

    import numpy as np
    import torch

    from imagined_speech_translation_tpu_torch import _kernels
    from imagined_speech_translation_tpu_torch.cli import evaluate as evaluate_cli
    from imagined_speech_translation_tpu_torch.cli import train as train_cli
    from imagined_speech_translation_tpu_torch.config import default_config
    from imagined_speech_translation_tpu_torch.training import CheckpointManager, EEGTrainer

    cfg = default_config()
    tc = cfg.training
    micro_steps = tc.grad_accum_steps  # a window is 8 micro-steps of 4
    evals, saves = [], []
    evaluate, save = EEGTrainer.evaluate, CheckpointManager._save

    def timed_evaluate(self, state, *, epoch=0):
        t0 = time.perf_counter()
        out = evaluate(self, state, epoch=epoch)
        evals.append(time.perf_counter() - t0)
        return out

    def timed_save(self, name, state, meta):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(self, name, state, meta)
        nbytes = sum(p.stat().st_size for p in (self.dir / name).iterdir())
        saves.append((name, time.perf_counter() - t0, nbytes))

    EEGTrainer.evaluate, CheckpointManager._save = timed_evaluate, timed_save
    # get_logger mirrors to wandb where it is installed, and wandb.init
    # reaches for the network: this run logs to metrics.jsonl only
    wandb_mode = os.environ.get("WANDB_MODE")
    os.environ["WANDB_MODE"] = "disabled"
    try:
        args = _trainer_corpus(tmp)
        free = shutil.disk_usage(tmp).free / 2**30
        for s in ("training.num_epochs=2", "training.eval_interval_epochs=1",
                  "training.checkpoint.save_interval_epochs=1",
                  "training.checkpoint.max_to_keep=1"):
            args += ["--set", s]
        out = tmp / "out"
        log(f"[trainer] corpus of 80 windows (125 x 1651, seed 0) in {tmp} "
            f"({free:.0f} GiB free); default_config(), mixed precision "
            f"{tc.mixed_precision}, accum {micro_steps} x {tc.batch_size}")

        def drive(tag, fn, argv):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res = fn(argv)
            torch.cuda.synchronize()
            launches = _kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            log(f"[trainer] ({tag}) {time.perf_counter() - t0:.1f} s, peak memory "
                f"{peak:.1f} GiB, launches {launches}")
            return res, launches, peak

        def want_launches(tag, launches, windows, eval_batches):
            want = dict(sosfilt=0, flash_fwd=5 * micro_steps * windows + 10 * eval_batches,
                        flash_bwd=5 * micro_steps * windows, flash_bwd_dq=0, flash_bwd_dkv=0,
                        dropout_mask=0)
            if launches != want:
                raise AssertionError(f"trainer ({tag}) launched {launches}, want {want}")

        a, la, peak_a = drive("a", train_cli.main, args + ["--out-dir", str(out)])
        if a["state"].step != 4:
            raise AssertionError(f"(a) ended at step {a['state'].step}, want 4")
        # 2 epochs x 2 windows; 2 validation evaluations + the test one, 1 batch each
        want_launches("a", la, windows=4, eval_batches=3)
        n_evals_a, saves_a = len(evals), list(saves)
        del a
        torch.cuda.empty_cache()

        b, lb, peak_b = drive("b", train_cli.main, args + [
            "--out-dir", str(out), "--resume", "--set", "training.num_epochs=3"])
        trainer, live = b["trainer"], b["state"]
        if trainer.start_epoch != 2 or live.step != 6:
            raise AssertionError(f"(b) resumed at epoch {trainer.start_epoch} and ended at "
                                 f"step {live.step}, want epoch 2 and step 6")
        want_launches("b", lb, windows=2, eval_batches=2)
        ckpts = sorted(p.name for p in (out / "checkpoints").iterdir())
        if "checkpoint_epoch_3" not in ckpts or "checkpoint_epoch_2" in ckpts:
            raise AssertionError(f"checkpoints after (b): {ckpts}")

        rows = [json.loads(line) for line in (out / "metrics.jsonl").open()]
        numbers = sum(_finite_numbers(r, f"metrics.jsonl line {i}") for i, r in enumerate(rows))
        _finite_numbers(b["test_metrics"], "(b) test metrics")
        sps = [r["train/samples_per_sec"] for r in rows if "train/samples_per_sec" in r]
        losses = [r["train/loss"] for r in rows if "train/loss" in r]
        val = [r["val/val_loss"] for r in rows if "val/val_loss" in r]
        log(f"[trainer] metrics.jsonl: {len(rows)} lines, {numbers} numbers, all finite; "
            f"train/loss at the logged steps {[round(x, 4) for x in losses]}; val_loss "
            f"{[round(x, 4) for x in val]}; train/samples_per_sec by epoch "
            f"{[round(x, 2) for x in sps]} (epoch 0 of (a) includes first calls)")

        t0 = time.perf_counter()
        fresh = trainer.init_state(seed=1)
        restored, _ = trainer.ckpt.restore("checkpoint_epoch_3", fresh)
        n_tensors = _assert_states_equal(restored, live)
        log(f"[trainer] checkpoint_epoch_3 restored into a fresh state in "
            f"{time.perf_counter() - t0:.1f} s: {n_tensors} tensors, step {restored.step}, "
            f"loss weights equal to the live state's, bit for bit")
        # the trainer evaluates the windows its dataset gives, augmented as
        # the JAX trainer's are when augmentation is on; cli.evaluate reads
        # them plain: (c) is held to the trainer's evaluation of the same
        # weights on the plain windows
        test_aug = b["test_metrics"]
        trainer.dataset.augment = False
        test_b = trainer.evaluate(live)
        del b, trainer, live, fresh, restored
        torch.cuda.empty_cache()

        c, lc, peak_c = drive("c", evaluate_cli.main, args + [
            "--checkpoint", str(out / "checkpoints" / "checkpoint_epoch_3"), "--split", "test"])
        want_launches("c", lc, windows=0, eval_batches=1)
        _finite_numbers(c, "(c) metrics")
        rel = {k: abs(c[k] - test_b[k]) / max(abs(test_b[k]), 1e-30)
               for k in ("val_loss", "loss_ce", "loss_align", "loss_bow", "loss_div", "loss_var")}
        if max(rel.values()) > 1e-6 or c["predictions"] != test_b["predictions"]:
            raise AssertionError(f"cli.evaluate differs from the trainer's test evaluation: "
                                 f"rel {rel}, predictions {c['predictions']} vs "
                                 f"{test_b['predictions']}")
        log(f"[trainer] (c) cli.evaluate agrees with the trainer's test evaluation on the "
            f"plain windows: max rel err of the losses {max(rel.values()):.2e}, "
            f"{len(c['predictions'])} predictions identical, bleu_4 {c['bleu_4']}, "
            f"diversity {c['diversity_score']}")
        gap = {k: abs(c[k] - test_aug[k]) / max(abs(test_aug[k]), 1e-30) for k in rel}
        log(f"[trainer] (b)'s own test evaluation (augmented windows) lies {gap} from (c); "
            f"predictions {'identical' if c['predictions'] == test_aug['predictions'] else 'differ'}")

        ev = np.array(evals)
        log(f"[trainer] on {smi}: (a) train/samples_per_sec {sps[0]:.2f} (epoch 0), "
            f"{sps[1]:.2f} (epoch 1); (b) {sps[2]:.2f}; an evaluation of 8 windows "
            f"{ev.min():.3f}-{ev.max():.3f} s over {len(ev)} ({n_evals_a} in (a), all "
            f"{ev.round(3).tolist()}); a save "
            f"{', '.join(f'{n} {s:.2f} s {nb / 1e9:.3f} GB' for n, s, nb in saves)} "
            f"({len(saves_a)} in (a)); peak memory {peak_a:.1f} / {peak_b:.1f} / "
            f"{peak_c:.1f} GiB in (a) / (b) / (c)")
        return {k: la[k] + lb[k] + lc[k] for k in la}
    finally:
        EEGTrainer.evaluate, CheckpointManager._save = evaluate, save
        if wandb_mode is None:
            os.environ.pop("WANDB_MODE", None)
        else:
            os.environ["WANDB_MODE"] = wandb_mode


def build_recorded(fargs: dict):
    """``cli.serve.build_decode_fn_from_args(**fargs)`` and the tokenizer it
    built, which records the ids of every batch."""
    from imagined_speech_translation_tpu_torch.cli import serve

    Recording, plain = recording_tokenizer_class(), serve.ChineseCharTokenizer
    serve.ChineseCharTokenizer = Recording
    try:
        decode_fn = serve.build_decode_fn_from_args(**fargs)
    finally:
        serve.ChineseCharTokenizer = plain
    return decode_fn, Recording.instances[-1]


SESSIONS, WINDOWS_EACH, FRAME = 16, 2, 250  # FRAME samples: 0.5 s at 500 Hz


def phase_server(smi: str, tmp):
    """12. The serving entry point on the trainer phase's last checkpoint
    (``tmp/out/checkpoints/checkpoint_epoch_3``, its ``vocab.txt`` and
    125-channel ``montage.csv``), at full width: ``default_config()`` with
    beam 3 pinned to length 16, BatchNorm folded, bf16.  The decode function
    comes from ``cli.serve.build_decode_fn_from_args`` (the checkpoint loads
    strictly), the service from ``cli.serve.build_service`` as ``main``
    wires it: one ``BatchScheduler`` (max batch 16, 25 ms deadline) shared by
    a ``BatchingDecodePipeline`` a session, and the command table with
    ``latency``.  16 sessions, each authenticated by a text frame, stream 2
    windows each (hop = window) as ``eeg`` frames of 125 x 250 float32
    samples, concurrently through ``handle_binary``, then ``eeg_end``.
    Checks: 32 utterances, each session's 2 in order; 1 ``sosfilt`` and 5
    ``flash_fwd`` launches per decode batch of the scheduler and no other
    kernel; each window's ids equal those of ``decode_fn`` called directly
    on a batch of the same 16 windows; ``latency`` answers with the
    scheduler's stats; the same windows rounded to float16 decode to
    identical ids through the float16 wire; a ``DecodeWorker`` child
    (``functools.partial`` of ``build_decode_fn_from_args``) answers a batch
    as in-process decoding does, and again after one forced recycle.  A
    second round, 16 new sessions on the same samples, must give the same
    utterances and launch counts; it is timed beside the first, whose first
    batch also starts the scheduler's decode thread.  Returns the first
    round's launches."""
    import asyncio
    import functools

    import numpy as np
    import torch

    from imagined_speech_translation_tpu_torch import _kernels
    from imagined_speech_translation_tpu_torch.cli import serve
    from imagined_speech_translation_tpu_torch.config import default_config, replace_nested
    from imagined_speech_translation_tpu_torch.runtime.worker import DecodeWorker, _rss_mb

    cfg = default_config()
    cfg = replace_nested(cfg, "generation.min_length", cfg.generation.max_length)
    T = cfg.data.n_timepoints
    (tmp / "serve_config.json").write_text(cfg.to_json())
    ckpt = tmp / "out" / "checkpoints" / "checkpoint_epoch_3"
    fargs = dict(vocab=str(tmp / "vocab.txt"), montage=str(tmp / "montage.csv"),
                 config=str(tmp / "serve_config.json"), checkpoint=str(ckpt), device="cuda",
                 compute_dtype="bfloat16", max_batch=SESSIONS)
    t_phase = time.perf_counter()
    decode_fn, tok = build_recorded(fargs)
    log(f"[server] decode function from {ckpt.name} (strict load, BN folded, bf16) built and "
        f"warmed in {time.perf_counter() - t_phase:.1f} s")

    rng = np.random.default_rng(12)
    eeg = rng.normal(size=(SESSIONS, 125, WINDOWS_EACH * T)).astype(np.float32)
    windows = [[eeg[i][:, k * T:(k + 1) * T] for k in range(WINDOWS_EACH)]
               for i in range(SESSIONS)]
    batches, decode_s = [], []

    def recorded(batch):
        batches.append(np.array(batch))
        t0 = time.perf_counter()
        out = decode_fn(batch)  # ends in a copy to the host
        decode_s.append(time.perf_counter() - t0)
        return out

    service, scheduler = serve.build_service(recorded, n_channels=125, window=T,
                                             max_batch=SESSIONS, max_delay_ms=25)

    async def session(i, user):
        key = json.loads((await service.handle_text(f"authentication¬user{user}")).split("¬")[2])
        head, out = b"eeg|" + key.encode() + b"|", []
        for start in range(0, eeg.shape[2], FRAME):
            frame = np.ascontiguousarray(eeg[i][:, start:start + FRAME])
            out += await service.handle_binary(head + frame.tobytes())
        out += await service.handle_binary(b"eeg_end|" + key.encode() + b"|")
        return key, out

    async def one_round(first_user):
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = await asyncio.gather(*(session(i, first_user + i) for i in range(SESSIONS)))
        return res, time.perf_counter() - t0, _kernels.launch_counts(), scheduler.batches

    async def run():
        # round A is the checked one; round B, 16 new sessions on the same
        # samples, shows the service once its decode thread is warm
        async with scheduler:
            a = await one_round(0)
            b = await one_round(SESSIONS)
            return a, b, await service.handle_text(f"latency¬{a[0][0][0]}")

    n0 = len(tok.history)
    torch.cuda.synchronize()
    (res, wall, launches, n_batches), (res_b, wall_b, launches_b, n_all), latency = \
        asyncio.run(run())
    service_ids = tok.history[n0:n0 + n_batches]
    texts = [out for _, out in res]
    fills = list(scheduler.fills)
    log(f"[server] {SESSIONS} sessions x {WINDOWS_EACH} windows in frames of {FRAME} samples: "
        f"{sum(map(len, texts))} utterances in {wall:.3f} s, {n_batches} decode batches (fills "
        f"{fills[:n_batches]}), launches {launches}; round B: {wall_b:.3f} s, "
        f"{n_all - n_batches} batches (fills {fills[n_batches:]}), launches {launches_b}")
    if [len(t) for t in texts] != [WINDOWS_EACH] * SESSIONS:
        raise AssertionError(f"utterances per session: {[len(t) for t in texts]}")
    if [out for _, out in res_b] != texts:
        raise AssertionError("round B's sessions got other utterances than round A's")
    for got, n in ((launches, n_batches), (launches_b, n_all - n_batches)):
        want = dict(sosfilt=n, flash_fwd=5 * n, flash_bwd=0, flash_bwd_dq=0, flash_bwd_dkv=0,
                    dropout_mask=0)
        if got != want:
            raise AssertionError(f"the service launched {got} over {n} batches, want {want}")
    if len(service_ids) != n_batches:
        raise AssertionError(f"{len(service_ids)} id batches decoded over {n_batches} batches")

    # each window's ids: from the service's batch, and from decode_fn called
    # directly on a batch of the same 16 windows (the k-th of each session)
    where = {}
    for j, (batch, fill) in enumerate(zip(batches[:n_batches], fills)):
        for r in range(fill):
            hit = [(i, k) for i in range(SESSIONS) for k in range(WINDOWS_EACH)
                   if np.array_equal(batch[r], windows[i][k])]
            if len(hit) != 1:
                raise AssertionError(f"batch {j} row {r} is no single session window: {hit}")
            where[hit[0]] = service_ids[j][r]
    direct_texts, direct_ids = [], []
    for k in range(WINDOWS_EACH):
        direct_texts.append(decode_fn(np.stack([windows[i][k] for i in range(SESSIONS)])))
        direct_ids.append(tok.ids)
    differ = [(i, k) for i in range(SESSIONS) for k in range(WINDOWS_EACH)
              if not np.array_equal(where[(i, k)], direct_ids[k][i])]
    if len(where) != SESSIONS * WINDOWS_EACH or differ:
        raise AssertionError(f"windows whose service ids differ from the direct decode's: "
                             f"{differ} of {len(where)}")
    in_order = [[direct_texts[k][i] for k in range(WINDOWS_EACH)] for i in range(SESSIONS)]
    if texts != in_order:
        raise AssertionError("a session's utterances are not its windows' texts in order")
    log(f"[server] every window's ids equal decode_fn's on a batch of the same 16 windows; "
        f"each session's utterances in order; session 0: {texts[0][0][:40]!r}")

    command, name, body = latency.split("¬")
    pooled = json.loads(body).get("pooled", {})
    if (command, name) != ("ok", "latency") or pooled.get("count") != 2 * len(where) \
            or pooled.get("batches") != n_all:
        raise AssertionError(f"latency command answered {latency!r}")
    lat = np.array(scheduler.latency.samples_ms)  # in order: round A's, then B's
    n = len(where)
    for tag, ms, secs, dec in (("round A (the service's first batches)", lat[:n], wall,
                                decode_s[:n_batches]),
                               ("round B", lat[n:], wall_b, decode_s[n_batches:n_all])):
        log(f"[server] on {smi}: {tag}: {n / secs:.2f} windows/s through the service ({n} "
            f"windows, {secs:.3f} s); window-to-utterance latency p50 "
            f"{np.percentile(ms, 50):.1f} ms, p99 {np.percentile(ms, 99):.1f} ms (LatencyStats: "
            f"min {ms.min():.1f}, max {ms.max():.1f}); decode_fn per batch "
            f"{[round(s, 4) for s in dec]} s")
    log(f"[server] latency command: {pooled}")

    # the float16 wire: windows exact in float16 give identical ids
    w16 = np.stack([windows[i][0] for i in range(SESSIONS)]).astype(np.float16)
    w16 = w16.astype(np.float32)
    decode_fn(w16)
    ids32 = tok.ids
    decode16, tok16 = build_recorded(dict(fargs, transfer_dtype="float16"))
    decode16(w16)
    if not np.array_equal(tok16.ids, ids32):
        raise AssertionError("the float16 wire decodes other ids than the float32 wire")
    log("[server] float16 wire: 16 windows rounded to float16 decode to identical ids")
    del decode16, tok16
    torch.cuda.empty_cache()

    # the decode function in a recycled child process
    batch0 = np.stack([windows[i][0] for i in range(SESSIONS)])
    want_texts = decode_fn(batch0)
    worker = DecodeWorker(functools.partial(serve.build_decode_fn_from_args, **fargs),
                          rss_budget_mb=1e9, check_every=1)
    try:
        t0 = time.perf_counter()
        worker.start()
        start_s = time.perf_counter() - t0
        rss = _rss_mb(worker._proc.pid)
        pid0 = worker._proc.pid
        if worker(batch0) != want_texts:
            raise AssertionError("the decode worker's child answers otherwise than in-process")
        worker.rss_budget_mb = 1.0  # below the child's RSS: this call recycles it
        t0 = time.perf_counter()
        again = worker(batch0)
        recycle_s = time.perf_counter() - t0
        worker.rss_budget_mb = 1e9
        after = worker(batch0)
        if worker.recycles != 1 or worker._proc.pid == pid0 or again != want_texts \
                or after != want_texts:
            raise AssertionError(f"decode worker after a forced recycle: {worker.stats()}")
        stats = worker.stats()
    finally:
        worker.stop()
    log(f"[server] on {smi}: decode worker child started (built, loaded, warmed) in "
        f"{start_s:.1f} s, RSS {rss:.0f} MB; a batch with a forced recycle {recycle_s:.1f} s; "
        f"answers equal in-process decoding before and after ({stats})")
    log(f"[server] phase {time.perf_counter() - t_phase:.1f} s on {smi}")
    return launches


# the graft phase's tokenizer has bert-base-chinese's 21128 tokens, fewer
# than the checkpoint's 51271, so the vocabulary rows are overlap-copied
GRAFT_VOCAB = 21128


def seeded_hf_bart(bart_cfg, seed: int = 0) -> dict:
    """A ``BartForConditionalGeneration`` state dict under HF's names at
    ``bart_cfg``'s widths, random values from ``seed``: weights and biases
    N(0, 0.02^2), LayerNorm scales 1 + N(0, 0.02^2), a nonzero
    ``final_logits_bias`` of shape (1, V), and two encoder tensors for the
    converter to drop."""
    import torch

    from imagined_speech_translation_tpu_torch.models.hf_convert import LAYER_PARTS

    g = torch.Generator().manual_seed(seed)
    d, f, v = bart_cfg.d_model, bart_cfg.ffn_dim, bart_cfg.vocab_size
    positions = bart_cfg.max_position_embeddings + bart_cfg.position_offset

    def normal(*shape, mean=0.0):
        return torch.randn(shape, generator=g) * 0.02 + mean

    def shape_of(part):
        name, w = part.rsplit(".", 1)
        if name == "fc1":
            return (f, d) if w == "weight" else (f,)
        if name == "fc2":
            return (d, f) if w == "weight" else (d,)
        return (d, d) if w == "weight" and name.endswith("proj") else (d,)

    sd = {"model.shared.weight": normal(v, d),
          "model.decoder.embed_positions.weight": normal(positions, d),
          "model.decoder.layernorm_embedding.weight": normal(d, mean=1.0),
          "model.decoder.layernorm_embedding.bias": normal(d),
          "model.encoder.embed_positions.weight": normal(positions, d),
          "model.encoder.layers.0.fc1.weight": normal(f, d),
          "final_logits_bias": normal(1, v)}
    for i in range(bart_cfg.decoder_layers):
        for part in LAYER_PARTS:
            sd[f"model.decoder.layers.{i}.{part}"] = normal(
                *shape_of(part), mean=1.0 if part.endswith("norm.weight") else 0.0)
    return sd


def write_safetensors(path, tensors: dict) -> None:
    """Float32 CPU ``tensors`` as a ``.safetensors`` file: an 8-byte
    little-endian header length, a JSON header padded to 8 bytes, then the
    raw buffers in order."""
    import struct

    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * 4
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(raw)))
        fh.write(raw)
        for t in tensors.values():
            fh.write(t.contiguous().numpy().tobytes())


def phase_graft(smi: str, tmp):
    """13. The pretrained-decoder path at full width, in the trainer phase's
    scratch directory (its corpus and montage).  (a) A seeded HF-layout
    checkpoint at ``fnlp/bart-base-chinese``'s widths (vocab 51271, d 768, 6
    decoder layers, 12 heads, ffn 3072, 512 + 2 positions; ~0.4 GB float32),
    written as ``pytorch_model.bin`` and, by hand, as ``model.safetensors``;
    (b) ``cli.convert_hf.main`` on each: the two outputs equal bit for bit
    and equal the checkpoint's decoder tensors, the encoder dropped; (c)
    ``graft_bart_params`` into a fresh ``EEGTrainer.init_state`` whose
    tokenizer has 21128 tokens: the vocabulary rows are overlap-copied,
    every ``bart.*`` parameter holds the checkpoint's values (its first
    rows), every other parameter its fresh value, each in the tensor the
    optimizer was built over; then two optimizer steps (5 flash forward and
    5 fused backward launches a micro-step): the first, at learning rate 0,
    leaves the grafted values, the second moves them; (e)
    ``build_bart_generate_fn`` on that grafted decoder in float32 at B = 16,
    beam 3 and greedy, on seeded random encoder states (S = 6) with one
    position masked: ids equal a search that recomputes cross-attention
    every step (no ``cross_kvs``); ms a call; (d) ``cli.train --bart-params``
    for one epoch (2 windows, an evaluation, the test evaluation, no epoch
    checkpoint) with wandb disabled: finite metrics, a decoder weight near
    the checkpoint's, 5 flash forward and 5 fused backward launches a
    micro-step and 10 flash forward an evaluation batch.  Returns (d)'s
    launches."""
    import os

    import numpy as np
    import torch

    from imagined_speech_translation_tpu_torch import _kernels
    from imagined_speech_translation_tpu_torch.cli import convert_hf
    from imagined_speech_translation_tpu_torch.cli import train as train_cli
    from imagined_speech_translation_tpu_torch.cli.profile_slice import synthetic_vocab
    from imagined_speech_translation_tpu_torch.config import default_config, replace_nested
    from imagined_speech_translation_tpu_torch.data import (
        ChineseCharTokenizer,
        EEGTextDataset,
        split_indices,
    )
    from imagined_speech_translation_tpu_torch.decode import (
        DecodeParams,
        beam_search,
        build_bart_generate_fn,
        greedy_search,
    )
    from imagined_speech_translation_tpu_torch.training import EEGTrainer
    from imagined_speech_translation_tpu_torch.training.pretrained import graft_bart_params
    from imagined_speech_translation_tpu_torch.training.trainer import window_generator

    t_phase = time.perf_counter()
    cfg = default_config()
    bart_cfg = cfg.model.bart
    work = tmp / "graft"
    (work / "bin").mkdir(parents=True)
    (work / "st").mkdir()
    # (a) the checkpoint in both formats
    t0 = time.perf_counter()
    hf = seeded_hf_bart(bart_cfg, seed=0)
    torch.save(hf, work / "bin" / "pytorch_model.bin")
    write_safetensors(work / "st" / "model.safetensors", hf)
    nbytes = (work / "st" / "model.safetensors").stat().st_size
    log(f"[graft] (a) seeded HF-layout checkpoint: {len(hf)} tensors, "
        f"{sum(t.numel() for t in hf.values()) / 1e6:.1f}M values, {nbytes / 1e9:.3f} GB, "
        f"written as .bin and .safetensors in {time.perf_counter() - t0:.1f} s")
    # (b) both conversions
    outs = {}
    for fmt in ("bin", "st"):
        t0 = time.perf_counter()
        convert_hf.main(["--checkpoint", str(work / fmt), "--out", str(work / f"{fmt}.pt")])
        outs[fmt] = torch.load(work / f"{fmt}.pt", weights_only=True)
        log(f"[graft] (b) cli.convert_hf of the {fmt} file: {len(outs[fmt])} tensors in "
            f"{time.perf_counter() - t0:.1f} s")
    conv = outs["st"]
    if set(conv) != set(outs["bin"]) or any(
            conv[k].dtype != outs["bin"][k].dtype or not torch.equal(conv[k], outs["bin"][k])
            for k in conv):
        raise AssertionError("the .safetensors and .bin conversions differ")
    last = bart_cfg.decoder_layers - 1
    for ours, theirs in (("shared.weight", "model.shared.weight"),
                         (f"layer{last}.fc2.weight", f"model.decoder.layers.{last}.fc2.weight"),
                         ("embed_positions", "model.decoder.embed_positions.weight")):
        if not torch.equal(conv[ours], hf[theirs]):
            raise AssertionError(f"converted {ours} differs from the checkpoint's {theirs}")
    if not torch.equal(conv["final_logits_bias"], hf["final_logits_bias"][0]) or any(
            "encoder." in k for k in conv):
        raise AssertionError("final_logits_bias or the dropped encoder converted wrongly")
    log(f"[graft] (b) the two conversions are equal bit for bit ({len(conv)} tensors), "
        f"the encoder dropped, spot tensors equal the checkpoint's")
    del hf, outs

    # (c) the graft through the library
    (work / "vocab.txt").write_text("\n".join(synthetic_vocab(GRAFT_VOCAB)) + "\n",
                                    encoding="utf-8")
    tok = ChineseCharTokenizer.from_vocab_file(work / "vocab.txt")
    gcfg = replace_nested(cfg, "model.bart.vocab_size", tok.vocab_size)
    tc = gcfg.training
    ds = EEGTextDataset(str(tmp / "data"), str(tmp / "montage.csv"), tok, gcfg.data,
                        augment=False, seed=tc.seed)
    train_idx, val_idx, _ = split_indices(
        len(ds), (gcfg.data.train_split, gcfg.data.val_split, gcfg.data.test_split), tc.seed)
    trainer = EEGTrainer(gcfg, ds, tok, bow_indices=train_cli.corpus_bow_indices(
        ds, train_idx, tok, tc.loss.bow_vocab_size), train_indices=train_idx,
        val_indices=val_idx, checkpoint_dir=str(work / "ckpt"), device="cuda")
    t0 = time.perf_counter()
    state = trainer.init_state(tc.seed)
    params = dict(state.module.named_parameters())
    fresh = {k: p.detach().clone() for k, p in params.items()}
    graft_bart_params(state, work / "st.pt")
    torch.cuda.synchronize()
    t_graft = time.perf_counter() - t0
    overlap, n_bart = 0, 0
    for k, p in state.module.named_parameters():
        if p is not params[k]:
            raise AssertionError(f"{k} is a new tensor: the optimizer would step the old one")
        if k.startswith("model.bart."):
            src = conv[k[len("model.bart."):]].to(p.device)
            n = min(src.shape[0], p.shape[0])
            if not torch.equal(p[:n], src[:n]) or not torch.equal(p[n:], fresh[k][n:]):
                raise AssertionError(f"{k}: not the checkpoint's first {n} rows")
            overlap += src.shape != p.shape
            n_bart += 1
        elif not torch.equal(p, fresh[k]):
            raise AssertionError(f"{k} changed: the graft touches only model.bart.*")
    if overlap != 2:  # shared.weight and final_logits_bias
        raise AssertionError(f"{overlap} tensors overlap-copied, want 2")
    grafted = {k: p.detach().clone() for k, p in params.items() if k.startswith("model.bart.")}
    log(f"[graft] (c) init_state + graft in {t_graft:.1f} s: {n_bart} bart tensors from the "
        f"checkpoint ({overlap} overlap-copied, {bart_cfg.vocab_size} -> {tok.vocab_size} "
        f"rows), {len(params) - n_bart} others at their fresh values, all in place")
    micro = tc.grad_accum_steps
    batches = trainer._train_batches(0)
    for i in range(2):
        _kernels.reset_launch_counts()
        state, metrics = trainer._train_step(state, trainer._to_device(next(batches)),
                                             window_generator(tc.seed, 0, i))
        torch.cuda.synchronize()
        launches = _kernels.launch_counts()
        if (launches["flash_fwd"], launches["flash_bwd"]) != (5 * micro, 5 * micro):
            raise AssertionError(f"(c) step {i} launched {launches}")
        loss = float(metrics["loss"])
        moved = sum(not torch.equal(params[k], v) for k, v in grafted.items())
        if not np.isfinite(loss) or (moved != 0 if i == 0 else moved < n_bart // 2):
            raise AssertionError(f"(c) step {i}: loss {loss}, {moved} bart tensors moved")
        log(f"[graft] (c) step {i}: loss {loss:.4f}, {moved} of {n_bart} grafted tensors "
            f"moved, launches {launches}")
    decoder = state.module.model.bart

    # (e) generation from encoder states on the grafted decoder
    rng = np.random.default_rng(0)
    enc = torch.from_numpy(rng.normal(size=(16, 6, bart_cfg.d_model)).astype(np.float32)).cuda()
    mask = torch.ones((16, 6), dtype=torch.int32, device="cuda")
    mask[:, 4] = 0
    for k in (3, 1):
        dp = DecodeParams(max_length=16, min_length=4, num_beams=k,
                          pad_token_id=tok.pad_token_id, eos_token_id=tok.sep_token_id,
                          decoder_start_token_id=tok.bos_token_id)
        gen = build_bart_generate_fn(decoder, dp)
        enc_x, mask_x = enc.repeat_interleave(k, 0), mask.repeat_interleave(k, 0)
        search = beam_search if k > 1 else greedy_search

        @torch.inference_mode()
        def unhoisted():
            return search(lambda t, pos, c: decoder(t, enc_x, mask_x, positions=pos, caches=c),
                          decoder.init_cache(16 * k, 16, device="cuda"), 16, dp, device="cuda")

        ids = gen(enc, mask)
        if ids.shape != (16, 16) or not torch.equal(ids, unhoisted()):
            raise AssertionError(f"(e) beam {k}: hoisted ids differ from the plain search's")
        ms, ms_plain = cuda_ms(lambda: gen(enc, mask), 3, 1), cuda_ms(unhoisted, 3, 1)
        log(f"[graft] (e) build_bart_generate_fn {'beam 3' if k > 1 else 'greedy'}, B = 16, "
            f"S = 6 with one position masked, f32: ids equal the search without cross_kvs "
            f"({len(set(ids.flatten().tolist()))} distinct ids); {ms:.1f} ms a call, "
            f"{ms_plain:.1f} ms without the hoist, on {smi}")
    del state, params, fresh, grafted, decoder, trainer, metrics, batches
    torch.cuda.empty_cache()

    # (d) the entry point
    wandb_mode = os.environ.get("WANDB_MODE")
    os.environ["WANDB_MODE"] = "disabled"
    try:
        args = ["--data-dir", str(tmp / "data"), "--montage", str(tmp / "montage.csv"),
                "--vocab", str(work / "vocab.txt"), "--device", "cuda",
                "--out-dir", str(work / "out"), "--bart-params", str(work / "st.pt")]
        for s in ("training.num_epochs=1", "training.eval_interval_epochs=1",
                  "training.checkpoint.save_interval_epochs=100"):
            args += ["--set", s]
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = train_cli.main(args)
        torch.cuda.synchronize()
        launches = _kernels.launch_counts()
        t_d = time.perf_counter() - t0
    finally:
        if wandb_mode is None:
            os.environ.pop("WANDB_MODE", None)
        else:
            os.environ["WANDB_MODE"] = wandb_mode
    # 1 epoch of 2 windows; the validation and the test evaluation, 1 batch each
    want = dict(sosfilt=0, flash_fwd=5 * micro * 2 + 10 * 2, flash_bwd=5 * micro * 2,
                flash_bwd_dq=0, flash_bwd_dkv=0, dropout_mask=0)
    if launches != want or res["state"].step != 2:
        raise AssertionError(f"(d) launched {launches} (want {want}), step {res['state'].step}")
    rows = [json.loads(line) for line in (work / "out" / "metrics.jsonl").open()]
    numbers = sum(_finite_numbers(r, f"(d) metrics.jsonl line {i}") for i, r in enumerate(rows))
    _finite_numbers(res["test_metrics"], "(d) test metrics")
    w = res["state"].module.model.bart.get_parameter(f"layer{last}.fc1.weight").detach()
    to_ckpt = (w - conv[f"layer{last}.fc1.weight"].cuda()).abs().max().item()
    if not to_ckpt < 1e-2:  # two AdamW steps from the grafted weights
        raise AssertionError(f"(d) layer{last}.fc1 lies {to_ckpt} from the checkpoint's")
    losses = [round(r["train/loss"], 4) for r in rows if "train/loss" in r]
    sps = [round(r["train/samples_per_sec"], 2) for r in rows if "train/samples_per_sec" in r]
    log(f"[graft] (d) cli.train --bart-params, 1 epoch: {t_d:.1f} s, train/loss {losses}, "
        f"train/samples_per_sec {sps}, {numbers} logged numbers all finite, test val_loss "
        f"{res['test_metrics']['val_loss']:.4f}, layer{last}.fc1 within {to_ckpt:.2e} of the "
        f"checkpoint's, launches {launches}")
    log(f"[graft] phase {time.perf_counter() - t_phase:.1f} s on {smi}")
    return launches


def phase_reproduce(smi: str, tmp):
    """13b. ``cli.reproduce`` on the graft phase's seeded HF-layout checkpoint
    (``fnlp/bart-base-chinese``'s widths; its ``model.safetensors`` linked
    into a directory with a ``config.json`` of those widths) and the trainer
    corpus, on the card: (a) ``--dry-run`` exits 0 with the plan's five
    steps; (b) with no local artifacts and ``probe_egress`` replaced by a
    failing probe in-process (no network, no timeout), exit 3 and one
    ``blocked`` / ``no-egress`` JSON line; (c) the local chain on ``--device
    cuda``: ``cli.convert_hf`` (one ``torch.save`` file, equal to the graft
    phase's conversion), then ``parity_report``, greedy and beam 3 on six
    seeds against HF ``generate`` on the CPU in float32, identity 1.0.
    ``--train`` is not run here (the config's full epoch count); the graft
    phase runs ``cli.train --bart-params``.  Returns (c)'s launches."""
    t_phase = time.perf_counter()  # transformers' import included
    import io
    import os

    import torch
    import transformers

    from imagined_speech_translation_tpu_torch import _kernels
    from imagined_speech_translation_tpu_torch.cli import reproduce
    from imagined_speech_translation_tpu_torch.config import default_config

    bart = default_config().model.bart
    work = tmp / "reproduce"
    hf_dir = work / "hf"
    hf_dir.mkdir(parents=True)
    os.symlink(tmp / "graft" / "st" / "model.safetensors", hf_dir / "model.safetensors")
    transformers.BartConfig(
        vocab_size=bart.vocab_size, d_model=bart.d_model, encoder_layers=bart.encoder_layers,
        decoder_layers=bart.decoder_layers, encoder_attention_heads=bart.num_heads,
        decoder_attention_heads=bart.num_heads, encoder_ffn_dim=bart.ffn_dim,
        decoder_ffn_dim=bart.ffn_dim, max_position_embeddings=bart.max_position_embeddings,
        activation_function="gelu", dropout=0.1, attention_dropout=0.0,
        pad_token_id=bart.pad_token_id, bos_token_id=bart.bos_token_id,
        eos_token_id=bart.eos_token_id, decoder_start_token_id=bart.decoder_start_token_id,
        forced_eos_token_id=None, scale_embedding=False,
    ).to_json_file(hf_dir / "config.json")

    def run(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = reproduce.main(argv)
        lines = out.getvalue().strip().splitlines()
        return rc, json.loads(lines[-1]), lines

    # (a) the offline plan
    rc, res, _ = run(["--dry-run", "--work-dir", str(work / "dry")])
    steps = [s["step"] for s in res["plan"]]
    if rc != 0 or res["status"] != "dry-run-ok" or steps != [
            "fetch-chisco", "fetch-hf", "convert-hf", "parity-report"] or not all(
            res["tools"][k] for k in ("torch", "transformers", "numpy", "entry_points")):
        raise AssertionError(f"(a) dry run: rc {rc}, {res}")
    log(f"[reproduce] (a) --dry-run: rc 0, plan {steps}, tools {res['tools']}")

    # (b) blocked: every fetch needed, the probes fail
    probe = reproduce.probe_egress
    reproduce.probe_egress = lambda urls=None: [
        {"url": u, "ok": False, "error": "no egress (replaced probe)"} for u in reproduce.PROBE_URLS]
    try:
        rc, res, _ = run(["--work-dir", str(work / "blocked"), "--device", "cuda"])
    finally:
        reproduce.probe_egress = probe
    if rc != reproduce.BLOCKED_EXIT or res["status"] != "blocked" or res["reason"] != "no-egress":
        raise AssertionError(f"(b) blocked: rc {rc}, {res}")
    log(f"[reproduce] (b) no egress: rc {rc}, status {res['status']}, reason {res['reason']}, "
        f"{len(res['probes'])} probes")

    # (c) the local chain on the card
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with strict_f32():
        rc, res, lines = run(["--work-dir", str(work / "work"), "--data-dir", str(tmp / "data"),
                              "--hf-checkpoint", str(hf_dir), "--device", "cuda"])
    torch.cuda.synchronize()
    launches = _kernels.launch_counts()
    t_chain = time.perf_counter() - t0
    if rc != 0 or res["status"] != "ok" or res["identity"] != 1.0:
        raise AssertionError(f"(c) local chain: rc {rc}, {lines[-8:]}")
    report = json.loads((work / "work" / "parity_report.json").read_text())
    conv = torch.load(work / "work" / "bart_params.pt", weights_only=True)
    graft = torch.load(tmp / "graft" / "st.pt", weights_only=True)
    if conv.keys() != graft.keys() or any(not torch.equal(conv[k], graft[k]) for k in conv):
        raise AssertionError("(c) the chain's conversion differs from the graft phase's")
    beams = [c["num_beams"] for c in report["cases"]]
    if beams != [1, 3, 1, 3, 1, 3] or not all(c["identical"] for c in report["cases"]):
        raise AssertionError(f"(c) parity report {report}")
    log(f"[reproduce] (c) local chain --device cuda: convert + parity {t_chain:.1f} s, "
        f"identity {res['identity']} over {len(beams)} cases (beams {beams}), the conversion "
        f"equal to the graft phase's ({len(conv)} tensors), transformers "
        f"{transformers.__version__}, launches {launches}")
    log(f"[reproduce] phase {time.perf_counter() - t_phase:.1f} s on {smi}")
    return launches


def phase_feed(smi: str, tmp):
    """14. The device feed on the trainer phase's corpus (80 windows, plain,
    batches of 16): ``device_prefetch(size=2)`` over ``threaded_producer``
    of ``batch_iterator``; each device batch equals its host batch bit for
    bit, and every host -> device copy ran on a stream other than the
    default one.  Then batches/s of the prefetch against a plain
    ``.to("cuda")`` loop over the same host batches (each consumed by a
    reduction on the card), in turns (plain, prefetch, prefetch, plain): a
    number of this card's, no claim."""
    import numpy as np
    import torch

    from imagined_speech_translation_tpu_torch.config import default_config
    from imagined_speech_translation_tpu_torch.data import (
        ChineseCharTokenizer,
        EEGTextDataset,
        batch_iterator,
        device_prefetch,
        threaded_producer,
    )

    cfg = default_config()
    tok = ChineseCharTokenizer.from_vocab_file(tmp / "vocab.txt")
    ds = EEGTextDataset(str(tmp / "data"), str(tmp / "montage.csv"), tok, cfg.data,
                        augment=False, seed=cfg.training.seed)
    idx = np.arange(len(ds))
    host = list(batch_iterator(ds, idx, 16))
    streams, to = [], torch.Tensor.to

    def recording_to(self, *a, **kw):
        out = to(self, *a, **kw)
        if out.is_cuda and not self.is_cuda:
            streams.append(torch.cuda.current_stream().stream_id)
        return out

    torch.Tensor.to = recording_to
    try:
        fed = [{k: v.cpu() for k, v in b.items()} for b in device_prefetch(
            threaded_producer(lambda: batch_iterator(ds, idx, 16)), size=2)]
        torch.cuda.synchronize()
    finally:
        torch.Tensor.to = to
    default = torch.cuda.default_stream().stream_id
    if not streams or default in streams:
        raise AssertionError(f"copies on streams {sorted(set(streams))}, default {default}")
    if len(fed) != len(host):
        raise AssertionError(f"{len(fed)} batches fed, {len(host)} made")
    for i, (f, h) in enumerate(zip(fed, host)):
        if set(f) != set(h) or any(not np.array_equal(f[k].numpy(), h[k]) or
                                   f[k].numpy().dtype != h[k].dtype for k in h):
            raise AssertionError(f"fed batch {i} differs from its host batch")
    nbytes = sum(v.nbytes for v in host[0].values())
    log(f"[feed] {len(fed)} batches of 16 windows ({nbytes / 1e6:.2f} MB each) through "
        f"device_prefetch(size=2): bit-equal to the host batches; {len(streams)} copies on "
        f"stream {sorted(set(streams))}, not the default {default}")

    many = host * 8

    def prefetch():
        for b in device_prefetch(iter(many), size=2):
            b["eeg"].sum()
        torch.cuda.synchronize()

    def plain():
        for h in many:
            {k: torch.from_numpy(v).to("cuda") for k, v in h.items()}["eeg"].sum()
        torch.cuda.synchronize()

    prefetch(), plain()  # warm-up
    rates = {"plain": [], "prefetch": []}
    for name, fn in (("plain", plain), ("prefetch", prefetch), ("prefetch", prefetch),
                     ("plain", plain)):
        t0 = time.perf_counter()
        fn()
        rates[name].append(len(many) / (time.perf_counter() - t0))
    log(f"[feed] batches/s over {len(many)} batches (plain, prefetch, prefetch, plain turns) "
        f"on {smi}: device_prefetch {[round(r, 1) for r in rates['prefetch']]}, plain .to "
        f"{[round(r, 1) for r in rates['plain']]}")


def phase_features(smi: str):
    """15. ``SignalFrontend.features`` (the IIR kernel, CAR, the STFT
    log-spectrogram) on (16, 125, 1651) float32 on the card, against the CPU
    plain path (the IIR's sequential twin, the same STFT): exactly 1
    ``sosfilt`` launch a call; the filtered signals within the IIR's bound,
    2e-4 x max |x|; each log-power within the interval that their measured
    difference dy implies, [log(max(|X| - dX, 0)^2 + eps), log((|X| + dX)^2
    + eps)] with dX = sum|w| x (dy + 1e-6 x max|y|) and X the CPU path's STFT
    in float64; ms a call."""
    import numpy as np
    import torch

    from imagined_speech_translation_tpu_torch import _kernels
    from imagined_speech_translation_tpu_torch.config import default_config
    from imagined_speech_translation_tpu_torch.frontend import SignalFrontend, stft_magnitude
    from imagined_speech_translation_tpu_torch.frontend.stft import get_window

    fe = SignalFrontend(default_config().frontend)
    c = fe.cfg
    x_host = (np.random.default_rng(0).normal(size=(16, 125, 1651)) * 20.0).astype(np.float32)
    x = torch.from_numpy(x_host).cuda()
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    feats = fe.features(x)
    torch.cuda.synchronize()
    launches = _kernels.launch_counts()
    if launches != {**{k: 0 for k in launches}, "sosfilt": 1}:
        raise AssertionError(f"features launched {launches}, want 1 sosfilt")
    y = fe.preprocess(x).cpu()
    x_cpu = torch.from_numpy(x_host)
    t0 = time.perf_counter()
    feats_cpu = fe.features(x_cpu)
    plain_s = time.perf_counter() - t0
    y_cpu = fe.preprocess(x_cpu)
    scale, top_y = float(np.abs(x_host).max()), y_cpu.abs().max().item()
    dy = (y - y_cpu).abs().max().item()
    if feats.shape != feats_cpu.shape or dy > 2e-4 * scale:
        raise AssertionError(f"features {tuple(feats.shape)}, filtered max |err| {dy} "
                             f"against 2e-4 x {scale}")
    ref = stft_magnitude(y_cpu.double(), nperseg=c.stft_nperseg, hop=c.stft_hop,
                         window=c.stft_window).numpy()
    dx = np.abs(get_window(c.stft_window, c.stft_nperseg)).sum() * (dy + 1e-6 * top_y)
    lo = np.log(np.maximum(ref - dx, 0.0) ** 2 + c.log_eps)
    hi = np.log((ref + dx) ** 2 + c.log_eps)
    got = feats.cpu().double().numpy()
    bad = (got < lo - 1e-5 * np.abs(lo)) | (got > hi + 1e-5 * np.abs(hi))
    if bad.any() or not np.isfinite(got).all():
        raise AssertionError(f"{bad.sum()} of {bad.size} log-power bins outside their interval")
    narrow = float((hi - lo < 0.05).mean())
    err = np.abs(got - feats_cpu.double().numpy())
    ms = cuda_ms(lambda: fe.features(x), 20, 3)
    log(f"[features] (16, 125, 1651) -> {tuple(feats.shape)}: 1 sosfilt launch a call; "
        f"filtered max |err| {dy:.3e} (bound {2e-4 * scale:.3e}); every log-power within "
        f"its interval ({narrow:.3f} of them narrower than 0.05); max |err| of the "
        f"log-power against the CPU path {err.max():.3e}, median {np.median(err):.3e}; "
        f"{ms:.3f} ms a call on {smi} (the CPU plain path {plain_s * 1e3:.1f} ms)")
    return launches


# ---------------------------------------------------------------------------
# 16. multi_device: data parallelism (two ranks, two replicas, one card)
# ---------------------------------------------------------------------------

# the wake path's corpus on the card: the layout of the lunar training
# catalog that wake_model/ was written for (tests/test_wake_dataset.py's
# _write_corpus): a catalog of events and one CSV of (abs, time_rel,
# velocity) rows an event, averaged by 7
WAKE_AVG = 7
WAKE_EVENTS = 48
# the NASA Space Apps 2024 Seismic Detection lunar training catalog as
# published: 76 events, each a day of velocity at 6.625 Hz (~572,400 rows),
# so 81,770 steps after averaging by 7; fc1 alone is 1,308,288 x 128
LUNAR_SHAPE = (76, 81770, 2)
LUNAR_BATCH = 32
# Adam's first step at the CLI's lr 1e-3 moves each of fc1's 167M weights by
# ~1e-3 and lifts the loss far above its start before it falls
LUNAR_STEPS = 16
WAKE_LOGIT_REL = 1e-4  # card vs CPU logits, max |err| / max |ref|, float32


def _write_wake_corpus(root, n_events: int, seed: int = 0):
    """``n_events`` event CSVs of ragged lengths (~60-66 averaged rows) with
    a velocity spike over the 7 raw rows of each event's averaged row, and
    the catalog naming them; returns the catalog's path."""
    import numpy as np

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    lines = ["filename,abs,time_rel(sec),extra,mq_type"]
    for f in range(n_events):
        n_rows = WAKE_AVG * (60 + f % 7)
        event_row = int(rng.integers(4, 56))
        lines.append(f"evt{f},0,{event_row * WAKE_AVG}.0,0,impulse")
        vel = rng.normal(size=n_rows)
        vel[event_row * WAKE_AVG : (event_row + 1) * WAKE_AVG] += 6.0
        rows = ["abs,time_rel,velocity"] + [f"0,{r},{v:.4f}" for r, v in enumerate(vel)]
        (root / f"evt{f}.csv").write_text("\n".join(rows) + "\n")
    (root / "catalog.csv").write_text("\n".join(lines) + "\n")
    return root / "catalog.csv"


def phase_wake(smi: str):
    """18. The wake path.  (a) ``cli.wake_train.main --device cuda`` on a
    corpus of 48 events written here in the lunar catalog's layout (40
    epochs, batch 16): finite epoch losses, the last logged below the first,
    the accuracy returned, the ``torch.save`` file reloaded strictly into a
    fresh twin, and no kernel of the port launched; (b) those weights on the
    card and on the CPU on the standardised corpus: logits within
    ``WAKE_LOGIT_REL`` of max |ref| (float32, TF32 off), the same
    predictions; (c) the twin's train step at the published lunar catalog's
    shape, (76, 81,770, 2) synthetic impulse sequences made on the card from
    a seed: ``LUNAR_STEPS`` Adam steps on one batch of 32, finite losses,
    the last below the first, s/step and peak memory.  Returns (a)'s
    launches."""
    import logging
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    import torch.nn.functional as F

    from imagined_speech_translation_tpu_torch import _kernels
    from imagined_speech_translation_tpu_torch.cli import wake_train
    from imagined_speech_translation_tpu_torch.wake import WakeMLP, make_wake_train_step
    from imagined_speech_translation_tpu_torch.wake.dataset import load_wake_dataset

    t_phase = time.perf_counter()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="wake_smoke_", dir=build))
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Keep()
    wake_train.logger.addHandler(handler)
    try:
        # (a) the entry point
        catalog = _write_wake_corpus(tmp / "corpus", WAKE_EVENTS)
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        acc = wake_train.main([str(catalog), str(tmp / "corpus"), "--epochs", "40",
                               "--batch", "16", "--out", str(tmp / "wake_twin.pt"),
                               "--device", "cuda"])
        torch.cuda.synchronize()
        launches = _kernels.launch_counts()
        t_cli = time.perf_counter() - t0
        losses = [float(m.split("loss=")[1].split()[0]) for m in records if "loss=" in m]
        if (not losses or not all(np.isfinite(losses)) or not losses[-1] < losses[0]
                or not 0.0 <= acc <= 1.0 or any(launches.values())):
            raise AssertionError(f"(a) wake_train: losses {losses}, acc {acc}, "
                                 f"launches {launches}")
        ds = load_wake_dataset(catalog, tmp / "corpus")
        sd = torch.load(tmp / "wake_twin.pt", weights_only=True)
        cpu_model = WakeMLP(ds.seq_len, ds.seq_len)
        cpu_model.load_state_dict(sd, strict=True)
        log(f"[wake] (a) cli.wake_train --device cuda on {WAKE_EVENTS} events (seq_len "
            f"{ds.seq_len}), 40 epochs of batch 16: {t_cli:.2f} s, logged losses {losses}, "
            f"acc {acc:.3f}; wake_twin.pt ({len(sd)} tensors) reloads strictly; launches "
            f"{launches}")

        # (b) the same weights on the card and on the CPU
        x = torch.from_numpy(wake_train.standardize(ds.data))
        with torch.no_grad(), strict_f32():
            ref = cpu_model.eval()(x)
            got = WakeMLP(ds.seq_len, ds.seq_len).cuda()
            got.load_state_dict(sd, strict=True)
            got = got.eval()(x.cuda()).cpu()
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        same = torch.equal(got.argmax(-1), ref.argmax(-1))
        labels = torch.from_numpy(np.minimum(ds.labels(), ds.seq_len - 1).astype(np.int64))
        loss = F.cross_entropy(got, labels).item()
        if not rel <= WAKE_LOGIT_REL or not same or not np.isfinite(loss):
            raise AssertionError(f"(b) card vs CPU logits {rel:.2e} of max |ref| (bound "
                                 f"{WAKE_LOGIT_REL}), predictions equal {same}, loss {loss}")
        log(f"[wake] (b) card vs CPU on the {len(ds.data)} sequences: logits within "
            f"{rel:.2e} of max |ref| (bound {WAKE_LOGIT_REL}), predictions equal, loss "
            f"{loss:.4f}")
        del cpu_model, got

        # (c) the train step at the lunar catalog's shape
        n, seq, feats = LUNAR_SHAPE
        g = torch.Generator(device="cuda").manual_seed(0)
        data = torch.randn(LUNAR_SHAPE, generator=g, device="cuda") * 0.05
        events = torch.randint(0, seq, (n,), generator=g, device="cuda")
        data[torch.arange(n, device="cuda"), events, 1] += 5.0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = WakeMLP(seq, seq).cuda()
        init_fn, step_fn, _ = make_wake_train_step(model, 1e-3)
        model, opt = init_fn(42)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        xb, yb = data[:LUNAR_BATCH], events[:LUNAR_BATCH]
        losses, times = [], []
        for _ in range(LUNAR_STEPS):
            t0 = time.perf_counter()
            model, opt, loss = step_fn(model, opt, xb, yb)
            losses.append(float(loss))  # synchronizes
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        steady = times[1:]
        log(f"[wake] (c) twin train step at the lunar catalog's shape {LUNAR_SHAPE}, batch "
            f"{LUNAR_BATCH}, lr 1e-3: {n_params} parameters (fc1 "
            f"{tuple(model.fc1.weight.shape)}), init {t_init:.2f} s, losses "
            f"{[round(v, 4) for v in losses]}, s/step first {times[0]:.4f}, then "
            f"{min(steady):.4f}-{max(steady):.4f} (median "
            f"{sorted(steady)[len(steady) // 2]:.4f}), peak memory {peak:.3f} GiB, on {smi}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"(c) lunar-shape steps: losses {losses}")
        del model, opt, data, xb
        torch.cuda.empty_cache()
    finally:
        wake_train.logger.removeHandler(handler)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[wake] phase {time.perf_counter() - t_phase:.1f} s on {smi}")
    return launches


DP_RANKS = 2
DP_SETS = ("training.num_epochs=1", "training.eval_interval_epochs=1",
           "training.checkpoint.save_interval_epochs=1", "training.checkpoint.max_to_keep=1",
           "training.mixed_precision=false", "training.log_every_steps=1")
DP_STEP_RTOL = 2e-4  # the JAX test's bound (tests/test_parallel.py)
DP_DQ_F32_REL = 1e-5  # dQ's f32 atomic sums in another order, relative to max |dQ|


def beyond_one_ulp(a, b, top: float) -> float:
    """max(|a - b| - one unit in the last place of a's dtype at the larger
    magnitude, 0) / ``top``: what a difference leaves after a rounding of
    the same f32 value to a's dtype could flip its last bit."""
    import torch

    x = torch.maximum(a.float().abs(), b.float().abs()).clamp_min(2.0 ** -126)
    mantissa = {torch.bfloat16: 7, torch.float32: 23}[a.dtype]  # explicit bits
    ulp = torch.exp2(torch.floor(torch.log2(x)) - mantissa)
    return ((a.float() - b.float()).abs() - ulp).clamp_min(0.0).max().item() / top


def multi_device_kernels():
    """The flash forward with dropout 0.1 and the fused backward at the
    training shapes ((4 regions x 4 rows) x 6 heads x 1655 x 128 and x 3
    heads x 256), in bf16 and f32: each rank's half of the micro-batch,
    launched with the global head mapping (``dropout_rows = (2, 4, 2r)``),
    must give the full launch's rows of out, lse, dK and dV bit for bit, and
    dQ within ``DP_DQ_F32_REL`` x max |dQ| beyond one unit in the last
    place of its dtype: dQ is summed in f32 by atomic reductions in no fixed
    order, so even two full launches differ there, and in bf16 the cast of
    such sums can flip a last bit;
    the same launches with the identity mapping must not.  The probe writes
    mapped tiles equal to its plain twin's and to the full launch's tile of
    the global head."""
    import numpy as np
    import torch

    from imagined_speech_translation_tpu_torch.ops import flash_attention, tile_keep_mask
    from imagined_speech_translation_tpu_torch.ops.dropout_mask import (
        dropout_blocks,
        global_head,
        tile_keep_mask_reference,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(16)
    rate, seed, S, R, B, rows = 0.1, 4321, 1655, 4, 4, 2
    kw = dict(dropout_rate=rate, dropout_seed=seed)
    results = []

    def run(q, k, v, dout, dropout_rows):
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        out, lse = flash_attention(q, k, v, dropout_rows=dropout_rows, **kw)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
        return dict(out=out.detach(), lse=lse.reshape(q.shape[0], q.shape[1], S), dq=dq, dk=dk,
                    dv=dv)

    def half(t, r):
        """Rank r's rows of a (R * B, ...) tensor, region-major."""
        return t.unflatten(0, (R, B))[:, r * rows:(r + 1) * rows].flatten(0, 1).contiguous()

    for heads, d in ((6, 128), (3, 256)):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).removeprefix("torch.")
            shape = (R * B, heads, S, d)
            q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.3)
                       .to(dev, dtype) for _ in range(3))
            dout = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dtype)
            full = run(q, k, v, dout, None)
            again = run(q, k, v, dout, None)
            dq_spread = (full["dq"].float() - again["dq"].float()).abs().max().item()
            dq_top = full["dq"].float().abs().max().item()
            for r in range(DP_RANKS):
                args = [half(t, r) for t in (q, k, v, dout)]
                want = {key: half(t, r) for key, t in full.items()}
                mapped = run(*args, (rows, B, r * rows))
                identity = run(*args, None)
                bits = {key: torch.equal(mapped[key], want[key]) for key in want}
                dq_rel = (mapped["dq"].float() - want["dq"].float()).abs().max().item() / dq_top
                dq_excess = beyond_one_ulp(mapped["dq"], want["dq"], dq_top)
                off = {key: (identity[key].float() - want[key].float()).abs().max().item()
                       / max(want[key].float().abs().max().item(), 1e-30)
                       for key in ("out", "dq", "dk", "dv")}
                row = dict(shape=[R * rows * heads, S, d], dtype=name, rank=r,
                           equal_bits={key: bits[key] for key in ("out", "lse", "dk", "dv")},
                           dq_bits=bits["dq"], dq_rel_err=dq_rel, dq_rel_beyond_one_ulp=dq_excess,
                           dq_bound=DP_DQ_F32_REL,
                           dq_rel_spread_two_full_launches=dq_spread / dq_top,
                           identity_rel_err=off)
                results.append(row)
                log(f"[multi_device] kernels {name} ({R}x{rows}x{heads}, {S}, {d}) rank {r}: "
                    f"mapped out/lse/dK/dV bit-equal to the full launch's rows "
                    f"{row['equal_bits']}, dQ bits {bits['dq']}, dQ rel err {dq_rel:.2e}, "
                    f"{dq_excess:.2e} beyond one ulp (bound {DP_DQ_F32_REL:.0e}; two full "
                    f"launches differ by {dq_spread / dq_top:.2e}); identity mapping rel err "
                    f"{ {key: f'{x:.3f}' for key, x in off.items()} }")
                if not all(row["equal_bits"].values()) or dq_excess > DP_DQ_F32_REL:
                    raise AssertionError(f"mapped launch differs from the full rows: {row}")
                if min(off.values()) <= 1e-2 or identity["out"].equal(want["out"]):
                    raise AssertionError(f"identity mapping matches the full rows: {row}")
            del full, again, q, k, v, dout

    # the probe: mapped tiles of rank 1 against the plain twin and the full
    # launch's tile of the global head
    mismatches = 0
    for dtype in (torch.bfloat16, torch.float32):
        bq, bk = dropout_blocks(R * B * 6, S, S, dtype)
        for bh in (0, 7, 13, R * rows * 6 - 1):
            for qi, ki in ((0, 0), (1, 2), (-(-S // bq) - 1, -(-S // bk) - 1)):
                mk = dict(block_q=bq, block_k=bk, rate=rate)
                got = tile_keep_mask(seed, bh, qi, ki, **mk, device=dev, rows=(rows, B, rows),
                                     heads=6)
                plain = tile_keep_mask_reference(seed, bh, qi, ki, **mk, device=dev,
                                                 rows=(rows, B, rows), heads=6)
                gh = global_head(bh, (rows, B, rows), 6)
                whole = tile_keep_mask(seed, gh, qi, ki, **mk, device=dev)
                mismatches += int((got != plain).sum()) + int((got != whole).sum())
    log(f"[multi_device] probe: 24 mapped tiles of rank 1 (bf16 and f32 tilings) against the "
        f"plain twin and the full launch's tile of the global head: {mismatches} mismatches")
    if mismatches:
        raise AssertionError(f"mapped probe tiles: {mismatches} mismatches")
    return results


def _state_tensors(state) -> dict:
    """A train state's tensors by name: module entries, both moments."""
    return {**{f"module.{k}": v for k, v in state.module.state_dict().items()},
            **{f"mu.{k}": v for k, v in state.opt_state.mu.items()},
            **{f"nu.{k}": v for k, v in state.opt_state.nu.items()}}


def train_rank(spec_json: str) -> int:
    """One ``cli.train`` process of the multi_device phase (a rank when the
    ``IST_*`` variables are set, else the single-process run): runs
    ``cli.train.main(argv)`` and writes, as JSON to ``out``: launches during
    the training epochs and in all, seconds per epoch, all-reduce seconds,
    peak memory, ``torch.save`` calls, whether the module's tensors (and the
    BatchNorm statistics) equal the first rank's bit for bit, and whether
    the written checkpoint restores, on this rank, into the live state's
    tensors bit for bit."""
    import torch
    import torch.distributed as dist

    from imagined_speech_translation_tpu_torch import _kernels
    from imagined_speech_translation_tpu_torch.cli import train as train_cli
    from imagined_speech_translation_tpu_torch.training import EEGTrainer, learning_rates_at

    spec = json.loads(spec_json)
    epochs, saves = [], []
    train_epoch, save = EEGTrainer.train_epoch, torch.save

    def recorded_epoch(self, state, epoch, **kw):
        torch.cuda.synchronize()
        before = _kernels.launch_counts()
        t0 = time.perf_counter()
        out = train_epoch(self, state, epoch, **kw)
        torch.cuda.synchronize()
        after = _kernels.launch_counts()
        epochs.append(dict(seconds=time.perf_counter() - t0,
                           launches={k: after[k] - before[k] for k in after}))
        return out

    def counted_save(obj, f, *a, **kw):
        saves.append(str(f))
        return save(obj, f, *a, **kw)

    EEGTrainer.train_epoch, torch.save = recorded_epoch, counted_save
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_cli.main(spec["argv"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernels.launch_counts()
    EEGTrainer.train_epoch, torch.save = train_epoch, save
    trainer, state = res["trainer"], res["state"]
    device = next(state.module.parameters()).device
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0

    # the module's tensors against the first rank's, bit for bit (under
    # tensor parallelism the replicated ones; the split ones are slices)
    unequal = []
    split = state.tensor_parallel.dims if state.tensor_parallel is not None else {}
    for key, t in state.module.state_dict().items():
        if key in split:
            continue
        first = t.clone()
        if world > 1:
            dist.broadcast(first.view(-1).view(torch.uint8), 0)
        if not torch.equal(first, t):
            unequal.append(key)
    # the checkpoint restores into the live state's tensors bit for bit
    name = trainer.ckpt.latest_epoch_checkpoint()
    live = {k: v.clone() for k, v in _state_tensors(state).items()}
    t1 = time.perf_counter()
    restored, _ = trainer.ckpt.restore(name, state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    got = _state_tensors(restored)
    differ = [k for k, v in live.items() if not torch.equal(v, got[k])]
    lrs = [max(learning_rates_at(trainer.cfg.training.optimizer, trainer.total_steps, s)
               .values()) for s in range(int(state.step))]
    out = dict(rank=rank, world=world, device=str(device), step=int(state.step),
               launches=launches, epochs=epochs, wall_s=wall, peak_gib=peak,
               allreduce_s=getattr(trainer._train_step, "allreduce_seconds", 0.0),
               saves=saves, unequal_to_first_rank=unequal,
               bn_equal_to_first_rank=not any("running_" in k for k in unequal),
               restored=name, restore_s=restore_s, restore_differs=differ,
               lr_max=max(lrs), test_predictions=res["test_metrics"]["predictions"],
               split=len(split))
    with open(spec["out"], "w") as f:
        json.dump(out, f)
    return 0


def _spawn_train(tmp, tag: str, argv: list, env: dict):
    """Start one ``train_rank`` process; returns (process, result path, log path)."""
    import os
    from pathlib import Path

    res, log_path = tmp / f"{tag}.json", tmp / f"{tag}.log"
    spec = json.dumps(dict(argv=argv, out=str(res)))
    code = "import sys, chip_smoke; sys.exit(chip_smoke.train_rank(sys.argv[1]))"
    with open(log_path, "w") as f:
        proc = subprocess.Popen([sys.executable, "-c", code, spec], stdout=f,
                                stderr=subprocess.STDOUT, env={**os.environ, **env},
                                cwd=str(Path(__file__).resolve().parent))
    return proc, res, log_path


def _wait_all(runs, timeout_s: float) -> list[dict]:
    """Wait for every ``_spawn_train`` run (killing all on a failure or at
    the deadline); returns their results."""
    deadline = time.perf_counter() + timeout_s
    try:
        for proc, _, log_path in runs:
            rc = proc.wait(timeout=max(deadline - time.perf_counter(), 1.0))
            if rc != 0:
                tail = log_path.read_text()[-3000:]
                raise AssertionError(f"{log_path.name} exited {rc}:\n{tail}")
    finally:
        for proc, _, _ in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [json.loads(res.read_text()) for _, res, _ in runs]


def _train_metrics(path) -> list[dict]:
    """The per-step ``train/...`` metrics of a ``metrics.jsonl``."""
    rows = [json.loads(line) for line in path.open()]
    return [{k: v for k, v in r.items() if k.startswith("train/loss") or k == "train/grad_norm"}
            for r in rows if "train/loss" in r]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_multi_device(smi: str, tmp):
    """16. Data parallelism on one card, on the trainer phase's corpus.
    (a) ``multi_device_kernels``.  (b) ``cli.train`` at full width
    (``default_config()``, float32: ``training.mixed_precision=false``) for
    1 epoch of 2 optimizer steps (8 micro-steps of 4 windows), an evaluation
    and a checkpoint, once in one process (``parallel.data_axis=1``) and
    once as two ranks (``IST_COORDINATOR`` on a free port,
    ``IST_NUM_PROCESSES=2``, ``IST_PROCESS_ID=0/1``, ``IST_BACKEND=gloo``:
    NCCL refuses two ranks on one card; ``parallel.data_axis=2``), each
    process a ``train_rank``.  Checks: every step's loss and components
    within 2e-4 relative of the one-process run; the final weights by the
    rule of ``tests/test_torch_train_step.py`` (within 1e-6 + 1e-3 of the
    largest learning rate, all but 0.1% of them, and every one within 2.1
    learning rates), the BatchNorm statistics within 1e-4 relative + 1e-5
    and equal on both ranks, the whole module equal on both ranks; the same
    checkpoint directories as the one-process run, each written once (by
    the first rank), restored bit for bit on both ranks; on each rank
    exactly 5 flash forward and 5 fused backward launches a micro-step (16
    micro-steps of 2 windows), and 10 flash forward an evaluation batch on
    the first rank only.  (c) Serving: ``cli.serve.build_decode_fn_from_args``
    on the two-rank run's checkpoint (beam 3 pinned to 16, BatchNorm folded,
    bf16) with ``devices=["cuda:0", "cuda:0"]``: two replicas on one card.
    The ids of 16 windows equal the single replica's; 15 windows raise
    "not divisible"; behind a ``BatchScheduler(max_batch=16)`` 10 live
    windows get the single replica's ids on the same padded batch; exactly 2
    IIR and 10 flash forward launches a batch.  Times: seconds a step of
    both runs, the all-reduce's share, peak memory a rank, windows/s of two
    replicas beside one.  Two ranks (or replicas) share the card's SMs and
    gloo reduces through the host: these numbers measure correctness, not
    scaling.  Returns the launches of the two-rank run and of the serving
    batch."""
    import asyncio

    import numpy as np
    import torch

    from imagined_speech_translation_tpu_torch import _kernels
    from imagined_speech_translation_tpu_torch.config import default_config, replace_nested
    from imagined_speech_translation_tpu_torch.runtime import BatchScheduler

    kernel_rows = timed(multi_device_kernels)
    torch.cuda.empty_cache()

    cfg = default_config()
    micro = cfg.training.grad_accum_steps * 2  # 2 windows of 8 micro-steps
    base = ["--data-dir", str(tmp / "data"), "--montage", str(tmp / "montage.csv"),
            "--vocab", str(tmp / "vocab.txt"), "--device", "cuda"]
    for s in DP_SETS:
        base += ["--set", s]
    env = {"WANDB_MODE": "disabled"}
    one_dir, dp_dir = tmp / "dp_one", tmp / "dp_two"
    t0 = time.perf_counter()
    (one,) = _wait_all([_spawn_train(tmp, "dp_one", base + [
        "--out-dir", str(one_dir), "--set", "parallel.data_axis=1"], env)], 600)
    t_one = time.perf_counter() - t0
    port = _free_port()
    rank_env = dict(env, IST_COORDINATOR=f"127.0.0.1:{port}",
                    IST_NUM_PROCESSES=str(DP_RANKS), IST_BACKEND="gloo")
    log(f"[multi_device] one process: {t_one:.1f} s; two ranks with IST_COORDINATOR="
        f"127.0.0.1:{port} IST_NUM_PROCESSES={DP_RANKS} IST_BACKEND=gloo (NCCL refuses two "
        f"ranks on one card) WANDB_MODE=disabled, --set parallel.data_axis={DP_RANKS}")
    t0 = time.perf_counter()
    ranks = _wait_all([_spawn_train(tmp, f"dp_rank{r}", base + [
        "--out-dir", str(dp_dir), "--set", f"parallel.data_axis={DP_RANKS}"],
        dict(rank_env, IST_PROCESS_ID=str(r))) for r in range(DP_RANKS)], 600)
    t_two = time.perf_counter() - t0

    # every step's loss and components
    want, got = _train_metrics(one_dir / "metrics.jsonl"), _train_metrics(dp_dir / "metrics.jsonl")
    if len(want) != 2 or len(got) != 2:
        raise AssertionError(f"logged steps: {len(want)} one process, {len(got)} two ranks")
    worst = 0.0
    for i, (w, g) in enumerate(zip(want, got)):
        for key in w:
            rel = abs(g[key] - w[key]) / max(abs(w[key]), 1e-30)
            if key != "train/grad_norm":
                worst = max(worst, rel)
                if rel > DP_STEP_RTOL:
                    raise AssertionError(f"step {i} {key}: two ranks {g[key]}, one process "
                                         f"{w[key]} (rel {rel:.2e} > {DP_STEP_RTOL})")
    grad_rel = [abs(g["train/grad_norm"] - w["train/grad_norm"]) / w["train/grad_norm"]
                for w, g in zip(want, got)]
    log(f"[multi_device] train: steps {[r['step'] for r in ranks]} (one process "
        f"{one['step']}); losses and components of both steps within {worst:.2e} relative "
        f"(bound {DP_STEP_RTOL}); grad norm {grad_rel}; one process loss "
        f"{[round(w['train/loss'], 6) for w in want]}, two ranks "
        f"{[round(g['train/loss'], 6) for g in got]}")

    # checkpoints: the same directories, each written once, restored on both ranks
    dirs_one = sorted(p.name for p in (one_dir / "checkpoints").iterdir())
    dirs_two = sorted(p.name for p in (dp_dir / "checkpoints").iterdir())
    writes = [len(r["saves"]) for r in ranks]
    if (dirs_two != dirs_one or "checkpoint_epoch_1" not in dirs_two
            or writes != [len(dirs_two)] + [0] * (DP_RANKS - 1)):
        raise AssertionError(f"checkpoints {dirs_two} (one process {dirs_one}), writes a rank "
                             f"{writes}")
    for r in ranks:
        if r["restore_differs"] or r["unequal_to_first_rank"] or not r["bn_equal_to_first_rank"]:
            raise AssertionError(f"rank {r['rank']}: restore differs at "
                                 f"{r['restore_differs'][:5]}, unequal to rank 0 at "
                                 f"{r['unequal_to_first_rank'][:5]}")
    log(f"[multi_device] checkpoints {dirs_two}, written once each (torch.save calls by rank "
        f"{writes}); {ranks[0]['restored']} restored bit for bit on both ranks "
        f"({[round(r['restore_s'], 2) for r in ranks]} s); module and BatchNorm statistics "
        f"equal on both ranks")

    # final weights against the one-process run's, by the learning-rate rule
    lr = one["lr_max"]
    a = torch.load(one_dir / "checkpoints" / "checkpoint_epoch_1" / "state.pt",
                   map_location="cuda", weights_only=True)["module"]
    b = torch.load(dp_dir / "checkpoints" / "checkpoint_epoch_1" / "state.pt",
                   map_location="cuda", weights_only=True)["module"]
    flipped = n = 0
    worst_bn = worst_p = 0.0
    for key, w in a.items():
        g = b[key]
        diff = (g.float() - w.float()).abs()
        if "running_" in key:
            excess = (diff - 1e-4 * w.float().abs()).max().item()
            worst_bn = max(worst_bn, excess)
            if excess > 1e-5:
                raise AssertionError(f"BatchNorm {key}: beyond 1e-4 relative + 1e-5")
            continue
        worst_p = max(worst_p, diff.max().item())
        if diff.max().item() > 1e-6 + 1e-3 * lr + 2.1 * lr:
            raise AssertionError(f"{key}: max |diff| {diff.max().item()} beyond 2.1 lr ({lr})")
        flipped += int((diff > 1e-6 + 1e-3 * lr).sum())
        n += w.numel()
    del a, b
    torch.cuda.empty_cache()
    if flipped > 1e-3 * n:
        raise AssertionError(f"{flipped} of {n} parameters beyond 1e-3 lr")
    log(f"[multi_device] final weights: {flipped} of {n} parameters beyond 1e-6 + 1e-3 x lr "
        f"(lr max {lr:.3e}; allowed {int(1e-3 * n)}), max |diff| {worst_p:.3e}; BatchNorm "
        f"statistics within 1e-4 relative + {max(worst_bn, 0.0):.2e}")

    # launches a rank
    per_micro = {k: 0 for k in one["launches"]}
    per_micro.update(flash_fwd=5 * micro, flash_bwd=5 * micro)
    evals = one["launches"]["flash_fwd"] - 5 * micro  # 10 an evaluation batch
    for r in ranks + [one]:
        train = {k: sum(e["launches"][k] for e in r["epochs"]) for k in per_micro}
        extra = evals if r["rank"] == 0 else 0
        if train != per_micro or r["launches"] != dict(per_micro, flash_fwd=5 * micro + extra):
            raise AssertionError(f"rank {r['rank']} of {r['world']}: training launches {train},"
                                 f" all {r['launches']}; want {per_micro} + {extra} forward")
    if evals <= 0 or evals % 10:
        raise AssertionError(f"evaluation launches {evals}")
    log(f"[multi_device] launches: each rank 5 flash forward + 5 fused backward a micro-step "
        f"({micro} micro-steps of 2 windows); evaluations {evals} flash forward on rank 0 only")

    def per_step(r):
        return sum(e["seconds"] for e in r["epochs"]) / r["step"]

    log(f"[multi_device] on {smi}: one process {per_step(one):.2f} s a step (peak "
        f"{one['peak_gib']:.1f} GiB, wall {one['wall_s']:.1f} s); two ranks on one card "
        f"{[round(per_step(r), 2) for r in ranks]} s a step, all-reduce "
        f"{[round(r['allreduce_s'], 2) for r in ranks]} s of "
        f"{[round(sum(e['seconds'] for e in r['epochs']), 2) for r in ranks]} s "
        f"({[round(r['allreduce_s'] / sum(e['seconds'] for e in r['epochs']), 3) for r in ranks]}"
        f" of the epoch), peak {[round(r['peak_gib'], 1) for r in ranks]} GiB a rank, wall "
        f"{[round(r['wall_s'], 1) for r in ranks]} s; the phase's processes {t_one:.1f} + "
        f"{t_two:.1f} s; correctness, not scaling: both ranks share the card and gloo "
        f"reduces through the host")
    dp_launches = {k: sum(r["launches"][k] for r in ranks) for k in per_micro}

    # serving: two replicas on one card
    scfg = replace_nested(cfg, "generation.min_length", cfg.generation.max_length)
    (tmp / "dp_serve_config.json").write_text(scfg.to_json())
    T = scfg.data.n_timepoints
    fargs = dict(vocab=str(tmp / "vocab.txt"), montage=str(tmp / "montage.csv"),
                 config=str(tmp / "dp_serve_config.json"),
                 checkpoint=str(dp_dir / "checkpoints" / "checkpoint_epoch_1"), device="cuda",
                 compute_dtype="bfloat16", max_batch=16)
    one_fn, one_tok = build_recorded(fargs)
    two_fn, two_tok = build_recorded(dict(fargs, devices=["cuda:0", "cuda:0"]))
    log("[multi_device] serving: one replica, and two replicas on one card (cuda:0, cuda:0)")
    windows = np.random.default_rng(17).normal(size=(16, 125, T)).astype(np.float32)
    one_fn(windows)
    want_ids = one_tok.history[-1]
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    two_fn(windows)
    torch.cuda.synchronize()
    serve_launches = _kernels.launch_counts()
    if serve_launches != {**{k: 0 for k in serve_launches}, "sosfilt": 2, "flash_fwd": 10}:
        raise AssertionError(f"two replicas launched {serve_launches} for a batch, want 2 "
                             f"sosfilt + 10 flash_fwd")
    if not np.array_equal(two_tok.history[-1], want_ids):
        raise AssertionError("two replicas' ids differ from one replica's")
    try:
        two_fn(windows[:15])
        raise AssertionError("15 windows over two replicas did not raise")
    except ValueError as e:
        if "not divisible" not in str(e):
            raise

    async def pooled():
        async with BatchScheduler(two_fn, max_batch=16, max_delay_ms=20) as s:
            return await asyncio.gather(*(s.submit(w) for w in windows[:10]))

    pooled_texts = asyncio.run(pooled())
    padded = np.concatenate([windows[:10], np.repeat(windows[:1], 6, axis=0)])
    if pooled_texts != one_fn(padded)[:10] or len(two_tok.history) != 3:
        raise AssertionError("10 pooled windows over two replicas: not one batch, or texts "
                             "other than one replica's on the same padded batch")
    if not np.array_equal(two_tok.history[-1][:10], one_tok.history[-1][:10]):
        raise AssertionError("pooled windows' ids over two replicas differ from one replica's")

    rates = {"one": [], "two": []}
    for tag, fn in (("one", one_fn), ("two", two_fn), ("two", two_fn), ("one", one_fn)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn(windows)
        rates[tag].append(48 / (time.perf_counter() - t0))
    log(f"[multi_device] serving: ids of 16 windows equal over two replicas and one; 15 raise "
        f"'not divisible'; 10 pooled windows (padded to 16) equal; 2 sosfilt + 10 flash_fwd "
        f"launches a batch; windows/s on {smi} (one, two, two, one turns): two replicas "
        f"{[round(x, 2) for x in rates['two']]}, one {[round(x, 2) for x in rates['one']]}")
    del one_fn, two_fn
    torch.cuda.empty_cache()
    return kernel_rows, dp_launches, serve_launches, (one, one_dir)


# ---------------------------------------------------------------------------
# 17. tp_cp: tensor parallelism and ring attention (two ranks, one card)
# ---------------------------------------------------------------------------

TP_RANKS = 2
RING_SHAPE = (16, 6, 1656, 128)  # the region attention's batch x heads at B = 4, padded
RING_REL = 1e-4    # ring against plain attention: max |err| / max |ref|, f32
CP_BATCH = 2       # windows through the context-parallel encoder
CP_REL = 1e-4      # the encoder's out and gradients against one process with the plain
                   # attention: max |err| / max |ref| and of the largest gradient (JAX's rule)


def cp_rank(spec_json: str) -> int:
    """One rank of the context-parallel checks (``IST_*`` set): (c)
    ``ring_attention`` alone at ``RING_SHAPE`` in float32 over a ``seq`` axis
    of two ranks, and (b) the full-width ``BrainRegionEncoder`` with
    ``seq_shards=2`` (1655 tokens padded to 1656, eval mode) on ``CP_BATCH``
    windows.  With ``data`` > 1 in the spec the mesh is ``{data, seq: 2}``
    and each data group takes its rows of both inputs.  The first seq rank
    of each group also runs the plain attention and the ``seq_shards=1``
    encoder on its rows, with the attention's plain twin (float32 products,
    as the ring's: the bounded comparison) and with the flash kernels
    (3xTF32: reported), and writes the errors, as JSON to ``out``, with
    each rank's seconds and peak memory."""
    import dataclasses

    import numpy as np
    import torch

    from imagined_speech_translation_tpu_torch import _kernels
    from imagined_speech_translation_tpu_torch.config import default_config
    from imagined_speech_translation_tpu_torch.models import BrainRegionEncoder, layers
    from imagined_speech_translation_tpu_torch.models.init import init_parameters
    from imagined_speech_translation_tpu_torch.ops.flash_attention import (
        flash_attention_reference,
    )
    from imagined_speech_translation_tpu_torch.parallel import (
        context_mesh, initialize_distributed, make_mesh, ring_attention)

    spec = json.loads(spec_json)
    initialize_distributed(device="cuda")
    rank = torch.distributed.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(spec.get("data", 1), TP_RANKS, axis_names=("data", "seq"))
    lead = mesh.coords()["seq"] == 0
    out = dict(rank=rank, lead=lead)

    def my_rows(t):
        n = t.shape[0] // mesh.n_batch_shards
        return t[mesh.shard_index() * n:(mesh.shard_index() + 1) * n]

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    # (c) the ring alone
    rng = np.random.default_rng(23)
    q, k, v, w = (my_rows(torch.tensor(rng.normal(size=RING_SHAPE), dtype=torch.float32,
                                       device=dev)) for _ in range(4))

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = fn(*leaves)
        (o * w).sum().backward()
        torch.cuda.synchronize()
        return o.detach(), [t.grad for t in leaves], time.perf_counter() - t0

    def plain(q, k, v):
        p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5, dim=-1)
        return torch.matmul(p, v)

    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launch_counts()
    ring_out, ring_grads, ring_s = run(lambda q, k, v: ring_attention(q, k, v, mesh=mesh))
    ring_s = min(ring_s, run(lambda q, k, v: ring_attention(q, k, v, mesh=mesh))[2])
    out.update(ring_s=ring_s, ring_peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
               ring_launches=_kernels.launch_counts())
    if lead:
        ref_out, ref_grads, plain_s = run(plain)
        out.update(plain_s=min(plain_s, run(plain)[2]), ring_out_rel=rel(ring_out, ref_out),
                   ring_grad_rel=[rel(a, b) for a, b in zip(ring_grads, ref_grads)])
        del ref_out, ref_grads
    del q, k, v, w, ring_out, ring_grads
    torch.cuda.empty_cache()

    # (b) the encoder at full width
    cfg = default_config()
    counts = cfg.model.region_channel_counts
    mask = np.zeros((len(counts), cfg.model.max_region_channels), bool)
    for r, c in enumerate(counts):
        mask[r, :c] = True
    eeg = my_rows(torch.tensor(rng.normal(size=(CP_BATCH, len(counts),
                                                cfg.model.max_region_channels,
                                                cfg.data.n_timepoints)),
                               dtype=torch.float32, device=dev))
    mask = torch.tensor(mask, device=dev)

    def encoder(seq_shards):
        bcfg = cfg.model.brain_encoder
        bcfg = dataclasses.replace(bcfg, region_encoder=dataclasses.replace(
            bcfg.region_encoder, seq_shards=seq_shards))
        with torch.device("meta"):
            enc = BrainRegionEncoder(bcfg, in_channels=cfg.model.max_region_channels,
                                     n_timepoints=cfg.data.n_timepoints,
                                     n_regions=len(counts))
        enc = init_parameters(enc.to_empty(device=dev), 29).eval()
        names, params = zip(*enc.named_parameters())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = enc(eeg, mask)
        grads = torch.autograd.grad((y ** 2).sum(), params, allow_unused=True,
                                    materialize_grads=True)
        torch.cuda.synchronize()
        return y.detach(), dict(zip(names, grads)), time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launch_counts()
    with context_mesh(mesh):
        cp_out, cp_grads, cp_s = encoder(2)
    out.update(cp_s=cp_s, cp_peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
               cp_launches=_kernels.launch_counts(), cp_finite=bool(torch.isfinite(cp_out).all()))
    if lead:
        def against(ref_out, ref_grads):
            """out's error of max |ref|, the worst gradient's of the largest."""
            scale = max(g.abs().max().item() for g in ref_grads.values())
            worst = max(ref_grads, key=lambda n: (cp_grads[n] - ref_grads[n]).abs().max().item())
            return (rel(cp_out, ref_out), (cp_grads[worst] - ref_grads[worst]).abs().max().item()
                    / scale, worst, scale)

        # the bounded reference: one process with the attention's plain twin,
        # float32 products as the ring's; then the flash kernels' path
        plain_attention = layers.dot_product_attention
        layers.dot_product_attention = (
            lambda q, k, v, **kw: flash_attention_reference(q, k, v)[0])
        try:
            ref_out, ref_grads, one_s = encoder(1)
        finally:
            layers.dot_product_attention = plain_attention
        (out["cp_out_rel"], out["cp_grad_rel"], out["cp_grad_worst"],
         out["cp_grad_scale"]) = against(ref_out, ref_grads)
        del ref_out, ref_grads
        ref_out, ref_grads, kernel_s = encoder(1)
        out["kernel_out_rel"], out["kernel_grad_rel"], *_ = against(ref_out, ref_grads)
        out.update(one_s=one_s, kernel_s=kernel_s, n_params=len(ref_grads))
    torch.distributed.barrier()
    with open(spec["out"], "w") as f:
        json.dump(out, f)
    return 0


def _check_tp_run(smi: str, tag: str, one: dict, one_dir, ranks: list, tp_dir, micro: int):
    """The checks of a TP ``cli.train`` run (``ranks``, written under
    ``tp_dir``) against the one-process run: every step's loss and
    components within ``DP_STEP_RTOL``, the checkpoints written once and
    whole (the one-process run's keys and shapes, moments too), restored
    into each rank's slices bit for bit, the replicated tensors equal on
    every rank, the final weights by the learning-rate rule; exactly 5
    flash forward and 5 fused backward launches in each of a rank's
    ``micro`` micro-steps, and the evaluations' launches on the first rank
    only.  Returns the ranks' launches."""
    import torch

    want = _train_metrics(one_dir / "metrics.jsonl")
    got = _train_metrics(tp_dir / "metrics.jsonl")
    if len(want) != 2 or len(got) != 2:
        raise AssertionError(f"logged steps: {len(want)} one process, {len(got)} ranks")
    worst = 0.0
    for i, (w, g) in enumerate(zip(want, got)):
        for key in w:
            if key == "train/grad_norm":
                continue
            rel = abs(g[key] - w[key]) / max(abs(w[key]), 1e-30)
            worst = max(worst, rel)
            if rel > DP_STEP_RTOL:
                raise AssertionError(f"step {i} {key}: TP ranks {g[key]}, one process {w[key]} "
                                     f"(rel {rel:.2e} > {DP_STEP_RTOL})")
    log(f"[{tag}] train: steps {[r['step'] for r in ranks]}; losses and components of both "
        f"steps within {worst:.2e} relative (bound {DP_STEP_RTOL}); one process loss "
        f"{[round(w['train/loss'], 6) for w in want]}, TP ranks "
        f"{[round(g['train/loss'], 6) for g in got]}; {ranks[0]['split']} tensors split a rank")

    dirs_one = sorted(p.name for p in (one_dir / "checkpoints").iterdir())
    dirs_two = sorted(p.name for p in (tp_dir / "checkpoints").iterdir())
    writes = [len(r["saves"]) for r in ranks]
    if dirs_two != dirs_one or writes != [len(dirs_two)] + [0] * (len(ranks) - 1):
        raise AssertionError(f"checkpoints {dirs_two} (one process {dirs_one}), writes {writes}")
    for r in ranks:
        if r["restore_differs"] or r["unequal_to_first_rank"] or not r["split"]:
            raise AssertionError(f"rank {r['rank']}: restore differs at "
                                 f"{r['restore_differs'][:5]}, replicated tensors unequal to "
                                 f"rank 0 at {r['unequal_to_first_rank'][:5]}, {r['split']} split")
    a = torch.load(one_dir / "checkpoints" / "checkpoint_epoch_1" / "state.pt",
                   map_location="cuda", weights_only=True)
    b = torch.load(tp_dir / "checkpoints" / "checkpoint_epoch_1" / "state.pt",
                   map_location="cuda", weights_only=True)
    for x, y in ((a["module"], b["module"]), (a["opt_state"]["mu"], b["opt_state"]["mu"]),
                 (a["opt_state"]["nu"], b["opt_state"]["nu"])):
        if {k: v.shape for k, v in x.items()} != {k: v.shape for k, v in y.items()}:
            raise AssertionError("the TP checkpoint's keys or shapes differ from one process's")
    lr = one["lr_max"]
    flipped = n = 0
    worst_p = 0.0
    for key, w in a["module"].items():
        diff = (b["module"][key].float() - w.float()).abs()
        if "running_" in key:
            if (diff - 1e-4 * w.float().abs()).max().item() > 1e-5:
                raise AssertionError(f"BatchNorm {key}: beyond 1e-4 relative + 1e-5")
            continue
        worst_p = max(worst_p, diff.max().item())
        if diff.max().item() > 1e-6 + 1e-3 * lr + 2.1 * lr:
            raise AssertionError(f"{key}: max |diff| {diff.max().item()} beyond 2.1 lr ({lr})")
        flipped += int((diff > 1e-6 + 1e-3 * lr).sum())
        n += w.numel()
    del a, b
    torch.cuda.empty_cache()
    if flipped > 1e-3 * n:
        raise AssertionError(f"{flipped} of {n} parameters beyond 1e-3 lr")
    log(f"[{tag}] checkpoints {dirs_two}, written once and whole (keys and shapes of the "
        f"one-process run's, moments too), restored into each rank's slices bit for bit, "
        f"replicated tensors equal on every rank; final weights: {flipped} of {n} beyond 1e-6 "
        f"+ 1e-3 x lr (lr max {lr:.3e}), max |diff| {worst_p:.3e}")

    per_micro = {k: 0 for k in one["launches"]}
    per_micro.update(flash_fwd=5 * micro, flash_bwd=5 * micro)
    evals = ranks[0]["launches"]["flash_fwd"] - 5 * micro
    for r in ranks:
        train = {k: sum(e["launches"][k] for e in r["epochs"]) for k in per_micro}
        extra = evals if r["rank"] == 0 else 0
        if train != per_micro or r["launches"] != dict(per_micro, flash_fwd=5 * micro + extra):
            raise AssertionError(f"TP rank {r['rank']}: training launches {train}, all "
                                 f"{r['launches']}; want {per_micro} + {extra} forward")
    if evals <= 0 or evals % 10:
        raise AssertionError(f"evaluation launches {evals}")

    def per_step(r):
        return sum(e["seconds"] for e in r["epochs"]) / r["step"]

    log(f"[{tag}] launches: each rank 5 flash forward + 5 fused backward a micro-step "
        f"({micro} micro-steps); evaluations {evals} flash forward on rank 0 only.  On "
        f"{smi}: TP ranks {[round(per_step(r), 2) for r in ranks]} s a step (one process "
        f"{per_step(one):.2f}), all-reduces {[round(r['allreduce_s'], 2) for r in ranks]} s, "
        f"peak {[round(r['peak_gib'], 1) for r in ranks]} GiB a rank (one process "
        f"{one['peak_gib']:.1f}), wall {[round(r['wall_s'], 1) for r in ranks]} s")
    return {k: sum(r["launches"][k] for r in ranks) for k in per_micro}


def _spawn_cp(tmp, env: dict, world: int, data: int) -> list[dict]:
    """``world`` ``cp_rank`` processes over ``data`` data groups."""
    import os
    from pathlib import Path

    code = "import sys, chip_smoke; sys.exit(chip_smoke.cp_rank(sys.argv[1]))"
    runs = []
    for r in range(world):
        res, log_path = tmp / f"cp_rank{r}.json", tmp / f"cp_rank{r}.log"
        with open(log_path, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, "-c", code, json.dumps(dict(out=str(res), data=data))],
                stdout=f, stderr=subprocess.STDOUT,
                env={**os.environ, **env, "IST_PROCESS_ID": str(r)},
                cwd=str(Path(__file__).resolve().parent))
        runs.append((proc, res, log_path))
    return _wait_all(runs, 600)


def _check_cp(tag: str, cp: list) -> dict:
    """The ring's and the context-parallel encoder's errors on every seq
    group's first rank (the bounds ``RING_REL`` and ``CP_REL``), no kernel
    launched by the ring; returns the ranks' launches of the encoder."""
    import numpy as np

    from imagined_speech_translation_tpu_torch.config import default_config

    leads = [r for r in cp if r["lead"]]
    for r in leads:
        if r["ring_out_rel"] > RING_REL or max(r["ring_grad_rel"]) > RING_REL:
            raise AssertionError(f"ring attention at {RING_SHAPE}, rank {r['rank']}: out "
                                 f"{r['ring_out_rel']:.2e}, grads {r['ring_grad_rel']} of max "
                                 f"|ref| (bound {RING_REL})")
        if r["cp_out_rel"] > CP_REL or r["cp_grad_rel"] > CP_REL:
            raise AssertionError(f"encoder seq_shards=2, rank {r['rank']}: out "
                                 f"{r['cp_out_rel']:.2e}, gradients {r['cp_grad_rel']:.2e} at "
                                 f"{r['cp_grad_worst']} (bound {CP_REL})")
    for r in cp:
        if not r["cp_finite"] or r["cp_launches"]["flash_fwd"] or r["cp_launches"]["flash_bwd"]:
            raise AssertionError(f"rank {r['rank']}: ring path finite {r['cp_finite']}, "
                                 f"launched {r['cp_launches']}")
    heads = default_config().model.brain_encoder.region_encoder.attn_heads
    log(f"[{tag}] (c) ring_attention at {RING_SHAPE} f32 (the rows of {len(leads)} data "
        f"group(s)) over two seq ranks against plain attention: out "
        f"{[f'{r['ring_out_rel']:.2e}' for r in leads]}, dq/dk/dv "
        f"{[f'{x:.2e}' for r in leads for x in r['ring_grad_rel']]} of max |ref| (bound "
        f"{RING_REL}); forward + backward {[round(r['ring_s'], 3) for r in cp]} s a rank "
        f"(plain {[round(r['plain_s'], 3) for r in leads]} s), peak "
        f"{[round(r['ring_peak_gib'], 2) for r in cp]} GiB")
    log(f"[{tag}] (b) BrainRegionEncoder at full width (1655 tokens padded to 1656, h 768, "
        f"heads {heads}) on {CP_BATCH} windows, seq_shards=2 over two seq ranks against "
        f"seq_shards=1 in one process: out {[f'{r['cp_out_rel']:.2e}' for r in leads]} of max "
        f"|ref|, gradients of all {leads[0]['n_params']} parameters within "
        f"{[f'{r['cp_grad_rel']:.2e}' for r in leads]} of the largest "
        f"({[f'{r['cp_grad_scale']:.3e}' for r in leads]}; worst "
        f"{sorted({r['cp_grad_worst'] for r in leads})}; bound {CP_REL}), the one process "
        f"with the attention's plain twin; with the flash kernels (3xTF32) out "
        f"{[f'{r['kernel_out_rel']:.2e}' for r in leads]}, gradients "
        f"{[f'{r['kernel_grad_rel']:.2e}' for r in leads]}; forward + backward "
        f"{[round(r['cp_s'], 2) for r in cp]} s a rank (one process, plain twin "
        f"{[round(r['one_s'], 2) for r in leads]} s, kernels "
        f"{[round(r['kernel_s'], 2) for r in leads]} s), peak "
        f"{[round(r['cp_peak_gib'], 2) for r in cp]} GiB a rank")
    return {k: int(np.sum([r["cp_launches"][k] for r in cp])) for k in cp[0]["cp_launches"]}


def phase_tp_cp(smi: str, tmp, one: dict, one_dir):
    """17. Tensor parallelism and ring attention on one card, on the trainer
    phase's corpus.  (a) ``cli.train`` at full width in float32 (the
    multi_device phase's flags) as two ranks with ``parallel.model_axis=2``
    (``IST_BACKEND=gloo``, the ``_TP_RULES`` tensors split, every rank on
    the whole micro-batch of 4), against the multi_device phase's
    one-process run (``_check_tp_run``); the checkpoint served by
    ``cli.serve.build_decode_fn_from_args`` in float32 (beam 3 pinned to
    16), ids equal to the one-process checkpoint's.  (b), (c) ``cp_rank``
    on two ranks (``_check_cp``).  Prints each rank's seconds and peak
    memory.  Returns the launches of (a)'s ranks and of (b)'s ranks."""
    import numpy as np
    import torch

    from imagined_speech_translation_tpu_torch.config import default_config, replace_nested

    cfg = default_config()
    base = ["--data-dir", str(tmp / "data"), "--montage", str(tmp / "montage.csv"),
            "--vocab", str(tmp / "vocab.txt"), "--device", "cuda"]
    for s in DP_SETS:
        base += ["--set", s]
    tp_dir = tmp / "tp_two"
    port = _free_port()
    env = dict(WANDB_MODE="disabled", IST_COORDINATOR=f"127.0.0.1:{port}",
               IST_NUM_PROCESSES=str(TP_RANKS), IST_BACKEND="gloo")
    log(f"[tp_cp] (a) two ranks with IST_COORDINATOR=127.0.0.1:{port} IST_NUM_PROCESSES="
        f"{TP_RANKS} IST_BACKEND=gloo, --set parallel.model_axis={TP_RANKS}; correctness, "
        f"not scaling: both ranks share the card and gloo reduces through the host")
    t0 = time.perf_counter()
    ranks = _wait_all([_spawn_train(tmp, f"tp_rank{r}", base + [
        "--out-dir", str(tp_dir), "--set", f"parallel.model_axis={TP_RANKS}"],
        dict(env, IST_PROCESS_ID=str(r))) for r in range(TP_RANKS)], 600)
    log(f"[tp_cp] (a) processes {time.perf_counter() - t0:.1f} s")
    # 2 steps of grad_accum_steps micro-steps, each of the whole micro-batch
    tp_launches = _check_tp_run(smi, "tp_cp", one, one_dir, ranks, tp_dir,
                                cfg.training.grad_accum_steps * 2)

    scfg = replace_nested(cfg, "generation.min_length", cfg.generation.max_length)
    (tmp / "tp_serve_config.json").write_text(scfg.to_json())
    fargs = dict(vocab=str(tmp / "vocab.txt"), montage=str(tmp / "montage.csv"),
                 config=str(tmp / "tp_serve_config.json"), device="cuda", max_batch=16)
    windows = np.random.default_rng(19).normal(
        size=(16, 125, scfg.data.n_timepoints)).astype(np.float32)
    ids = []
    for d in (one_dir, tp_dir):
        fn, tok = build_recorded(dict(fargs, checkpoint=str(d / "checkpoints" /
                                                           "checkpoint_epoch_1")))
        fn(windows)
        ids.append(tok.history[-1])
        del fn
    torch.cuda.empty_cache()
    if not np.array_equal(ids[0], ids[1]):
        raise AssertionError("the TP checkpoint's ids differ from the one-process checkpoint's")
    log("[tp_cp] (a) serving: the TP checkpoint on one card (f32, beam 3 pinned to 16) gives "
        "the one-process checkpoint's ids on 16 windows")

    env = dict(IST_COORDINATOR=f"127.0.0.1:{_free_port()}", IST_NUM_PROCESSES=str(TP_RANKS),
               IST_BACKEND="gloo")
    cp_launches = _check_cp("tp_cp", _spawn_cp(tmp, env, TP_RANKS, 1))
    return tp_launches, cp_launches


def _trainer_corpus(tmp) -> list:
    """The trainer phase's corpus, montage and vocabulary under ``tmp``;
    returns ``cli.train``'s data flags."""
    from imagined_speech_translation_tpu_torch.cli.profile_slice import synthetic_vocab
    from imagined_speech_translation_tpu_torch.config import default_config
    from imagined_speech_translation_tpu_torch.data import (
        make_synthetic_corpus,
        make_synthetic_montage,
    )

    cfg = default_config()
    make_synthetic_montage(tmp / "montage.csv")
    make_synthetic_corpus(tmp / "data", n_files=10, samples_per_file=8,
                          n_timepoints=cfg.data.n_timepoints, seed=0)
    (tmp / "vocab.txt").write_text("\n".join(synthetic_vocab(cfg.model.bart.vocab_size))
                                   + "\n", encoding="utf-8")
    return ["--data-dir", str(tmp / "data"), "--montage", str(tmp / "montage.csv"),
            "--vocab", str(tmp / "vocab.txt"), "--device", "cuda"]


def multi_card_tp() -> int:
    """Tensor and data parallelism and the ring across four cards over NCCL
    (not part of ``main``, which needs one card): ``python3 -c "import
    chip_smoke as c; c.multi_card_tp()"`` on a machine with four cards.
    The trainer phase's corpus; ``cli.train`` at full width in float32 (the
    multi_device phase's flags) in one process on ``cuda:0``, then as four
    ranks, one a card (``IST_BACKEND`` unset: NCCL), with
    ``parallel.data_axis=2`` and ``parallel.model_axis=2`` (micro-batch 2 a
    rank), held to it by ``_check_tp_run``; then ``cp_rank`` on four ranks
    over a ``{data: 2, seq: 2}`` mesh (``_check_cp``): the ring's blocks
    travel card to card.  Scratch under ``build/``, removed afterwards."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    n = torch.cuda.device_count()
    if n < 4:
        raise SystemExit(f"multi_card_tp needs four cards, found {n}")
    smi = timed(phase_device)
    timed(phase_build)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tp_cards_", dir=build))
    try:
        base = _trainer_corpus(tmp)
        for s in DP_SETS:
            base += ["--set", s]
        (one,) = _wait_all([_spawn_train(tmp, "one", base + [
            "--out-dir", str(tmp / "one"), "--set", "parallel.data_axis=1"],
            {"WANDB_MODE": "disabled"})], 600)
        env = dict(WANDB_MODE="disabled", IST_COORDINATOR=f"127.0.0.1:{_free_port()}",
                   IST_NUM_PROCESSES="4")
        log("[tp_cards] four ranks, one a card, NCCL: --set parallel.data_axis=2 --set "
            "parallel.model_axis=2")
        t0 = time.perf_counter()
        ranks = _wait_all([_spawn_train(tmp, f"rank{r}", base + [
            "--out-dir", str(tmp / "tp"), "--set", "parallel.data_axis=2",
            "--set", "parallel.model_axis=2"], dict(env, IST_PROCESS_ID=str(r)))
            for r in range(4)], 600)
        log(f"[tp_cards] processes {time.perf_counter() - t0:.1f} s")
        from imagined_speech_translation_tpu_torch.config import default_config

        _check_tp_run(smi, "tp_cards", one, tmp / "one", ranks, tmp / "tp",
                      default_config().training.grad_accum_steps * 2)
        env = dict(IST_COORDINATOR=f"127.0.0.1:{_free_port()}", IST_NUM_PROCESSES="4")
        _check_cp("tp_cards", _spawn_cp(tmp, env, 4, 2))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(smi)
    return 0


def run_trainer_and_server(smi: str):
    """The trainer phase, then the server phase on its checkpoint, then the
    graft, reproduce, feed, multi_device and tp_cp phases on its corpus, in
    one scratch directory under ``build/`` that is removed afterwards.
    Returns the trainer, server, graft and reproduce phases' launches and the
    multi_device and tp_cp phases' results."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="trainer_smoke_", dir=build))
    try:
        trainer = timed(phase_trainer, smi, tmp)
        server = timed(phase_server, smi, tmp)
        graft = timed(phase_graft, smi, tmp)
        reproduce = timed(phase_reproduce, smi, tmp)
        timed(phase_feed, smi, tmp)
        torch.cuda.empty_cache()
        *multi, (one, one_dir) = timed(phase_multi_device, smi, tmp)
        torch.cuda.empty_cache()
        tp_cp = timed(phase_tp_cp, smi, tmp, one, one_dir)
        return trainer, server, graft, reproduce, multi, tp_cp
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the check whose numbers head each kernel's entry: the shape and dtype the
# path runs most (serving flash forward at B=16, training backward at
# micro-batch 4 with dropout, the split backward of the eval-mode gradient
# at B=8 in float32, the probe's bf16 tile)
HEADLINE = {
    "sosfilt": lambda c: c["shape"] == [2000, 1651],
    "flash_fwd": lambda c: (c["dtype"] == "bfloat16" and c["shape"] == [384, 1655, 128]
                            and c.get("inputs") == "flat"),
    "flash_bwd": lambda c: (c["dtype"] == "bfloat16" and c["shape"] == [96, 1655, 128]
                            and c["dropout"] > 0),
    "flash_bwd_dq": lambda c: c["dtype"] == "float32" and c["shape"] == [192, 1655, 128],
    "flash_bwd_dkv": lambda c: c["dtype"] == "float32" and c["shape"] == [192, 1655, 128],
    "dropout_mask": lambda c: c["storage"] == "bfloat16",
}


def summary(checks, launches_by_path, mapping_checks):
    """The kernels' JSON line; ``mapping_checks`` (the multi_device phase's
    rows, a rank's launch against the full launch's rows) go to the flash
    forward's and the fused backward's entries."""
    from imagined_speech_translation_tpu_torch import _kernels

    out = []
    for k in _kernels.KERNELS:
        main = next(c for c in checks[k.name] if HEADLINE[k.name](c))
        by_path = {path: n[k.name] for path, n in launches_by_path.items()}
        variants = sorted({c["variant"] for c in checks[k.name] if "variant" in c})
        out.append(dict(
            name=k.name, route="cuda", source=k.source, replaces=k.replaces,
            **({"variants": variants} if variants else {}),
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(c["max_abs_err"] for c in checks[k.name]),
            ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=main["library_ms"], checks=checks[k.name],
            **({"mapping_checks": mapping_checks} if k.name in ("flash_fwd", "flash_bwd")
               else {}),
        ))
    return {"kernels": out}


def timed(phase, *args):
    """``phase(*args)``, with its seconds logged."""
    t0 = time.perf_counter()
    out = phase(*args)
    log(f"[time] {phase.__name__} {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    import torch

    t0 = time.perf_counter()
    smi = timed(phase_device)
    timed(phase_build)
    checks = timed(phase_kernels)
    for phase in (phase_train_kernels, phase_split_kernels):
        for name, rows in timed(phase).items():
            checks.setdefault(name, []).extend(rows)
    decode_fn, serve_launches, ctx = timed(phase_slice, smi)
    timed(phase_card_vs_cpu, ctx)
    timed(phase_serving, decode_fn, ctx["cfg"].data.n_timepoints)
    del decode_fn, ctx
    torch.cuda.empty_cache()
    train_launches = timed(phase_train, smi)
    train_f32_launches = timed(phase_train, smi, False)
    timed(phase_train_card_vs_cpu)
    profile_launches = timed(phase_profile_train, smi)
    torch.cuda.empty_cache()
    (trainer_launches, server_launches, graft_launches, reproduce_launches, multi,
     tp_cp) = run_trainer_and_server(smi)
    mapping_checks, dp_launches, serving_dp_launches = multi
    tp_launches, cp_launches = tp_cp
    features_launches = timed(phase_features, smi)
    wake_launches = timed(phase_wake, smi)
    log(f"[time] all phases {time.perf_counter() - t0:.1f} s")
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log(json.dumps(summary(checks, {"serving": serve_launches, "training": train_launches,
                                    "training_f32": train_f32_launches,
                                    "profile_train": profile_launches,
                                    "trainer": trainer_launches,
                                    "server": server_launches,
                                    "graft": graft_launches,
                                    "reproduce": reproduce_launches,
                                    "features": features_launches,
                                    "data_parallel": dp_launches,
                                    "serving_dp": serving_dp_launches,
                                    "tensor_parallel": tp_launches,
                                    "context_parallel": cp_launches,
                                    "wake": wake_launches}, mapping_checks)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
