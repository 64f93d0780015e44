"""Multi-process proof: one train step over a ``(dcn, data)`` mesh of four
ranks, each a process of its own, against one process.

Port of ``tools/multiproc_proof.py``.  The JAX proof joins two processes of
four CPU devices each into a ``{dcn: 2, data: 4, model: 1}`` mesh.  In the
port a rank is one process, so the proof runs four ranks as ``{dcn: 2,
data: 2, model: 1}``: both batch axes are non-trivial, and rank ``r`` holds
batch shard ``dcn_idx * n_data + data_idx`` (``parallel/mesh.py``).

* a single-process reference runs the step first, in a process of its own;
* four worker processes join the process group through
  ``parallel.distributed.initialize_distributed`` (``IST_COORDINATOR`` /
  ``IST_NUM_PROCESSES`` / ``IST_PROCESS_ID``, the launchers' contract) on
  gloo (NCCL refuses ranks that share a card);
* ``make_mesh(n_dcn=2)`` lays the four ranks out as ``(dcn, data, model)``;
* one full train step (gradient accumulation, the composite loss, the
  fused clip + AdamW) runs on each rank's rows of the micro-batches, the
  gradients all-reduced across the processes;
* the updated state is written once through ``CheckpointManager`` (the
  primary writes, between barriers) and restored on every rank into a
  zeroed copy: parameters, BatchNorm statistics and moments bit for bit;
* the step's loss is held to the single process's within ``1e-5 x max(1,
  |loss|)``.

On the card the products and convolutions run in full float32 (TF32 off),
in the reference as on the ranks: the proof is that the collectives do not
change the math, so no other rounding may enter.

Usage::

    python -m imagined_speech_translation_tpu_torch.cli.multiproc_proof [--device cpu]
        [--out build/multiproc_proof]

Writes ``<out>/result.json`` and prints it as one JSON line.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
N_RANKS = 4
N_DCN = 2
MESH_SHAPE = {"dcn": 2, "data": 2, "model": 1}
LOSS_RTOL = 1e-5
_IST_ENV = ("IST_COORDINATOR", "IST_NUM_PROCESSES", "IST_PROCESS_ID", "IST_DISTRIBUTED",
            "IST_BACKEND")


# ---------------------------------------------------------------------------
# the model and the step (identical in every mode)
# ---------------------------------------------------------------------------


def _tiny_setup(device):
    """Config, numpy data and a fresh float32 train state on ``device``,
    identical in every process (a function of fixed seeds).  The numpy draws
    are the JAX proof's, in its order."""
    import numpy as np

    from ..config import (
        AugmentationConfig,
        BartConfig,
        BrainEncoderConfig,
        Config,
        DataConfig,
        LossConfig,
        ModelConfig,
        OptimizerConfig,
        RegionEncoderConfig,
        TrainingConfig,
    )
    from ..training import (
        AdaptiveLossScheduler,
        FusedAdamW,
        build_train_module,
        create_train_state,
    )

    h = 48
    micro = 8  # divisible by the dcn x data = 4 batch shards
    cfg = Config(
        data=DataConfig(
            n_timepoints=64, max_length=8,
            augmentation=AugmentationConfig(enabled=False),
        ),
        model=ModelConfig(
            hidden_dim=h,
            max_region_channels=16,
            region_channel_counts=(16, 9, 11, 12),
            brain_encoder=BrainEncoderConfig(
                hidden_dim=h, fusion_heads=4, cross_region_heads=4,
                region_encoder=RegionEncoderConfig(
                    conv_channels=(8, 16, 24, 32, 48),
                    attn_heads=(4, 2, 2), se_reduction=4,
                ),
            ),
            bart=BartConfig(
                vocab_size=128, d_model=h, encoder_layers=3, decoder_layers=2,
                num_heads=4, ffn_dim=96, max_position_embeddings=32,
            ),
        ),
        training=TrainingConfig(
            batch_size=micro, grad_accum_steps=2,
            mixed_precision=False,  # the proof holds the float32 math
            optimizer=OptimizerConfig(warmup_steps=2),
            loss=LossConfig(bow_vocab_size=16),
        ),
    ).validate()
    tc = cfg.training

    rng = np.random.default_rng(0)
    mask = np.zeros((4, 16), bool)
    for r, c in enumerate(cfg.model.region_channel_counts):
        mask[r, :c] = True
    # the JAX proof's init sample: drawn for the stream's sake (the port's
    # module is initialized from its seed, without a sample)
    rng.normal(size=(micro, 4, 16, 64))
    rng.integers(0, 128, (micro, 8))
    rng.integers(0, 128, (micro, 8))
    batch_np = {
        "eeg": rng.normal(size=(tc.grad_accum_steps, micro, 4, 16, 64)).astype(np.float32),
        "decoder_input_ids": rng.integers(
            0, 128, (tc.grad_accum_steps, micro, 8)).astype(np.int32),
        "labels": rng.integers(0, 128, (tc.grad_accum_steps, micro, 8)).astype(np.int32),
        "attention_mask": np.ones((tc.grad_accum_steps, micro, 8), np.int32),
        "channel_mask": mask,
    }
    bow = list(range(16))
    module = build_train_module(cfg, len(bow), seed=0, device=device)
    optimizer = FusedAdamW([n for n, _ in module.named_parameters()], tc.optimizer,
                           total_steps=10)
    weights = AdaptiveLossScheduler(tc.loss).initial_weights()
    state = create_train_state(module, optimizer, weights)
    return cfg, module, optimizer, bow, state, batch_np, mask


def _full_f32(device) -> None:
    """Products and convolutions in full float32 on the card."""
    import torch

    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _run_step(device, mesh=None):
    """Build the state and the batch, run ONE train step (on this rank's
    rows with ``mesh``); returns (loss, new_state, the rows' shard)."""
    import numpy as np
    import torch

    from ..parallel import data_parallel as dpx
    from ..parallel.mesh import shard_batch, shard_train_state
    from ..training import make_train_step

    _full_f32(device)
    cfg, module, optimizer, bow, state, batch_np, _ = _tiny_setup(device)
    dp = None
    if mesh is not None:
        state = shard_train_state(state, mesh)
        dp = dpx.DataParallel.of(mesh)
        batch_np = shard_batch(mesh, batch_np, batch_axis=1)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch_np.items()}
    step = make_train_step(module, optimizer, cfg, bow, data_parallel=dp)
    new_state, metrics = step(state, batch, torch.Generator().manual_seed(1))
    return float(metrics["loss"]), new_state, batch_np


def _state_tensors(state) -> dict:
    out = {f"module.{k}": v for k, v in state.module.state_dict().items()}
    out.update({f"mu.{k}": v for k, v in state.opt_state.mu.items()})
    out.update({f"nu.{k}": v for k, v in state.opt_state.nu.items()})
    return out


def _zeroed(state):
    """A copy of ``state`` with every tensor zero."""
    import torch

    zeroed = copy.deepcopy(state)
    with torch.no_grad():
        for t in _state_tensors(zeroed).values():
            t.zero_()
    return zeroed


def _trees_equal(a, b) -> bool:
    import torch

    ta, tb = _state_tensors(a), _state_tensors(b)
    return ta.keys() == tb.keys() and all(torch.equal(ta[k], tb[k]) for k in ta)


# ---------------------------------------------------------------------------
# modes
# ---------------------------------------------------------------------------


def run_worker(out_dir: Path, device: str) -> None:
    """One of the four ranks (configured by the ``IST_*`` variables)."""
    import torch

    from ..parallel import make_mesh
    from ..parallel.distributed import (
        host_barrier,
        initialize_distributed,
        is_primary,
        process_count,
        process_index,
        rank_device,
    )
    from ..training.checkpoint import CheckpointManager

    assert initialize_distributed(device=device), "coordinator env not picked up"
    assert process_count() == N_RANKS, process_count()
    dev = rank_device(device)
    mesh = make_mesh(n_dcn=N_DCN)
    # the ranks with index 0 on each axis: the processes an axis spans
    spread = {ax: sorted(r for r in mesh.devices if mesh.coords(r)[ax] == 0)
              for ax in mesh.axis_names}
    host_barrier("step_start", timeout_s=1800.0)
    from .. import _kernels

    _kernels.reset_launch_counts()
    loss, new_state, rows = _run_step(dev, mesh)
    launches = _kernels.launch_counts()

    ckpt = CheckpointManager(out_dir / "ckpt")
    ckpt.save_best(new_state, {"epoch": 0, "loss": loss})
    restored, meta = ckpt.restore("best_model", _zeroed(new_state))
    roundtrip_ok = _trees_equal(new_state, restored) and meta["epoch"] == 0
    rank = process_index()
    (out_dir / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank,
        "loss": loss,
        "coords": mesh.coords(),
        "shard_index": mesh.shard_index(),
        "eeg_sum": float(rows["eeg"].astype("float64").sum()),
        "checkpoint_roundtrip_ok": bool(roundtrip_ok),
        "step": int(new_state.step),
        "device": str(dev),
        "launches": launches,
    }))
    host_barrier("proof_done", timeout_s=1800.0)
    if is_primary():
        (out_dir / "worker_result.json").write_text(json.dumps({
            "process_count": process_count(),
            "mesh_shape": dict(mesh.shape),
            "mesh_axis_process_spread": spread,
            "backend": torch.distributed.get_backend(),
            "checkpoint_files": sorted(
                str(p.relative_to(out_dir / "ckpt")) for p in (out_dir / "ckpt").rglob("*")),
        }))
    host_barrier("proof_written", timeout_s=1800.0)


def run_single(out_dir: Path, device: str) -> None:
    """The single-process reference: the same step on one device, all eight
    rows of each micro-batch."""
    import numpy as np
    import torch

    from .. import _kernels

    _kernels.reset_launch_counts()
    loss, _, batch_np = _run_step(torch.device(device))
    n = batch_np["eeg"].shape[1] // N_RANKS
    (out_dir / "single_result.json").write_text(json.dumps({
        "loss": loss,
        "launches": _kernels.launch_counts(),
        "shard_eeg_sums": [float(batch_np["eeg"][:, i * n:(i + 1) * n].astype(np.float64).sum())
                           for i in range(N_RANKS)],
    }))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(args: list, env: dict, out_dir: Path, tag: str):
    log = open(out_dir / f"{tag}.log", "w")
    return subprocess.Popen([sys.executable, "-m", __spec__.name, *args], env=env,
                            cwd=str(REPO), stdout=log, stderr=subprocess.STDOUT), log


def _wait(procs, timeout: float, out_dir: Path) -> None:
    t_end = time.time() + timeout
    try:
        for tag, (proc, log) in procs.items():
            rc = proc.wait(timeout=max(1.0, t_end - time.time()))
            log.close()
            if rc != 0:
                tail = (out_dir / f"{tag}.log").read_text()[-3000:]
                raise RuntimeError(f"{tag} failed (rc={rc}):\n{tail}")
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


def orchestrate(out_dir: Path, *, device: str = "cuda", timeout: float = 1800.0) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    base_env = {k: v for k, v in os.environ.items() if k not in _IST_ENV}
    if device == "cpu":
        # five processes share the host's cores; the tiny step needs one each
        base_env.setdefault("OMP_NUM_THREADS", "1")
    t0 = time.time()
    dev = ["--device", device, "--out", str(out_dir)]
    _wait({"single": _spawn(["--single", *dev], base_env, out_dir, "single")}, timeout,
          out_dir)

    port = _free_port()
    workers = {}
    for i in range(N_RANKS):
        env = dict(base_env, IST_COORDINATOR=f"127.0.0.1:{port}",
                   IST_NUM_PROCESSES=str(N_RANKS), IST_PROCESS_ID=str(i), IST_BACKEND="gloo")
        workers[f"worker{i}"] = _spawn(["--worker", str(i), *dev], env, out_dir, f"worker{i}")
    _wait(workers, timeout, out_dir)

    single = json.loads((out_dir / "single_result.json").read_text())
    wres = json.loads((out_dir / "worker_result.json").read_text())
    ranks = [json.loads((out_dir / f"rank{i}.json").read_text()) for i in range(N_RANKS)]
    losses = [r["loss"] for r in ranks]
    delta = max(abs(x - single["loss"]) for x in losses)
    # each rank's shard is the row block dcn_idx * n_data + data_idx
    n_data = MESH_SHAPE["data"]
    rows_ok = all(
        r["shard_index"] == r["coords"]["dcn"] * n_data + r["coords"]["data"]
        and r["eeg_sum"] == single["shard_eeg_sums"][r["shard_index"]] for r in ranks
    ) and sorted(r["shard_index"] for r in ranks) == list(range(N_RANKS))
    roundtrip_ok = all(r["checkpoint_roundtrip_ok"] for r in ranks)
    written_once = wres["checkpoint_files"] == ["best_model", "best_model/meta.json",
                                                "best_model/state.pt"]
    result = {
        "ok": (
            wres["process_count"] == N_RANKS
            and wres["mesh_shape"] == MESH_SHAPE
            and roundtrip_ok and written_once and rows_ok
            and delta <= LOSS_RTOL * max(1.0, abs(single["loss"]))
        ),
        "loss_multiprocess": losses[0],
        "loss_multiprocess_by_rank": losses,
        "loss_singleprocess": single["loss"],
        "loss_delta": delta,
        "loss_bound": LOSS_RTOL * max(1.0, abs(single["loss"])),
        "elapsed_s": round(time.time() - t0, 1),
        "checkpoint_roundtrip_ok": roundtrip_ok,
        "checkpoint_written_once": written_once,
        "rows_by_shard_ok": rows_ok,
        "ranks": [{k: r[k] for k in ("rank", "coords", "shard_index", "device", "step")}
                  for r in ranks],
        "device": device,
        # the kernels' launches in the five processes, the reference's and
        # the ranks' (the tiny windows' tokens, fewer than 128, take the
        # softmax route)
        "launches": {k: single["launches"][k] + sum(r["launches"][k] for r in ranks)
                     for k in single["launches"]},
        **wres,
    }
    (out_dir / "result.json").write_text(json.dumps(result, indent=2))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--single", action="store_true")
    ap.add_argument("--out", default=str(REPO / "build" / "multiproc_proof"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default; the ranks share the card over gloo) or cpu")
    args = ap.parse_args(argv)
    out = Path(args.out)
    if args.single:
        run_single(out, args.device)
        return 0
    if args.worker is not None:
        run_worker(out, args.device)
        return 0
    if args.device == "cuda":
        from .train import check_device

        check_device(args.device)
    result = orchestrate(out, device=args.device)
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
