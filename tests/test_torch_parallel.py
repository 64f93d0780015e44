"""Data parallelism (ROADMAP 1.7a) on the CPU: two gloo ranks of the port
against the port on one device, and against JAX's ``make_mesh(2, 1)`` step.

Two processes are spawned once for the module (the ``ranks`` fixture) with
``IST_COORDINATOR``, ``IST_NUM_PROCESSES=2``, ``IST_PROCESS_ID`` and
``IST_BACKEND=gloo``; each runs every scenario below in turn and writes its
results to a file, and the tests hold them to single-device runs made in
this process:

* the data-parallel train step with dropout on, two steps, against the
  port's single-device step on the same window (the same dropout bits);
* the same step with dropout neutralised (as ``tests/test_torch_train_step.py``
  does) against JAX's step over a 2-device mesh, one step;
* the step with each piece of the global-batch semantics made naive: a
  per-rank token count in the cross-entropy, per-rank InfoNCE, diversity and
  variance terms, per-rank BatchNorm statistics.  Each naive run must miss
  the single-device loss, which the real one meets;
* ``cli.train`` with ``--set parallel.data_axis=2`` for one epoch (an
  evaluation, a checkpoint, the test evaluation), then ``--resume`` for a
  second, against the same commands on one device; and with ``dcn_axis=2,
  data_axis=1``, which must equal ``data_axis=2``;
* a micro-batch that does not split over the ranks, the barriers, and
  ``device_prefetch(sharding=)``.

Sizes: ``tests.helpers.tiny_config``.  The steps run at T = 124 (the region
attention takes the flash route, the kernels' plain twin with the head
mapping), micro-batch 4 (2 rows a rank, rank 1's labels padded more than
rank 0's), accumulation 2, label length 6.  The trainer runs at T = 64 (the
softmax route), micro-batch 2 (1 row a rank).

Tolerances (float32): losses and components within 2e-4 relative (the JAX
test's bound, ``tests/test_parallel.py``), the trainer's losses within 1e-4;
parameters by ``tests/test_torch_train_step.py``'s rule: within 1e-6 plus
1e-3 of the step's largest learning rate, except at most 0.1% of the
entries, which stay within 2.1 learning rates; BatchNorm running statistics
within 1e-5 of the single device and equal on both ranks; predictions
identical.
"""

import dataclasses
import functools
import multiprocessing
import os
import pickle
import socket
import traceback
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagined_speech_translation_tpu.parallel import batch_sharding as jax_batch_sharding
from imagined_speech_translation_tpu.parallel import make_mesh as jax_make_mesh
from imagined_speech_translation_tpu.parallel import shard_train_state as jax_shard_state
from imagined_speech_translation_tpu.parallel.mesh import shard_batch as jax_shard_batch
from imagined_speech_translation_tpu.training import AdaptiveLossScheduler as JaxScheduler
from imagined_speech_translation_tpu.training import TrainModule as JaxTrainModule
from imagined_speech_translation_tpu.training import TrainState as JaxTrainState
from imagined_speech_translation_tpu.training import build_optimizer as jax_build_optimizer
from imagined_speech_translation_tpu.training import make_train_step as jax_make_train_step
from imagined_speech_translation_tpu_torch import config
from imagined_speech_translation_tpu_torch.cli import train as train_cli
from imagined_speech_translation_tpu_torch.convert import convert_variables, load_flax_variables
from imagined_speech_translation_tpu_torch.data.feed import device_prefetch
from imagined_speech_translation_tpu_torch.ops import flash_attention
from imagined_speech_translation_tpu_torch.ops.dropout_mask import dropout_keep_mask_reference
from imagined_speech_translation_tpu_torch.parallel import (
    batch_sharding,
    host_barrier,
    initialize_distributed,
    is_primary,
    make_mesh,
    shard_train_state,
    sync_hosts,
)
from imagined_speech_translation_tpu_torch.parallel import data_parallel as dpx
from imagined_speech_translation_tpu_torch.parallel import distributed
from imagined_speech_translation_tpu_torch.parallel.distributed import choose_backend
from imagined_speech_translation_tpu_torch.parallel.mesh import shard_batch
from imagined_speech_translation_tpu_torch.training import (
    FusedAdamW,
    TrainModule,
    create_train_state,
    learning_rates_at,
    losses,
    make_train_step,
)
from tests.helpers import TINY_VOCAB, build_dataset, tiny_config, tiny_tokenizer
from tests.test_torch_models import seeded_flax_variables
from tests.test_torch_train_step import _no_dropout_jax, _no_dropout_port

T, B, ACCUM, L = 124, 4, 2, 6
BOW = list(range(110, 126))
TOTAL_STEPS = 10
COMPONENTS = ("loss_ce", "loss_align", "loss_bow", "loss_div", "loss_var")
NAIVE = ("ce_count", "coupled", "batchnorm")
RANK_TIMEOUT_S = 300


def _batch(cfg, seed):
    """A window ``(accum, B, ...)`` made with numpy; rows 2 and 3 (rank 1's)
    carry shorter labels than rows 0 and 1 (rank 0's), and EEG of another
    mean and scale, so that per-rank BatchNorm statistics are not the
    batch's."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((4, 16), bool)
    for r, n in enumerate(cfg.model.region_channel_counts):
        mask[r, :n] = True
    eeg = rng.normal(size=(ACCUM, B, 4, 16, T))
    eeg[:, 2:] = 2.0 * eeg[:, 2:] + 1.0
    eeg = eeg * mask[None, None, :, :, None]
    vocab = cfg.model.bart.vocab_size
    ids = rng.integers(105, vocab, (ACCUM, B, L))
    labels = np.concatenate([ids[..., 1:], rng.integers(105, vocab, (ACCUM, B, 1))], axis=-1)
    attn = np.ones((ACCUM, B, L), np.int32)
    for row, n in ((2, 2), (3, 3)):
        attn[:, row, n:] = 0
        labels[:, row, n:] = -100
    return dict(eeg=eeg.astype(np.float32), decoder_input_ids=ids.astype(np.int32),
                labels=labels.astype(np.int32), attention_mask=attn, channel_mask=mask)


def _step_cfg():
    tok = tiny_tokenizer()
    cfg = tiny_config(tok.vocab_size, n_timepoints=T)
    return cfg.replace(training=dataclasses.replace(
        cfg.training, batch_size=B, grad_accum_steps=ACCUM,
        loss=dataclasses.replace(cfg.training.loss, bow_vocab_size=len(BOW))))


def _trainer_cfg():
    cfg = tiny_config(tiny_tokenizer().vocab_size)
    tc = cfg.training
    cfg = cfg.replace(training=dataclasses.replace(
        tc, num_epochs=1, checkpoint=dataclasses.replace(
            tc.checkpoint, save_interval_epochs=1, max_to_keep=1)))
    return config.Config.from_json(cfg.to_json())


def _tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the port's step, on one device or on this rank's rows
# ---------------------------------------------------------------------------


def _naive(mp, kind):
    """The data-parallel step made naive in one respect (see the module
    docstring); each rank's loss stays a ``1 / world`` share."""
    if kind == "ce_count":
        ce = losses.label_smoothed_ce

        def local_count_ce(logits, labels, **kw):
            with dpx.installed(None, 0):
                loss, n = ce(logits, labels, **kw)
            return loss / dpx.active().world, n

        mp.setattr(losses, "label_smoothed_ce", local_count_ce)
    elif kind == "coupled":
        mp.setattr(dpx, "gather_rows", lambda t: t)
    elif kind == "batchnorm":
        mp.setattr(dpx, "all_reduce_sum", lambda t: t)


def _port_steps(setup, n_steps, *, dropout, mesh=None, naive=None):
    """``n_steps`` port train steps from the setup's weights: on one device
    without ``mesh``, on this rank's rows of each window with it.  Returns
    the metrics and the final module state."""
    cfg = setup["cfg"]
    module = TrainModule(cfg, bow_k=len(BOW))
    module.load_state_dict(setup["state_dict"])
    opt = FusedAdamW([n for n, _ in module.named_parameters()], cfg.training.optimizer,
                     TOTAL_STEPS)
    state = create_train_state(module, opt, setup["weights"])
    dp = None
    if mesh is not None:
        state = shard_train_state(state, mesh)
        dp = dpx.DataParallel.of(mesh)
    step = make_train_step(module, opt, cfg, BOW, data_parallel=dp)
    out = []
    with pytest.MonkeyPatch.context() as mp:
        if not dropout:
            _no_dropout_port(mp)
        if naive:
            _naive(mp, naive)
        for i in range(n_steps):
            batch = setup["batches"][i]
            if mesh is not None:
                batch = shard_batch(mesh, batch, batch_axis=1)
            state, metrics = step(state, _tensors(batch), torch.Generator().manual_seed(i))
            out.append({k: float(v) for k, v in metrics.items()})
    return out, {k: v.clone() for k, v in state.module.state_dict().items()}


COUPLED = ("loss_align", "loss_div", "loss_var")


def _coupled_inputs():
    """``composite_loss``'s inputs for 4 rows, 2 a rank, in two overlapping
    clusters (one a rank), so each batch-coupled term of one rank's rows is
    far from the batch's."""
    rng = np.random.default_rng(5)
    centre = np.zeros((2, 8))
    centre[:, :4] = centre[1, 4:] = 1.0
    centre = np.repeat(centre, 2, axis=0)
    return dict(
        logits=rng.normal(size=(4, 3, 16)), labels=rng.integers(0, 16, (4, 3)),
        eeg_feat=centre + 0.5 * rng.normal(size=(4, 8)),
        decoder_hidden=centre[:, None] + 0.5 * rng.normal(size=(4, 3, 8)),
        decoder_mask=np.ones((4, 3)))


def _coupled_losses(rows, dp=None):
    """``composite_loss`` on ``rows`` of :func:`_coupled_inputs` (under
    ``dp``): the components and the gradients of the total with respect to
    the EEG features and the decoder states of those rows."""
    x = {k: torch.tensor(v[rows], dtype=torch.int64 if k == "labels" else torch.float32)
         for k, v in _coupled_inputs().items()}
    leaves = [x["eeg_feat"].requires_grad_(), x["decoder_hidden"].requires_grad_()]
    with dpx.installed(dp, len(rows)):
        total, comps = losses.composite_loss(
            **x, heads_apply=lambda e, t: (e, t, e[:, :4]), bow_indices=torch.arange(4),
            weights=dict.fromkeys(("ce", "align", "bow", "div", "var"), 1.0),
            cfg=_step_cfg().training.loss)
        grads = torch.autograd.grad(total, leaves)
    return {k: float(v.detach()) for k, v in comps.items()}, [g.numpy() for g in grads]


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _cli_args(root, cfg_name, *extra):
    return ["--data-dir", str(root / "corpus" / "data"),
            "--montage", str(root / "corpus" / "montage.csv"),
            "--vocab", str(root / "vocab.txt"), "--config", str(root / cfg_name),
            "--device", "cpu", *extra]


def _cli_run(args) -> dict:
    """``cli.train.main(args)``'s results that the tests read."""
    res = train_cli.main(args)
    state, trainer = res["state"], res["trainer"]
    return dict(
        step=state.step,
        test=res["test_metrics"],
        module={k: v.clone() for k, v in state.module.state_dict().items()},
        ckpts=sorted(p.name for p in trainer.ckpt.dir.iterdir()),
        start_epoch=trainer.start_epoch,
    )


def _rank_scenarios(root) -> dict:
    with open(root / "setup.pkl", "rb") as f:
        setup = pickle.load(f)
    mesh = make_mesh(2, 1)
    out = {"shard": mesh.shard_index(), "primary": is_primary()}
    host_barrier("scenarios")
    sync_hosts("scenarios")
    out["dropout"] = _port_steps(setup, 2, dropout=True, mesh=mesh)
    out["no_dropout"] = _port_steps(setup, 1, dropout=False, mesh=mesh)
    for kind in NAIVE:
        out[kind] = _port_steps(setup, 1, dropout=False, mesh=mesh, naive=kind)
    rows, dp = [2 * out["shard"], 2 * out["shard"] + 1], dpx.DataParallel.of(mesh)
    out["coupled_terms"] = _coupled_losses(rows, dp)
    with pytest.MonkeyPatch.context() as mp:
        _naive(mp, "coupled")
        out["coupled_terms_naive"] = _coupled_losses(rows, dp)
    batches = [setup["batches"][0]["eeg"][0], setup["batches"][1]["eeg"][0]]
    out["prefetch"] = [b["eeg"] for b in device_prefetch(
        iter([{"eeg": e} for e in batches]), sharding=mesh, device="cpu")]

    dp = _cli_args(root, "trainer.json", "--set", "parallel.data_axis=2")
    out["cli"] = _cli_run(dp + ["--out-dir", str(root / "dp")])
    out["cli_resume"] = _cli_run(dp + ["--out-dir", str(root / "dp"), "--resume",
                                       "--set", "training.num_epochs=2"])
    out["cli_dcn"] = _cli_run(_cli_args(root, "trainer.json", "--set", "parallel.dcn_axis=2",
                                        "--set", "parallel.data_axis=1",
                                        "--out-dir", str(root / "dcn")))
    try:
        _cli_run(_cli_args(root, "odd.json", "--set", "parallel.data_axis=2",
                           "--out-dir", str(root / "odd")))
    except ValueError as e:
        out["odd"] = str(e)
    return out


def _rank_main(rank: int, port: int, root) -> None:
    """One rank: joins the process group through the ``IST_*`` variables,
    runs the scenarios and writes ``rank{rank}.pkl`` (or the traceback)."""
    os.environ.update(IST_COORDINATOR=f"127.0.0.1:{port}", IST_NUM_PROCESSES="2",
                      IST_PROCESS_ID=str(rank), IST_BACKEND="gloo", WANDB_MODE="disabled")
    torch.set_num_threads(2)
    try:
        assert initialize_distributed(device="cpu")
        out = _rank_scenarios(root)
    except BaseException:
        (root / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    with open(root / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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
    root = tmp_path_factory.mktemp("parallel")
    cfg = _step_cfg()
    jm = JaxTrainModule(cfg, bow_k=len(BOW))
    b0 = _batch(cfg, 0)
    init = SimpleNamespace(init=functools.partial(jm.init, method="init_all"))
    variables = seeded_flax_variables(
        init, b0["eeg"][0], b0["decoder_input_ids"][0], b0["channel_mask"], seed=3)
    module = load_flax_variables(TrainModule(cfg, bow_k=len(BOW)), variables)
    s = dict(cfg=cfg, state_dict=module.state_dict(), variables=variables, jm=jm,
             weights=JaxScheduler(cfg.training.loss).initial_weights(),
             batches=[_batch(cfg, 1), _batch(cfg, 2)])
    with open(root / "setup.pkl", "wb") as f:
        pickle.dump({k: s[k] for k in ("cfg", "state_dict", "weights", "batches")}, f)

    build_dataset(root / "corpus", tiny_tokenizer(), tiny_config(tiny_tokenizer().vocab_size))
    (root / "vocab.txt").write_text("\n".join(dict.fromkeys(TINY_VOCAB)) + "\n",
                                    encoding="utf-8")
    tcfg = _trainer_cfg()
    (root / "trainer.json").write_text(tcfg.to_json())
    (root / "odd.json").write_text(tcfg.replace(training=dataclasses.replace(
        tcfg.training, batch_size=3)).to_json())
    s["root"] = root
    return s


@pytest.fixture(scope="module")
def ranks(setup):
    """Both ranks' results, from one spawn of two processes."""
    root = setup["root"]
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, port, root)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(RANK_TIMEOUT_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [(root / f"rank{r}.err").read_text() for r in range(2)
              if (root / f"rank{r}.err").exists()]
    assert not errors, "\n".join(errors)
    assert [p.exitcode for p in procs] == [0, 0]
    out = []
    for r in range(2):
        with open(root / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def single(setup):
    """The port's single-device steps on the same windows."""
    return {"dropout": _port_steps(setup, 2, dropout=True),
            "no_dropout": _port_steps(setup, 1, dropout=False)}


def _assert_metrics_close(got, want, rtol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


def _assert_params_close(got, want, lr_max, *, bn_atol=1e-5):
    """``tests/test_torch_train_step.py``'s rule; BatchNorm running
    statistics within ``bn_atol``."""
    flipped = n = 0
    for key, w in want.items():
        g = got[key]
        if "running_" in key:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=bn_atol,
                                       err_msg=key)
            continue
        diff = (g.float() - w.float()).abs()
        assert diff.max() <= 1e-6 + 1e-3 * lr_max + lr_max * 2.1, key
        flipped += int((diff > 1e-6 + 1e-3 * lr_max).sum())
        n += w.numel()
    assert flipped <= 1e-3 * n, f"{flipped} of {n} parameters moved differently"


def _lr_max(cfg, n_steps):
    """The largest learning rate of the first ``n_steps`` steps."""
    return max(max(learning_rates_at(cfg.training.optimizer, TOTAL_STEPS, s).values())
               for s in range(n_steps))


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1])
def test_dp_step_with_dropout_matches_one_device(ranks, single, step):
    want = single["dropout"][0][step]
    for rank in ranks:
        _assert_metrics_close(rank["dropout"][0][step], want, 2e-4)


def test_dp_step_weights_and_batch_stats_match_one_device(setup, ranks, single):
    want = single["dropout"][1]
    _assert_params_close(ranks[0]["dropout"][1], want, _lr_max(setup["cfg"], 2))
    for key, v in ranks[0]["dropout"][1].items():
        assert torch.equal(v, ranks[1]["dropout"][1][key]), key


def test_dp_step_differs_without_dropout(ranks, single):
    """The dropout run is a dropout run: its loss is not the rate-0 loss."""
    got = ranks[0]["dropout"][0][0]["loss"]
    assert abs(got - single["no_dropout"][0][0]["loss"]) > 1e-3 * abs(got)


@pytest.fixture(scope="module")
def jax_mesh_step(setup, eight_devices):
    """JAX's step over a ``make_mesh(2, 1)`` mesh (the batch sharded on its
    micro axis), dropout neutralised: one step."""
    cfg, v = setup["cfg"], setup["variables"]
    params = jax.tree.map(jnp.asarray, v["params"])
    opt = jax_build_optimizer(params, cfg.training.optimizer, TOTAL_STEPS)
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]), opt_state=opt.init(params),
        loss_weights={k: jnp.float32(w) for k, w in setup["weights"].items()},
    )
    mesh = jax_make_mesh(2, 1, devices=eight_devices[:2])
    batch = {k: jnp.asarray(a) for k, a in setup["batches"][0].items()}
    sharded = jax_shard_batch(mesh, {k: a for k, a in batch.items() if k != "channel_mask"},
                              batch_axis=1)
    sharded["channel_mask"] = batch["channel_mask"]
    with pytest.MonkeyPatch.context() as mp:
        _no_dropout_jax(mp)
        step = jax.jit(jax_make_train_step(setup["jm"], opt, cfg, BOW))
        state, metrics = step(jax_shard_state(state, mesh), sharded, jax.random.key(0))
    return state, {k: float(m) for k, m in metrics.items()}


def test_dp_step_matches_jax_mesh_step(setup, ranks, jax_mesh_step):
    jax_state, want = jax_mesh_step
    metrics, module = ranks[0]["no_dropout"]
    _assert_metrics_close(metrics[0], want, 2e-4)
    ref = convert_variables(
        {"params": jax.tree.map(np.asarray, jax_state.params),
         "batch_stats": jax.tree.map(np.asarray, jax_state.batch_stats)},
        TrainModule(setup["cfg"], bow_k=len(BOW)))
    _assert_params_close(module, ref, _lr_max(setup["cfg"], 1), bn_atol=1e-4)


@pytest.mark.parametrize("kind", NAIVE)
def test_naive_global_batch_semantics_fail(ranks, single, kind):
    """The real step meets the single-device loss; the naive one misses it
    (so this check has the power to catch each).  The model's features at
    these weights are nearly constant over the batch, so the diversity and
    variance terms hardly see the batch: the coupled case reads the
    alignment term here, and every coupled term in
    :func:`test_coupled_losses_use_the_global_batch`."""
    want = single["no_dropout"][0][0]
    _assert_metrics_close(ranks[0]["no_dropout"][0][0], want, 2e-4)
    naive = ranks[0][kind][0][0]
    names = {"ce_count": ["loss_ce"], "coupled": ["loss_align"], "batchnorm": ["loss"]}[kind]
    for k in names:
        assert not np.isclose(naive[k], want[k], rtol=2e-4, atol=0), k


def test_coupled_losses_use_the_global_batch(ranks):
    """``composite_loss`` on two clustered ranks: the ranks' components sum
    to the one-device components, and the gradients of the rows (through the
    gather's backward, which sums over ranks) equal the one-device gradients
    at their scale; with per-rank terms the alignment, diversity and
    variance sums miss."""
    want, want_grads = _coupled_losses([0, 1, 2, 3])
    for k, v in want.items():
        got = sum(r["coupled_terms"][0][k] for r in ranks)
        np.testing.assert_allclose(got, v, rtol=1e-5, err_msg=k)
    for i, g in enumerate(want_grads):
        got = np.concatenate([r["coupled_terms"][1][i] for r in ranks])
        np.testing.assert_allclose(got, g, rtol=1e-5, atol=1e-7)
    for k in COUPLED:
        naive = sum(r["coupled_terms_naive"][0][k] for r in ranks)
        assert not np.isclose(naive, want[k], rtol=2e-4, atol=0), k


def test_naive_batchnorm_moves_running_statistics(ranks, single):
    want = single["no_dropout"][1]
    for key, w in want.items():
        if "running_mean" in key:
            assert not torch.allclose(ranks[0]["batchnorm"][1][key], w, rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(ranks[0]["no_dropout"][1][key], w, rtol=1e-4, atol=1e-5)


def test_identity_head_mapping_draws_other_masks():
    """A rank's mask rows equal the full batch's rows only with the head
    mapping: the flash masks of rank 1 of 2 over (regions 2, rows 2, heads
    3), against the single-device launch over 4 rows."""
    kw = dict(block_q=128, block_k=128, rate=0.1)
    full = dropout_keep_mask_reference(7, 2 * 4, 3, 128, 128, **kw).reshape(2, 4, 3, 128, 128)
    mapped = dropout_keep_mask_reference(7, 2 * 2, 3, 128, 128, rows=(2, 4, 2), **kw)
    assert torch.equal(mapped.reshape(2, 2, 3, 128, 128), full[:, 2:])
    identity = dropout_keep_mask_reference(7, 2 * 2, 3, 128, 128, **kw)
    assert not torch.equal(identity.reshape(2, 2, 3, 128, 128), full[:, 2:])


def test_tile_id_limit_binds_the_global_head_count():
    """A rank's launch of 2 heads over rows ``(1, 20000, 0)`` stands for
    40000 single-device heads, past the tile id's packing: it raises, as
    the single-device launch would; a mapping its launch cannot carry
    raises too."""
    q = torch.zeros((2, 1, 8, 8))
    kw = dict(dropout_rate=0.1, dropout_seed=1)
    with pytest.raises(ValueError, match="32768"):
        flash_attention(q, q, q, dropout_rows=(1, 20000, 0), **kw)
    flash_attention(q, q, q, dropout_rows=(1, 16000, 0), **kw)
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention(q, q, q, dropout_rows=(2, 4, 3), **kw)


# ---------------------------------------------------------------------------
# the trainer through cli.train
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def single_cli(setup, tmp_path_factory):
    root = setup["root"]
    out = tmp_path_factory.mktemp("single_cli")
    args = _cli_args(root, "trainer.json", "--set", "parallel.data_axis=1")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WANDB_MODE", "disabled")  # metrics.jsonl only
        first = _cli_run(args + ["--out-dir", str(out)])
        resumed = _cli_run(args + ["--out-dir", str(out), "--resume",
                                   "--set", "training.num_epochs=2"])
    return first, resumed


@pytest.mark.parametrize("run", ["cli", "cli_resume"])
def test_trainer_cli_matches_one_device(ranks, single_cli, run):
    want = single_cli[0 if run == "cli" else 1]
    for rank in ranks:
        got = rank[run]
        assert got["step"] == want["step"]
        assert got["test"]["predictions"] == want["test"]["predictions"]
        for k in ("val_loss",) + COMPONENTS:
            np.testing.assert_allclose(got["test"][k], want["test"][k], rtol=1e-4, err_msg=k)
    assert ranks[1][run]["module"].keys() == ranks[0][run]["module"].keys()
    for key, v in ranks[0][run]["module"].items():
        assert torch.equal(v, ranks[1][run]["module"][key]), key


def test_trainer_cli_writes_one_checkpoint_and_resumes(setup, ranks, single_cli):
    assert sorted(p.name for p in (setup["root"] / "dp" / "checkpoints").iterdir()) == \
        single_cli[1]["ckpts"]
    for rank in ranks:
        assert rank["cli"]["ckpts"] == single_cli[0]["ckpts"]
        assert rank["cli_resume"]["start_epoch"] == 1
    losses_file = setup["root"] / "dp" / "metrics.jsonl"
    assert losses_file.exists()


def test_dcn_axis_equals_data_axis(ranks):
    for rank in ranks:
        assert rank["cli_dcn"]["test"]["predictions"] == rank["cli"]["test"]["predictions"]
        for k in ("val_loss",) + COMPONENTS:
            assert rank["cli_dcn"]["test"][k] == rank["cli"]["test"][k], k
        for key, v in rank["cli"]["module"].items():
            assert torch.equal(v, rank["cli_dcn"]["module"][key]), key


def test_trainer_refuses_an_indivisible_micro_batch(ranks):
    for rank in ranks:
        assert "micro batch 3 not divisible by the mesh's 2 data-parallel devices" in rank["odd"]


# ---------------------------------------------------------------------------
# mesh, runtime and feed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [
    ((8, 1), {}), ((-1, 1), {}), ((2, 1), {"n_dcn": 2}), ((-1, 1), {"n_dcn": 2}),
    ((4, 1), {"n_dcn": 2}), ((1, 1), {}),
], ids=str)
def test_make_mesh_shapes_match_jax(eight_devices, args):
    pos, kw = args
    want = jax_make_mesh(*pos, **kw)
    got = make_mesh(*pos, devices=list(range(8)), **kw)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert got.n_batch_shards == int(np.prod([want.shape[a] for a in want.axis_names
                                              if a != "model"]))


@pytest.mark.parametrize("args", [((-1, 3), {}), ((16, 1), {}), ((8, 1), {"n_dcn": 2})],
                         ids=str)
def test_make_mesh_errors_match_jax(eight_devices, args):
    pos, kw = args
    with pytest.raises(ValueError) as want:
        jax_make_mesh(*pos, **kw)
    with pytest.raises(ValueError) as got:
        make_mesh(*pos, devices=list(range(8)), **kw)
    assert str(got.value) == str(want.value)


def test_batch_sharding_specs_match_jax(eight_devices):
    batch = {"eeg": np.zeros((2, 4, 4, 16, 8)), "channel_mask": np.zeros((4, 16))}
    for n_dcn, n_data in ((1, 8), (2, 4)):
        want = {k: tuple(s.spec) for k, s in jax_batch_sharding(
            jax_make_mesh(n_data, 1, n_dcn=n_dcn), batch, batch_axis=1).items()}
        got = batch_sharding(make_mesh(n_data, 1, n_dcn=n_dcn, devices=list(range(8))), batch,
                             batch_axis=1)
        assert {k: s.spec for k, s in got.items()} == want


def test_shard_batch_takes_contiguous_rows_in_dcn_data_order():
    mesh = make_mesh(2, 1, n_dcn=2, devices=[0, 1, 2, 3])
    batch = {"x": np.arange(16).reshape(2, 8), "channel_mask": np.ones(3)}
    for rank in range(4):
        got = shard_batch(mesh, batch, batch_axis=1, rank=rank)
        np.testing.assert_array_equal(got["x"], batch["x"][:, 2 * rank:2 * rank + 2])
        assert got["channel_mask"] is batch["channel_mask"]
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(mesh, {"x": np.zeros((2, 6))}, batch_axis=1, rank=0)


def test_initialize_distributed_is_a_noop_without_the_variables(monkeypatch):
    for name in ("IST_COORDINATOR", "IST_NUM_PROCESSES", "IST_PROCESS_ID", "IST_DISTRIBUTED"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed(device="cpu") is False
    assert initialize_distributed(device="cpu") is False
    assert is_primary()
    sync_hosts()
    host_barrier()
    with pytest.raises(ValueError, match="IST_PROCESS_ID"):
        initialize_distributed("127.0.0.1:1", 2, device="cpu")


def test_backend_is_chosen_explicitly(monkeypatch):
    monkeypatch.delenv("IST_BACKEND", raising=False)
    assert choose_backend("cpu") == "gloo"
    assert choose_backend("cuda") == "nccl"
    monkeypatch.setenv("IST_BACKEND", "gloo")
    assert choose_backend("cuda") == "gloo"
    monkeypatch.setenv("IST_BACKEND", "nccl")
    with pytest.raises(ValueError, match="IST_BACKEND=gloo"):
        choose_backend("cpu")
    with pytest.raises(ValueError, match="one of"):
        choose_backend("cpu", "mpi")


def test_two_ranks_on_one_card_refuse_nccl(monkeypatch):
    """NCCL refuses two ranks on one card: every rank raises, naming
    ``IST_BACKEND=gloo``; two cards pass."""
    monkeypatch.setattr(distributed, "_card_id", lambda device: "host/card0")
    store = torch.distributed.HashStore()
    store.set("ist_card/1", "host/card0")
    with pytest.raises(RuntimeError, match="IST_BACKEND=gloo"):
        distributed._refuse_shared_cards(store, 0, 2, torch.device("cpu"))
    store = torch.distributed.HashStore()
    store.set("ist_card/1", "host/card1")
    distributed._refuse_shared_cards(store, 0, 2, torch.device("cpu"))


def test_torchrun_variables_under_ist_distributed(monkeypatch):
    """``IST_DISTRIBUTED=1`` reads torchrun's ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` (the process group itself
    is faked)."""
    seen = {}

    class Store:
        def __init__(self, host, port, world, is_master, timeout):
            seen.update(host=host, port=port, world=world, is_master=is_master)

    def init(backend, *, store, world_size, rank, timeout):
        seen.update(backend=backend, world_size=world_size, rank=rank)

    for name in ("IST_COORDINATOR", "IST_NUM_PROCESSES", "IST_PROCESS_ID", "IST_BACKEND"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("IST_DISTRIBUTED", "1")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.7")
    monkeypatch.setenv("MASTER_PORT", "29400")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setattr(distributed.dist, "TCPStore", Store)
    monkeypatch.setattr(distributed.dist, "init_process_group", init)
    monkeypatch.setattr(distributed._Runtime, "store", None)
    assert initialize_distributed(device="cpu") is True
    assert seen == dict(host="10.0.0.7", port=29400, world=4, is_master=False, backend="gloo",
                        world_size=4, rank=3)


def test_ranks_joined_one_group(ranks):
    assert [r["shard"] for r in ranks] == [0, 1]
    assert [r["primary"] for r in ranks] == [True, False]


def test_device_prefetch_yields_the_rank_rows(setup, ranks):
    for rank, got in enumerate(r["prefetch"] for r in ranks):
        for i, t in enumerate(got):
            want = setup["batches"][i]["eeg"][0][2 * rank:2 * rank + 2]
            np.testing.assert_array_equal(t.numpy(), want)
