"""Tensor parallelism and ring attention on the CPU: two gloo ranks of the
port against the port on one device, against JAX's TP step on a
``make_mesh(4, 2)`` mesh, and against JAX's ``ring_attention``.

Two processes are spawned once for the module (the ``ranks`` fixture) with
``IST_COORDINATOR``, ``IST_NUM_PROCESSES=2``, ``IST_PROCESS_ID`` and
``IST_BACKEND=gloo``; each runs every scenario below in turn and writes its
results to a file, and the tests hold them to runs made in this process:

* the TP train step (``make_mesh(1, 2)``: one batch shard, two model ranks,
  the ``_TP_RULES`` tensors split) with dropout on, two steps, against the
  port's single-device step on the same windows (the same dropout bits);
* the same step in bf16 mixed precision (the default config's) against the
  port's single-device bf16 step, and with Megatron's *f* left without its
  backward all-reduce, which must miss it;
* the same step with dropout neutralised against JAX's step on a
  ``make_mesh(4, 2)`` mesh with ``shard_train_state(tp=True)``, one step;
* ``ring_attention`` over a ``seq`` axis of two ranks: forward and
  gradients against the port's plain attention and JAX's ``ring_attention``
  over two devices, with ``kv_valid`` padding and in bfloat16;
* ``BrainRegionEncoder`` with ``seq_shards=2`` at T = 33 (37 tokens, padded
  to 38) against ``seq_shards=1`` in this process, forward and gradients;
* ``graft_bart_params`` of a whole decoder into the TP state: each rank
  its slices;
* ``cli.train --set parallel.model_axis=2`` for one epoch, then
  ``--resume`` for a second, against the same commands in one process; the
  checkpoint is written whole.

Four more processes (the ``four_ranks`` fixture) run the TP step on a
``make_mesh(2, 2)`` mesh, where the data and model groups are process
groups of two, against the same single-device steps, and the ring over a
``{data: 2, seq: 2}`` mesh, each data group on its row of the batch.

Sizes: ``tests.helpers.tiny_config``; the steps as in
``tests/test_torch_parallel.py`` (T = 124, micro-batch 4, accumulation 2).

Tolerances (float32): losses within 2e-4 relative (JAX's
``tests/test_parallel.py``), the trainer's within 1e-4; in bf16 every logged
metric within 1e-2 relative (``BF16_RTOL``); parameters by
``tests/test_torch_train_step.py``'s learning-rate rule; the ring forward
within 2e-5 and its gradients within 3e-4 (JAX's
``tests/test_context_parallel.py``), 3e-2 in bfloat16; the encoder's forward
within 3e-5 and its gradients within 1e-4 of the largest gradient (JAX's
rule there).
"""

import multiprocessing
import os
import pickle
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh as JaxMesh

from imagined_speech_translation_tpu.config import (
    BrainEncoderConfig as JaxBrainEncoderConfig,
)
from imagined_speech_translation_tpu.config import (
    RegionEncoderConfig as JaxRegionEncoderConfig,
)
from imagined_speech_translation_tpu.parallel import make_mesh as jax_make_mesh
from imagined_speech_translation_tpu.parallel import ring_attention as jax_ring_attention
from imagined_speech_translation_tpu.parallel import shard_train_state as jax_shard_state
from imagined_speech_translation_tpu.parallel import (
    state_sharding_tree as jax_state_sharding_tree,
)
from imagined_speech_translation_tpu.parallel.mesh import shard_batch as jax_shard_batch
from imagined_speech_translation_tpu.training import TrainState as JaxTrainState
from imagined_speech_translation_tpu.training import build_optimizer as jax_build_optimizer
from imagined_speech_translation_tpu.training import make_train_step as jax_make_train_step
from imagined_speech_translation_tpu.utils.trees import _key_str
from imagined_speech_translation_tpu_torch import config
from imagined_speech_translation_tpu_torch.cli.serve import load_serving_state_dict
from imagined_speech_translation_tpu_torch.convert import _port_leaf, convert_variables
from imagined_speech_translation_tpu_torch.models import BrainRegionEncoder
from imagined_speech_translation_tpu_torch.models.init import init_parameters
from imagined_speech_translation_tpu_torch.ops import dot_product_attention
from imagined_speech_translation_tpu_torch.ops.random import bernoulli_keep
from imagined_speech_translation_tpu_torch.parallel import (
    context_mesh,
    initialize_distributed,
    make_mesh,
    ring_attention,
    shard_train_state,
    state_sharding_tree,
)
from imagined_speech_translation_tpu_torch.parallel import data_parallel as dpx
from imagined_speech_translation_tpu_torch.parallel import tensor_parallel as tpx
from imagined_speech_translation_tpu_torch.parallel.mesh import shard_batch
from imagined_speech_translation_tpu_torch.training import (
    FusedAdamW,
    TrainModule,
    create_train_state,
    make_train_step,
)
from imagined_speech_translation_tpu_torch.training.checkpoint import full_state_dicts
from imagined_speech_translation_tpu_torch.training.pretrained import graft_bart_params
from tests.test_torch_parallel import (
    BF16_RTOL,
    BOW,
    COMPONENTS,
    RANK_TIMEOUT_S,
    TOTAL_STEPS,
    _assert_metrics_close,
    _assert_params_close,
    _cli_args,
    _cli_run,
    _free_port,
    _lr_max,
    _mixed,
    _port_steps,
    _rel_gaps,
    _tensors,
)
from tests.test_torch_parallel import setup as _parallel_setup
from tests.test_torch_train_step import _no_dropout_jax, _no_dropout_port

RING = dict(b=2, h=4, s=256, d=32)
PAD_S = 99          # padded to 100 over two ranks
ENC_T = 33          # 33 + 4 special tokens = 37, padded to 38


# ---------------------------------------------------------------------------
# the scenarios
# ---------------------------------------------------------------------------


def _tp_steps(setup, n_steps, *, dropout, mesh, mixed=False, skip_f=False):
    """``n_steps`` port train steps from the setup's weights over ``mesh``
    with the ``_TP_RULES`` tensors split (and this rank's rows of each
    window when the mesh has more than one batch shard), in bf16 mixed
    precision with ``mixed``; returns the metrics and the whole module state
    and first moments (gathered from the model ranks).  ``skip_f`` leaves
    Megatron's *f* without its backward all-reduce, so each rank's gradients
    below a column-parallel layer are its own share only."""
    cfg = _mixed(setup["cfg"]) if mixed else setup["cfg"]
    module = TrainModule(cfg, bow_k=len(BOW))
    module.load_state_dict(setup["state_dict"])
    opt = FusedAdamW([n for n, _ in module.named_parameters()], cfg.training.optimizer,
                     TOTAL_STEPS)
    state = shard_train_state(create_train_state(module, opt, setup["weights"]), mesh, tp=True)
    dp = dpx.DataParallel.of(mesh) if mesh.n_batch_shards > 1 else None
    step = make_train_step(module, opt, cfg, BOW, data_parallel=dp)
    out = []
    with pytest.MonkeyPatch.context() as mp:
        if not dropout:
            _no_dropout_port(mp)
        if skip_f:
            mp.setattr(tpx, "copy_to_model", lambda t: t)
        for i in range(n_steps):
            batch = shard_batch(mesh, setup["batches"][i], batch_axis=1)
            state, metrics = step(state, _tensors(batch), torch.Generator().manual_seed(i))
            out.append({k: float(v) for k, v in metrics.items()})
    module_sd, mu, _ = full_state_dicts(state)
    local = {k: tuple(v.shape) for k, v in state.module.state_dict().items()}
    return out, {k: v.clone() for k, v in module_sd.items()}, mu, local


def _tp_graft(setup, mesh, path):
    """``graft_bart_params`` of the whole decoder (written to ``path``) into
    a TP state whose decoder was zeroed: for each parameter, whether it is
    this rank's slice of the whole one (or the whole one, if replicated)."""
    cfg = setup["cfg"]
    module = TrainModule(cfg, bow_k=len(BOW))
    module.load_state_dict(setup["state_dict"])
    whole = {k: v.clone() for k, v in module.model.bart.state_dict().items()}
    torch.save(whole, path)
    opt = FusedAdamW([n for n, _ in module.named_parameters()], cfg.training.optimizer,
                     TOTAL_STEPS)
    state = shard_train_state(create_train_state(module, opt, setup["weights"]), mesh, tp=True)
    with torch.no_grad():
        for p in state.module.model.bart.parameters():
            p.zero_()
    graft_bart_params(state, path)
    tp = state.tensor_parallel
    return {k: (("model.bart." + k) in tp.dims, torch.equal(
        p, tp.local("model.bart." + k, whole[k]) if ("model.bart." + k) in tp.dims else whole[k]))
        for k, p in state.module.model.bart.named_parameters()}


def _ring_inputs(dtype=torch.float32, s=RING["s"]):
    rng = np.random.default_rng(11)
    shape = (RING["b"], RING["h"], s, RING["d"])
    q, k, v, w = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    return q, k, v, w


def _ring_run(fn, q, k, v, w, dtype=torch.float32):
    """``fn(q, k, v)``'s output and the gradients of ``sum(out * w)``."""
    leaves = [torch.tensor(x, dtype=dtype).requires_grad_() for x in (q, k, v)]
    out = fn(*leaves)
    (out.float() * torch.tensor(w)).sum().backward()
    return out.detach().float().numpy(), [t.grad.float().numpy() for t in leaves]


def _padded(fn, true_s):
    """``fn`` on inputs zero-padded to a multiple of two, with the padded
    keys masked, cut back to ``true_s`` rows."""
    pad = (-true_s) % 2
    valid = torch.arange(true_s + pad) < true_s

    def run(q, k, v):
        qp, kp, vp = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
        return fn(qp, kp, vp, valid)[:, :, :true_s]

    return run


def _enc_cfg(seq_shards):
    return config.BrainEncoderConfig(
        hidden_dim=32, fusion_heads=4, cross_region_heads=4,
        region_encoder=config.RegionEncoderConfig(
            conv_channels=(8, 12, 16, 24, 32), attn_heads=(4, 2, 2), se_reduction=4,
            seq_shards=seq_shards))


def _enc_inputs():
    rng = np.random.default_rng(7)
    mask = np.zeros((4, 16), bool)
    for r, c in enumerate((16, 9, 11, 12)):
        mask[r, :c] = True
    return rng.normal(size=(2, 4, 16, ENC_T)).astype(np.float32), mask


def _encoder_run(seq_shards):
    """The encoder's eval-mode forward and the gradients of ``sum(out^2)``
    with respect to every parameter."""
    enc = BrainRegionEncoder(_enc_cfg(seq_shards), in_channels=16, n_timepoints=ENC_T)
    init_parameters(enc, 5).eval()
    eeg, mask = _enc_inputs()
    out = enc(torch.tensor(eeg), torch.tensor(mask))
    names, params = zip(*enc.named_parameters())
    grads = torch.autograd.grad((out ** 2).sum(), params, allow_unused=True,
                                materialize_grads=True)
    return out.detach().numpy(), {n: g.numpy() for n, g in zip(names, grads)}


def _rank_scenarios(root) -> dict:
    with open(root / "setup.pkl", "rb") as f:
        setup = pickle.load(f)
    mesh = make_mesh(1, 2)
    out = {"coords": mesh.coords()}
    out["dropout"] = _tp_steps(setup, 2, dropout=True, mesh=mesh)
    out["no_dropout"] = _tp_steps(setup, 1, dropout=False, mesh=mesh)
    out["bf16"] = _tp_steps(setup, 2, dropout=True, mesh=mesh, mixed=True)
    out["bf16_skip_f"] = _tp_steps(setup, 2, dropout=True, mesh=mesh, mixed=True, skip_f=True)

    out["graft"] = _tp_graft(setup, mesh, root / f"bart{mesh.coords()['model']}.pt")

    seq = make_mesh(1, 2, axis_names=("data", "seq"))

    def ring(q, k, v, valid=None):
        return ring_attention(q, k, v, mesh=seq, kv_valid=valid)

    q, k, v, w = _ring_inputs()
    out["ring"] = _ring_run(ring, q, k, v, w)
    out["ring_bf16"] = _ring_run(ring, q, k, v, w, dtype=torch.bfloat16)
    q, k, v, w = _ring_inputs(s=PAD_S)
    out["ring_padded"] = _ring_run(_padded(ring, PAD_S), q, k, v, w)
    with context_mesh(seq):
        out["encoder"] = _encoder_run(2)

    tp = _cli_args(root, "trainer.json", "--set", "parallel.model_axis=2")
    out["cli"] = _cli_run(tp + ["--out-dir", str(root / "tp")])
    out["cli_resume"] = _cli_run(tp + ["--out-dir", str(root / "tp"), "--resume",
                                       "--set", "training.num_epochs=2"])
    return out


def _four_rank_scenarios(root) -> dict:
    """On 2 (data) x 2 (model) ranks: the TP step over each batch shard's
    rows, two steps with dropout; the ring over the ``seq`` ranks of a
    ``{data: 2, seq: 2}`` mesh, each data group on its row of the inputs."""
    with open(root / "setup.pkl", "rb") as f:
        setup = pickle.load(f)
    mesh = make_mesh(2, 2)
    out = {"coords": mesh.coords(), "shard": mesh.shard_index()}
    out["dropout"] = _tp_steps(setup, 2, dropout=True, mesh=mesh)
    seq = make_mesh(2, 2, axis_names=("data", "seq"))
    row = slice(seq.shard_index(), seq.shard_index() + 1)
    q, k, v, w = (x[row] for x in _ring_inputs())
    out["ring"] = _ring_run(lambda q, k, v: ring_attention(q, k, v, mesh=seq), q, k, v, w)
    return out


def _rank_main(rank: int, world: int, port: int, root) -> None:
    os.environ.update(IST_COORDINATOR=f"127.0.0.1:{port}", IST_NUM_PROCESSES=str(world),
                      IST_PROCESS_ID=str(rank), IST_BACKEND="gloo", WANDB_MODE="disabled")
    torch.set_num_threads(2)
    tag = f"w{world}_rank{rank}"
    try:
        assert initialize_distributed(device="cpu")
        out = (_rank_scenarios if world == 2 else _four_rank_scenarios)(root)
    except BaseException:
        (root / f"{tag}.err").write_text(traceback.format_exc())
        raise
    with open(root / f"{tag}.pkl", "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


setup = _parallel_setup


def _spawn(root, world: int) -> list[dict]:
    """Every rank's results, from one spawn of ``world`` processes."""
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, root))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(RANK_TIMEOUT_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    tags = [f"w{world}_rank{r}" for r in range(world)]
    errors = [(root / f"{t}.err").read_text() for t in tags if (root / f"{t}.err").exists()]
    assert not errors, "\n".join(errors)
    assert [p.exitcode for p in procs] == [0] * world
    out = []
    for t in tags:
        with open(root / f"{t}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def ranks(setup):
    """Both ranks' results, from one spawn of two processes."""
    return _spawn(setup["root"], 2)


@pytest.fixture(scope="module")
def four_ranks(setup):
    """Four ranks' results (2 data x 2 model), from one spawn."""
    return _spawn(setup["root"], 4)


@pytest.fixture(scope="module")
def single(setup):
    """The port's single-device steps on the same windows."""
    return {"dropout": _port_steps(setup, 2, dropout=True),
            "no_dropout": _port_steps(setup, 1, dropout=False),
            "bf16": _port_steps(setup, 2, dropout=True, mixed=True)}


# ---------------------------------------------------------------------------
# the TP step
# ---------------------------------------------------------------------------


def test_ranks_hold_their_model_index(ranks):
    assert [r["coords"] for r in ranks] == [{"data": 0, "model": 0}, {"data": 0, "model": 1}]


@pytest.mark.parametrize("step", [0, 1])
def test_tp_step_with_dropout_matches_one_device(ranks, single, step):
    want = single["dropout"][0][step]
    for rank in ranks:
        _assert_metrics_close(rank["dropout"][0][step], want, 2e-4)


def test_tp_step_weights_match_one_device(setup, ranks, single):
    """The whole weights after two steps (gathered from both ranks' slices)
    by the learning-rate rule, equal on both ranks; each rank held half of
    every split tensor."""
    want = single["dropout"][1]
    _assert_params_close(ranks[0]["dropout"][1], want, _lr_max(setup["cfg"], 2))
    for key, v in ranks[0]["dropout"][1].items():
        assert torch.equal(v, ranks[1]["dropout"][1][key]), key
    local = ranks[0]["dropout"][3]
    key = "model.bart.layer0.fc1.weight"
    assert local[key][0] * 2 == want[key].shape[0] and local[key][1] == want[key].shape[1]
    key = "model.brain_encoder.region_encoders.ffn0.linear2.weight"
    assert local[key][2] * 2 == want[key].shape[2]


def test_tp_graft_takes_each_ranks_slices(ranks):
    """``cli.train --bart-params`` under tensor parallelism: the graft of a
    whole decoder leaves each rank its slices of the split tensors and the
    whole replicated ones."""
    for rank in ranks:
        assert all(equal for _, equal in rank["graft"].values())
        assert sum(split for split, _ in rank["graft"].values()) == 34  # 2 layers x 17


def test_tp_bf16_step_matches_one_device(ranks, single):
    """Two bf16 mixed-precision TP steps with dropout: every logged metric
    within BF16_RTOL of the one-device bf16 step, the whole weights equal on
    both ranks; with *f*'s backward all-reduce skipped the run lies beyond
    the bound."""
    want = single["bf16"][0]
    for rank in ranks:
        for step in (0, 1):
            _assert_metrics_close(rank["bf16"][0][step], want[step], BF16_RTOL)
        assert max(_rel_gaps(rank["bf16_skip_f"][0], want).values()) > BF16_RTOL
    for key, v in ranks[0]["bf16"][1].items():
        assert torch.equal(v, ranks[1]["bf16"][1][key]), key


def test_tp_step_differs_without_dropout(ranks, single):
    got = ranks[0]["dropout"][0][0]["loss"]
    assert abs(got - single["no_dropout"][0][0]["loss"]) > 1e-3 * abs(got)


def _jax_state(setup):
    cfg, v = setup["cfg"], setup["variables"]
    params = jax.tree.map(jnp.asarray, v["params"])
    opt = jax_build_optimizer(params, cfg.training.optimizer, TOTAL_STEPS)
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]), opt_state=opt.init(params),
        loss_weights={k: jnp.float32(w) for k, w in setup["weights"].items()},
    )
    return state, opt


@pytest.fixture(scope="module")
def jax_tp_step(setup, eight_devices):
    """JAX's step over a ``make_mesh(4, 2)`` mesh with the ``_TP_RULES``
    tensors sharded, dropout neutralised: one step."""
    cfg = setup["cfg"]
    state, opt = _jax_state(setup)
    mesh = jax_make_mesh(4, 2, devices=eight_devices)
    batch = {k: jnp.asarray(a) for k, a in setup["batches"][0].items()}
    sharded = jax_shard_batch(mesh, {k: a for k, a in batch.items() if k != "channel_mask"},
                              batch_axis=1)
    sharded["channel_mask"] = batch["channel_mask"]
    with pytest.MonkeyPatch.context() as mp:
        _no_dropout_jax(mp)
        step = jax.jit(jax_make_train_step(setup["jm"], opt, cfg, BOW))
        state, metrics = step(jax_shard_state(state, mesh, tp=True), sharded, jax.random.key(0))
    return state, {k: float(m) for k, m in metrics.items()}


def test_tp_step_matches_jax_tp_step(setup, ranks, jax_tp_step):
    jax_state, want = jax_tp_step
    metrics, module = ranks[0]["no_dropout"][:2]
    _assert_metrics_close(metrics[0], want, 2e-4)
    ref = convert_variables(
        {"params": jax.tree.map(np.asarray, jax_state.params),
         "batch_stats": jax.tree.map(np.asarray, jax_state.batch_stats)},
        TrainModule(setup["cfg"], bow_k=len(BOW)))
    _assert_params_close(module, ref, _lr_max(setup["cfg"], 1), bn_atol=1e-4)


def test_tp_moments_are_the_one_device_moments(ranks, single):
    """The first moments gathered from both ranks equal each other, and at
    the split tensors they are the whole moment (not a rank's slice)."""
    mu0, mu1 = ranks[0]["dropout"][2], ranks[1]["dropout"][2]
    want = single["dropout"][1]
    for key, m in mu0.items():
        assert torch.equal(m, mu1[key]), key
        assert m.shape == want[key].shape, key


def _jax_path_specs(tree) -> dict[str, tuple]:
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if hasattr(s, "spec"):
            out["/".join(_key_str(k) for k in path)] = tuple(s.spec)
    return out


def test_four_ranks_split_over_data_and_model(four_ranks):
    assert [(r["coords"]["data"], r["coords"]["model"], r["shard"]) for r in four_ranks] == [
        (0, 0, 0), (0, 1, 0), (1, 0, 1), (1, 1, 1)]


@pytest.mark.parametrize("step", [0, 1])
def test_dp_tp_step_with_dropout_matches_one_device(four_ranks, single, step):
    """2 data x 2 model ranks (process groups of two along each axis): each
    rank's loss is the single-device step's; the masks are drawn at the
    global rows and the full width."""
    want = single["dropout"][0][step]
    for rank in four_ranks:
        _assert_metrics_close(rank["dropout"][0][step], want, 2e-4)


def test_dp_tp_step_weights_match_one_device(setup, four_ranks, single):
    want = single["dropout"][1]
    _assert_params_close(four_ranks[0]["dropout"][1], want, _lr_max(setup["cfg"], 2))
    for rank in four_ranks[1:]:
        for key, v in four_ranks[0]["dropout"][1].items():
            assert torch.equal(v, rank["dropout"][1][key]), key


def test_state_sharding_tree_matches_jax(setup, eight_devices):
    """``state_sharding_tree(tp=True)`` gives JAX's spec for every
    parameter, BatchNorm statistic and moment, path by path, in the torch
    layout: a Dense kernel's last two entries swap."""
    state, _ = _jax_state(setup)
    mesh = jax_make_mesh(4, 2, devices=eight_devices)
    want = _jax_path_specs(jax_state_sharding_tree(state, mesh, tp=True))
    module = TrainModule(setup["cfg"], bow_k=len(BOW))
    opt = FusedAdamW([n for n, _ in module.named_parameters()],
                     setup["cfg"].training.optimizer, TOTAL_STEPS)
    port_state = create_train_state(module, opt, setup["weights"])
    got = state_sharding_tree(port_state, make_mesh(4, 2, devices=list(range(8))), tp=True)
    prefixes = {"params/": ("module.", "params"), "batch_stats/": ("module.", "batch_stats"),
                "opt_state/mu/": ("mu.", "params"), "opt_state/nu/": ("nu.", "params")}
    seen, n_split = set(), 0
    for path, spec in want.items():
        start = next((p for p in prefixes if path.startswith(p)), None)
        if start is None:
            continue
        kind, collection = prefixes[start]
        leaf_path = tuple(path.removeprefix(start).split("/"))
        key, _ = _port_leaf(module, collection, leaf_path, np.zeros((1, 1, 1, 1)))
        if leaf_path[-1] == "kernel" and spec:
            spec = spec[:-2] + (spec[-1], spec[-2])
        assert got[kind + key].spec == spec, (path, kind + key)
        seen.add(kind + key)
        n_split += "model" in spec
    assert seen == set(got)
    assert n_split == 3 * 44  # 44 split parameters at tiny_config, and their moments


@pytest.mark.parametrize("args", [((4, 2), {}), ((-1, 2), {}), ((2, 2), {"n_dcn": 2}),
                                  ((-1, 2), {"n_dcn": 2}), ((1, 4), {})], ids=str)
def test_make_mesh_with_a_model_axis_matches_jax(eight_devices, args):
    pos, kw = args
    want = jax_make_mesh(*pos, **kw)
    got = make_mesh(*pos, devices=list(range(8)), **kw)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    grid = np.asarray(want.devices).reshape(-1)
    for rank in range(len(got.devices)):
        want_coords = dict(zip(want.axis_names,
                               np.unravel_index(rank, tuple(want.shape.values()))))
        assert got.coords(rank) == {a: int(i) for a, i in want_coords.items()}
        assert grid[rank] == eight_devices[rank]


def test_mesh_groups_split_the_ranks():
    """On a 2 (data) x 2 (model) mesh the model group is the ranks of one
    batch shard and the data group the ranks of one model index."""
    mesh = make_mesh(2, 2, devices=[0, 1, 2, 3])
    assert [mesh.members("model", r) for r in range(4)] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    assert [mesh.members(("dcn", "data"), r) for r in range(4)] == [[0, 2], [1, 3]] * 2
    assert [mesh.shard_index(r) for r in range(4)] == [0, 0, 1, 1]
    assert mesh.n_batch_shards == 2
    seq = make_mesh(1, 2, axis_names=("data", "seq"), devices=[0, 1])
    assert seq.n_batch_shards == 1 and [seq.shard_index(r) for r in range(2)] == [0, 0]


def test_model_cols_draw_the_one_device_mask():
    """Under tensor parallelism a dropout mask of a split activation is the
    single-device mask's columns (heads) of this rank: the generator
    advances as on one device."""
    full = bernoulli_keep((2, 3, 8), 0.7, "cpu", torch.Generator().manual_seed(3), model_dim=-1)
    heads = bernoulli_keep((2, 4, 5, 5), 0.7, "cpu", torch.Generator().manual_seed(4))
    for rank in range(2):
        with tpx.installed(tpx.TensorParallel(rank, 2)):
            got = bernoulli_keep((2, 3, 4), 0.7, "cpu", torch.Generator().manual_seed(3),
                                 model_dim=-1)
            got_heads = bernoulli_keep((2, 2, 5, 5), 0.7, "cpu",
                                       torch.Generator().manual_seed(4), model_dim=1)
        assert torch.equal(got, full[..., 4 * rank:4 * rank + 4])
        assert torch.equal(got_heads, heads[:, 2 * rank:2 * rank + 2])


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------


def _plain(q, k, v, valid=None):
    return dot_product_attention(q, k, v)


def _jax_ring(devices, dtype=jnp.float32):
    mesh = JaxMesh(np.asarray(devices[:2]), ("seq",))

    def run(q, k, v, w, true_s=None):
        def loss(q, k, v):
            if true_s is None:
                out = jax_ring_attention(q, k, v, mesh=mesh)
            else:
                pad = (-true_s) % 2
                qp, kp, vp = (jnp.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0))) for x in (q, k, v))
                valid = jnp.arange(true_s + pad) < true_s
                out = jax_ring_attention(qp, kp, vp, mesh=mesh, kv_valid=valid)[:, :, :true_s]
            return (out.astype(jnp.float32) * w).sum(), out

        args = [jnp.asarray(x, dtype) for x in (q, k, v)]
        grads, out = jax.grad(loss, argnums=(0, 1, 2), has_aux=True)(*args)
        return np.asarray(out, np.float32), [np.asarray(g, np.float32) for g in grads]

    return run


@pytest.fixture(scope="module")
def jax_rings(eight_devices):
    """JAX's ``ring_attention`` over two devices, unpadded and padded."""
    q, k, v, w = _ring_inputs()
    out = {"ring": _jax_ring(eight_devices)(q, k, v, w)}
    q, k, v, w = _ring_inputs(s=PAD_S)
    out["ring_padded"] = _jax_ring(eight_devices)(q, k, v, w, true_s=PAD_S)
    return out


@pytest.mark.parametrize("what", ["out", "grads"])
def test_ring_attention_matches_plain_and_jax(ranks, jax_rings, what):
    q, k, v, w = _ring_inputs()
    plain = _ring_run(_plain, q, k, v, w)
    jax_ring = jax_rings["ring"]
    for rank in ranks:
        got = rank["ring"]
        if what == "out":
            np.testing.assert_allclose(got[0], plain[0], atol=2e-5)
            np.testing.assert_allclose(got[0], jax_ring[0], atol=2e-5)
        else:
            for g, p, j in zip(got[1], plain[1], jax_ring[1]):
                np.testing.assert_allclose(g, p, atol=3e-4)
                np.testing.assert_allclose(g, j, atol=3e-4)


@pytest.mark.parametrize("what", ["out", "grads"])
def test_ring_attention_kv_valid_matches_unpadded(ranks, jax_rings, what):
    """99 keys padded to 100 over two ranks, the padded key masked: the true
    rows equal the unpadded attention, and the padding adds no gradient."""
    q, k, v, w = _ring_inputs(s=PAD_S)
    plain = _ring_run(_plain, q, k, v, w)
    jax_ring = jax_rings["ring_padded"]
    for rank in ranks:
        got = rank["ring_padded"]
        if what == "out":
            np.testing.assert_allclose(got[0], plain[0], atol=2e-5)
            np.testing.assert_allclose(got[0], jax_ring[0], atol=2e-5)
            assert np.isfinite(got[0]).all()
        else:
            for g, p, j in zip(got[1], plain[1], jax_ring[1]):
                np.testing.assert_allclose(g, p, atol=3e-4)
                np.testing.assert_allclose(g, j, atol=3e-4)


def test_ring_attention_bf16(ranks):
    """bfloat16 inputs, float32 online softmax inside: the output (in
    bfloat16) within 3e-2 of the float32 plain attention, as JAX's test
    holds its ring; the gradients within 3e-2 of their largest entry."""
    q, k, v, w = _ring_inputs()
    plain = _ring_run(_plain, q, k, v, w)
    for rank in ranks:
        out, grads = rank["ring_bf16"]
        np.testing.assert_allclose(out, plain[0], atol=3e-2)
        for g, p in zip(grads, plain[1]):
            assert np.abs(g - p).max() <= 3e-2 * np.abs(p).max()


def test_ring_attention_composes_with_a_data_axis(four_ranks):
    """{data: 2, seq: 2}: each data group's two seq ranks run the ring on
    their row of the batch (JAX's ``composes_with_data_axis`` layout)."""
    q, k, v, w = _ring_inputs()
    for rank in four_ranks:
        row = slice(rank["shard"], rank["shard"] + 1)
        plain = _ring_run(_plain, q[row], k[row], v[row], w[row])
        np.testing.assert_allclose(rank["ring"][0], plain[0], atol=2e-5)
        for g, p in zip(rank["ring"][1], plain[1]):
            np.testing.assert_allclose(g, p, atol=3e-4)


def test_ring_attention_validates_divisibility():
    q = torch.zeros((1, 1, 101, 8))
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention(q, q, q, mesh=make_mesh(1, 2, axis_names=("data", "seq"),
                                               devices=[0, 1]))
    with pytest.raises(ValueError, match="no axis"):
        ring_attention(q, q, q, mesh=make_mesh(1, 1, devices=[0]))


# ---------------------------------------------------------------------------
# the context-parallel region encoder
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def encoder_single():
    return _encoder_run(1)


def test_region_encoder_seq_shards_forward_matches(ranks, encoder_single):
    for rank in ranks:
        np.testing.assert_allclose(rank["encoder"][0], encoder_single[0], atol=3e-5)


def test_region_encoder_seq_shards_gradients_match(ranks, encoder_single):
    want = encoder_single[1]
    scale = max(np.abs(g).max() for g in want.values())
    for rank in ranks:
        assert rank["encoder"][1].keys() == want.keys()
        for name, g in rank["encoder"][1].items():
            assert np.abs(g - want[name]).max() <= 1e-4 * scale, name


def test_region_encoder_seq_shards_requires_context_mesh():
    enc = BrainRegionEncoder(_enc_cfg(2), in_channels=16, n_timepoints=ENC_T)
    init_parameters(enc, 5).eval()
    eeg, mask = _enc_inputs()
    with pytest.raises(RuntimeError, match="context_mesh"):
        enc(torch.tensor(eeg), torch.tensor(mask))


def test_region_encoder_config_matches_jax():
    """The port's encoder config takes the JAX config's ``seq_shards`` and
    ``seq_axis`` fields."""
    want = JaxBrainEncoderConfig(region_encoder=JaxRegionEncoderConfig(seq_shards=2))
    got = _enc_cfg(2)
    assert got.region_encoder.seq_shards == want.region_encoder.seq_shards
    assert got.region_encoder.seq_axis == want.region_encoder.seq_axis


# ---------------------------------------------------------------------------
# the trainer through cli.train
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def single_cli(setup, tmp_path_factory):
    root = setup["root"]
    out = tmp_path_factory.mktemp("single_cli")
    args = _cli_args(root, "trainer.json")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WANDB_MODE", "disabled")
        first = _cli_run(args + ["--out-dir", str(out)])
        resumed = _cli_run(args + ["--out-dir", str(out), "--resume",
                                   "--set", "training.num_epochs=2"])
    return first, resumed, out


@pytest.mark.parametrize("run", ["cli", "cli_resume"])
def test_tp_trainer_cli_matches_one_device(ranks, single_cli, run):
    want = single_cli[0 if run == "cli" else 1]
    for rank in ranks:
        got = rank[run]
        assert got["step"] == want["step"]
        assert got["test"]["predictions"] == want["test"]["predictions"]
        for k in ("val_loss",) + COMPONENTS:
            np.testing.assert_allclose(got["test"][k], want["test"][k], rtol=1e-4, err_msg=k)
    mine, theirs = ranks[0][run]["module"], ranks[1][run]["module"]
    assert mine.keys() == theirs.keys() == want["module"].keys()
    for key, v in mine.items():
        whole = want["module"][key].shape
        if v.shape == whole:  # replicated: equal on both ranks
            assert torch.equal(v, theirs[key]), key
        else:  # split: the two slices make the whole tensor
            dim = next(d for d, (a, b) in enumerate(zip(v.shape, whole)) if a != b)
            assert torch.cat([v, theirs[key]], dim).shape == whole, key


def test_tp_trainer_writes_one_whole_checkpoint(setup, ranks, single_cli):
    """The TP run writes the one-device checkpoint set, each state whole:
    the keys and shapes of the one-process run's, and the serving loader
    takes it; a resume starts at the next epoch."""
    tp_dir = setup["root"] / "tp" / "checkpoints"
    one_dir = single_cli[2] / "checkpoints"
    assert sorted(p.name for p in tp_dir.iterdir()) == sorted(p.name for p in one_dir.iterdir())
    for rank in ranks:
        assert rank["cli"]["ckpts"] == single_cli[0]["ckpts"]
        assert rank["cli_resume"]["start_epoch"] == 1
    for name in sorted(p.name for p in one_dir.iterdir()):
        got = torch.load(tp_dir / name / "state.pt", weights_only=True)
        want = torch.load(one_dir / name / "state.pt", weights_only=True)
        for part in ("module",):
            assert {k: v.shape for k, v in got[part].items()} == \
                {k: v.shape for k, v in want[part].items()}
        for moment in ("mu", "nu"):
            assert {k: v.shape for k, v in got["opt_state"][moment].items()} == \
                {k: v.shape for k, v in want["opt_state"][moment].items()}
        served = load_serving_state_dict(tp_dir / name)
        want = load_serving_state_dict(one_dir / name)
        assert {k: v.shape for k, v in served.items()} == {k: v.shape for k, v in want.items()}
