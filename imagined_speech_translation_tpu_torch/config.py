"""Typed configuration tree of the port: a copy of the JAX package's
``config`` module.

The dataclasses, ``default_config`` and ``replace_nested`` are copied
unchanged, so a configuration means the same thing to both packages
(``tests/test_torch_config.py`` holds the copy to the original).  The
port imports nothing of the JAX package, not even its jax-free modules.
Fields that select TPU-only behaviour (``rng_impl``, ``parallel``,
``seq_shards``) are carried so the two trees stay equal; the port reads
only what its ported code paths use.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Mapping


def _frozen(**kwargs):
    return dataclass(frozen=True, **kwargs)


# ---------------------------------------------------------------------------
# Data plane
# ---------------------------------------------------------------------------


@_frozen()
class AugmentationConfig:
    """EEG augmentation (reference: src/data/dataset.py:227-261 and the
    historical config block config.yaml:70-80)."""

    enabled: bool = True
    noise_prob: float = 0.3
    noise_std_frac: float = 0.05      # gaussian noise at 5% of sample std
    amp_scale_prob: float = 0.2
    amp_scale_range: float = 0.10     # +-10% amplitude scaling
    shift_prob: float = 0.15
    max_shift: int = 2                # circular roll of +-2 samples


@_frozen()
class DataConfig:
    """Dataset layout and normalization (reference: src/data/dataset.py)."""

    data_dir: str = "data"
    montage_csv: str = "data/montage.csv"
    n_timepoints: int = 1651          # samples per imagined sentence (training_config.py:14)
    n_channels_total: int = 125       # pkl rows: 122 EEG + aux (dataset.py:417)
    max_length: int = 16              # token length (training_config.py:15)
    eps: float = 1e-8
    max_samples: int | None = None
    scaler_fit_samples: int = 100     # RobustScaler fit subset (dataset.py:105)
    scaler_quantile_range: tuple[float, float] = (5.0, 95.0)
    train_split: float = 0.8
    val_split: float = 0.1
    test_split: float = 0.1
    augmentation: AugmentationConfig = field(default_factory=AugmentationConfig)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@_frozen()
class RegionEncoderConfig:
    """Per-region CNN + attention encoder (reference: src/models/layers.py:9-272).

    TPU-first redesign: the four ragged regions (16/9/11/12 channels) are
    zero-padded to ``max_region_channels`` and processed as one stacked
    ``(batch, region, channel, time)`` tensor with per-region weights vmapped
    over the region axis — one XLA program instead of four, keeping the MXU
    batch-busy.
    """

    conv_channels: tuple[int, ...] = (128, 256, 384, 512, 768)
    conv_kernels: tuple[int, ...] = (9, 7, 5, 5, 3)
    conv_strides: tuple[int, ...] = (1, 1, 1, 1, 1)
    depthwise_stage: int = 2          # stage index using depthwise+pointwise conv
    dropout_tiers: tuple[float, float, float] = (0.05, 0.10, 0.15)
    se_reduction: int = 16            # squeeze-excite (layers.py:275-298)
    num_attn_layers: int = 3
    # Attention head pattern per layer.  The reference uses (8, 4, 4) on 768
    # dims (layers.py:83-95) — head dims 96/192, which pad to the TPU MXU's
    # 128-lane tiles and waste 33% of the attention FLOPs.  The TPU-native
    # default is (6, 6, 6): head dim 128 exactly, measured -21% encoder
    # forward time (docs/PERFORMANCE.md round-3).  Set (8, 4, 4) to restore
    # the reference's exact head architecture (the brain encoder trains from
    # scratch, so this is an architecture choice, not a weight-compat one;
    # cross-scale attention uses attn_heads[0]//2 heads in both cases).
    attn_heads: tuple[int, ...] = (6, 6, 6)
    num_temporal_tokens: int = 3      # learned temporal tokens + CLS (layers.py:74-76)
    cross_scale_weight: float = 0.1   # (layers.py:98-103)
    temporal_pool_weight: float = 0.3  # CLS + 0.3*mean(temporal) (layers.py:254-258)
    diversity_weight: float = 0.1     # feat + 0.1*norm(diversity_head) (layers.py:127)
    cnn_only: bool = False            # ablation (layers.py:180-207)
    # ablation (paper Table 24 "no pos-emb"): skip the learned positional
    # table on the token-attention path
    use_positional_embedding: bool = True
    # conv-stem normalization: "batch" (reference BatchNorm — exact under DP
    # since the sharded-batch mean is global) or "group" (batch-independent,
    # no running stats; SURVEY.md §7 hard part 5 parity flag)
    norm: str = "batch"
    groupnorm_groups: int = 8
    # Window context parallelism: shard the token-attention TIME axis over
    # ``seq_shards`` devices on the ``seq_axis`` mesh axis, routing every
    # in-region attention (the 3 MHA layers + the cross-scale attention)
    # through ``parallel.context.ring_attention``.  The token sequence is
    # zero-padded to a shard multiple with a key-validity mask, so the math
    # is identical to the single-device path.  Requires the caller to
    # expose the mesh via ``parallel.context.context_mesh(mesh)`` around
    # model init/apply.  1 = off (the default single-chip flash path).
    # NOTE: the ring path applies no attention-prob dropout (the flash
    # kernel's in-kernel PRNG does, on the single-chip path); other
    # dropouts are unaffected.
    seq_shards: int = 1
    seq_axis: str = "seq"


@_frozen()
class BrainEncoderConfig:
    """Cross-region fusion encoder (reference: src/models/brain_encoder.py)."""

    hidden_dim: int = 768
    multi_scale_kernels: tuple[int, ...] = (3, 7, 15, 31)  # (brain_encoder.py:31-43)
    multi_scale_weight: float = 0.3
    region_embed_weight: float = 0.4
    fusion_layers: int = 2
    fusion_heads: int = 12
    cross_region_heads: int = 8
    static_weight_frac: float = 0.7   # softmax(0.7*static + 0.3*dynamic)
    enhancer_weight: float = 0.3
    disable_cross_region_attn: bool = False  # ablation flag
    uniform_region_weight: bool = False      # ablation flag
    remat: bool = False               # jax.checkpoint the per-region encoders
    region_encoder: RegionEncoderConfig = field(default_factory=RegionEncoderConfig)


@_frozen()
class BartConfig:
    """From-scratch JAX BART seq2seq decoder matching ``fnlp/bart-base-chinese``
    (reference wraps the HF checkpoint: src/models/bart_decoder.py:14-78).

    vocab 51,271 / d_model 768 / 6+6 layers / 12 heads / ffn 3072, post-LN,
    learned positions with offset 2 — the bart-base architecture.
    """

    vocab_size: int = 51271
    d_model: int = 768
    encoder_layers: int = 6           # also the pseudo-encoder sequence length
    decoder_layers: int = 6
    num_heads: int = 12
    ffn_dim: int = 3072
    max_position_embeddings: int = 512
    position_offset: int = 2          # BART's learned-position offset
    dropout: float = 0.1
    attention_dropout: float = 0.0
    activation: str = "gelu"
    pad_token_id: int = 0
    bos_token_id: int = 101           # [CLS] in the Chinese BERT vocab
    eos_token_id: int = 104           # logged key IDs: pad=0, eos=104, bos=101
    # Training decoder inputs start with BOS (dataset.py:461 uses
    # bos_token_id); generation must match or the first-step distribution is
    # garbage.  The reference generates from the HF config's
    # decoder_start_token_id instead — a silent train/eval mismatch; we pin
    # both to BOS.
    decoder_start_token_id: int = 101
    scale_embedding: bool = False
    tie_word_embeddings: bool = True


@_frozen()
class ModelConfig:
    hidden_dim: int = 768
    region_channel_counts: tuple[int, ...] = (16, 9, 11, 12)  # frontal/temporal/central/parietal
    max_region_channels: int = 16
    brain_encoder: BrainEncoderConfig = field(default_factory=BrainEncoderConfig)
    bart: BartConfig = field(default_factory=BartConfig)
    dtype: str = "bfloat16"           # compute dtype; params stay float32
    param_dtype: str = "float32"


# ---------------------------------------------------------------------------
# Signal frontend
# ---------------------------------------------------------------------------


@_frozen()
class FrontendConfig:
    """On-chip signal chain (the reference consumes Chisco's pre-processed
    derivatives; SURVEY.md §2.8).  Defaults follow standard EEG practice and
    the Chisco pipeline: 0.5-40 Hz bandpass, 50 Hz notch, common-average
    re-reference, STFT log-spectrogram features."""

    sample_rate_hz: float = 500.0
    bandpass_low_hz: float = 0.5
    bandpass_high_hz: float = 40.0
    bandpass_order: int = 4
    notch_hz: float = 50.0
    notch_q: float = 30.0
    car: bool = True                  # common-average re-reference
    stft_nperseg: int = 128
    stft_hop: int = 64
    stft_window: str = "hann"
    log_eps: float = 1e-10


# ---------------------------------------------------------------------------
# Generation / decoding
# ---------------------------------------------------------------------------


@_frozen()
class GenerationConfig:
    """Beam/greedy decoding (reference: training_config.py:32-39 eval block and
    HF generate defaults used by bart_decoder.py:66-78)."""

    max_length: int = 16
    min_length: int = 4
    num_beams: int = 3
    length_penalty: float = 1.0
    early_stopping: bool = True
    repetition_penalty: float = 1.0
    no_repeat_ngram_size: int = 0


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


@_frozen()
class LossConfig:
    """Composite anti-collapse loss (reference: the bytecode-only
    ``EnhancedCompositeSeq2SeqLoss`` — SURVEY.md §2.2; historical weights from
    config.yaml:135-141)."""

    composite: bool = True
    label_smoothing: float = 0.05
    w_ce: float = 1.0
    w_align: float = 0.5
    w_bow: float = 0.15
    w_div: float = 0.1
    w_var: float = 0.05
    contrastive_tau: float = 0.07
    bow_vocab_size: int = 2000
    adaptive: bool = True
    adaptation_rate: float = 0.01
    diversity_low: float = 0.3        # AdaptiveLossScheduler thresholds
    diversity_high: float = 0.8
    history_window: int = 10


# ---------------------------------------------------------------------------
# Optimizer / training
# ---------------------------------------------------------------------------


@_frozen()
class OptimizerConfig:
    """Three-group AdamW + warmup cosine (reference: training_config.py:55-77,
    scripts/train.py:199-241)."""

    encoder_lr: float = 3e-4          # brain_encoder.*
    projection_lr: float = 1e-4       # eeg_to_bart.*
    bart_lr: float = 3e-5             # bart.*
    weight_decay: float = 0.01
    warmup_steps: int = 500
    schedule: str = "cosine"          # "cosine" | "linear"
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0
    # single-tree-pass clip+AdamW (fused_optimizer.py); numerics match the
    # optax chain exactly (tested).  Default since round 4: measured 720 vs
    # 724 ms/window on v5e and identical loss curves
    # (runs/train_profile/accum_curve.json); set false for the optax chain.
    fused: bool = True
    # storage dtype for the FIRST moment (optax adamw mu_dtype semantics:
    # math in f32, mu stored narrow). "bfloat16" halves the m-state HBM
    # traffic (~0.6 GB/step at 310M params); nu stays float32.  Default
    # since round 4 (curve-guard verified); set None to store mu in f32.
    mu_dtype: str | None = "bfloat16"


@_frozen()
class CheckpointConfig:
    """Orbax checkpointing with the reference's cadence semantics
    (trainer.py:339-453): best-on-improvement, every N epochs, on-interrupt."""

    directory: str = "checkpoints"
    save_interval_epochs: int = 5
    max_to_keep: int = 3
    async_save: bool = True


@_frozen()
class TrainingConfig:
    num_epochs: int = 100
    batch_size: int = 4               # per-step micro batch (training_config.py:19)
    grad_accum_steps: int = 8         # effective batch 32 (training_config.py:20)
    eval_batch_size: int = 8
    seed: int = 42
    patience: int = 10                # early stopping
    min_diversity: float = 0.3        # model selection gate (trainer.py:462-479)
    diversity_improvement: float = 0.1
    bleu_tolerance_frac: float = 0.9  # secondary selection path
    collapse_tolerance: int = 3       # repetitive-collapse counter (trainer.py:400-443)
    # Evaluate (beam decode + metrics) every N epochs instead of every one
    # (reference evaluates per epoch, trainer.py:387-443; at T=1651 the
    # beam-decode eval can dominate short-epoch wall time, e.g. the
    # ablation sweeps).  Patience counts EVAL rounds, not epochs.  The
    # final epoch always evaluates.
    eval_interval_epochs: int = 1
    log_every_steps: int = 50
    # bf16 compute with float32 master params/optimizer state.  Divergence
    # from the reference (config.yaml `mixed_precision: false`): bf16 is the
    # MXU-native path and measures faster end-to-end with the flash training
    # kernels (33 vs 28 samples/s, tools/tpu_train_bench.py); set false to
    # reproduce the reference numerics exactly.
    mixed_precision: bool = True
    # Gradient-accumulation carry dtype under mixed precision.  "bfloat16"
    # (default since round 4) halves the accumulator HBM traffic across the
    # accumulation scan at the cost of ~8 low-order mantissa bits in the
    # summed gradient; measured 712 vs 724 ms/window on v5e with a
    # loss-curve delta <0.04% over 40 full-size windows
    # (tools/accum_curve_check.py -> runs/train_profile/accum_curve.json).
    # "float32" restores the standard master-gradient scheme (guard: the
    # accumulated-gradient parity test in tests/test_training.py).  Ignored
    # when mixed_precision is false.
    grad_accum_dtype: str = "bfloat16"
    # PRNG implementation for the in-step dropout keys.  "rbg" rides XLA's
    # hardware RngBitGenerator — measured 898 -> 794 ms/window on v5e (the
    # default threefry2x32 spends ~100 ms/window computing dropout masks on
    # the VPU).  Use "threefry2x32" when bit-identical dropout streams across
    # backends/compiler versions matter more than throughput.
    rng_impl: str = "rbg"
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)


# ---------------------------------------------------------------------------
# Parallelism
# ---------------------------------------------------------------------------


@_frozen()
class ParallelConfig:
    """Mesh layout (the reference is single-GPU — SURVEY.md §2.6; this is the
    TPU-native scale-out layer).  ``data`` × ``model`` axes over ICI; tensor
    parallelism shards the BART FFN/attention heads when ``model_axis > 1``."""

    data_axis: int = -1               # -1: use all remaining devices
    model_axis: int = 1
    dcn_axis: int = 1                 # >1: multi-slice data parallelism
    axis_names: tuple[str, str] = ("data", "model")
    remat: bool = False               # jax.checkpoint the encoder blocks

    @property
    def requested(self) -> bool:
        """True when the config explicitly asks for a multi-device mesh
        (``data_axis=-1`` alone is "auto" and does NOT trigger sharding —
        the trainer stays single-device unless sizes are given)."""
        return self.data_axis > 1 or self.model_axis > 1 or self.dcn_axis > 1


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------


@_frozen()
class Config:
    model_name: str = "eeg-bart-chinese"
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    generation: GenerationConfig = field(default_factory=GenerationConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    # ------------------------------------------------------------------
    def validate(self) -> "Config":
        """Sanity checks (reference: validate_config, training_config.py:80-82)."""
        d = self.data
        if abs(d.train_split + d.val_split + d.test_split - 1.0) > 1e-6:
            raise ValueError("data splits must sum to 1")
        if self.model.hidden_dim != self.model.bart.d_model:
            raise ValueError("hidden_dim must match bart d_model")
        if self.model.max_region_channels < max(self.model.region_channel_counts):
            raise ValueError("max_region_channels too small")
        r = self.model.brain_encoder.region_encoder
        if len(r.conv_channels) != len(r.conv_kernels):
            raise ValueError("conv_channels/conv_kernels length mismatch")
        if len(r.attn_heads) != r.num_attn_layers:
            raise ValueError("attn_heads must have num_attn_layers entries")
        if r.seq_shards < 1:
            raise ValueError("seq_shards must be >= 1")
        if r.seq_shards > 1 and r.cnn_only:
            raise ValueError("seq_shards>1 needs the token-attention path")
        if self.training.optimizer.warmup_steps < 0:
            raise ValueError("warmup_steps must be >= 0")
        if self.training.rng_impl not in ("rbg", "threefry2x32", "unsafe_rbg"):
            raise ValueError(f"unknown rng_impl {self.training.rng_impl!r}")
        if self.training.optimizer.mu_dtype not in (None, "bfloat16", "float32"):
            raise ValueError(
                f"unknown mu_dtype {self.training.optimizer.mu_dtype!r}"
            )
        return self

    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Config":
        return _from_dict(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _from_dict(cls, d):
    if not dataclasses.is_dataclass(cls):
        return d
    kwargs = {}
    hints = {f.name: f for f in dataclasses.fields(cls)}
    for k, v in d.items():
        if k not in hints:
            raise KeyError(f"unknown config key {k!r} for {cls.__name__}")
        f = hints[k]
        sub = f.default_factory() if f.default_factory is not dataclasses.MISSING else None  # type: ignore[misc]
        if sub is not None and dataclasses.is_dataclass(sub):
            kwargs[k] = _from_dict(type(sub), v)
        elif isinstance(v, list):
            kwargs[k] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def default_config() -> Config:
    return Config().validate()


def replace_nested(cfg, path: str, value):
    """Replace a dotted-path field, e.g. ``replace_nested(cfg, 'training.seed', 7)``."""
    parts = path.split(".")
    if len(parts) == 1:
        return dataclasses.replace(cfg, **{parts[0]: value})
    child = getattr(cfg, parts[0])
    return dataclasses.replace(
        cfg, **{parts[0]: replace_nested(child, ".".join(parts[1:]), value)}
    )
