"""End-to-end host dataset: corpus → stacked regions → normalize → augment →
tokenize, producing fixed-shape numpy batches for the device feed.

Reference: ``main_model/src/data/dataset.py`` (``EEGDataset``).  Differences,
all deliberate TPU-first redesigns:

* Samples are dense ``(R=4, C=16, T)`` tensors + channel mask, not ragged
  lists (see ``regions.RegionSpec``) — one static-shape XLA program.
* The scaler-fit subset is drawn with a *seeded* RNG (the reference uses the
  global ``np.random`` state, dataset.py:106 — irreproducible; SURVEY.md §7
  hard part 4).
* Augmentation keys are derived per (epoch, sample) so results are
  reproducible and worker-count independent.
* Invalid samples yield the reference's zeroed fallback (dataset.py:332-337).

A copy of ``imagined_speech_translation_tpu.data.dataset``: importing that
package loads jax (``data/__init__.py`` imports the device feed), and the
port never does.  ``tests/test_torch_data_pipeline.py`` holds the copy to
the original.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import AugmentationConfig, DataConfig
from .chisco import ChiscoCorpus, clean_eeg, validate_sample
from .regions import RegionSpec, load_montage
from .scaler import RegionRobustScaler
from .tokenizer import ChineseCharTokenizer


def split_indices(
    n: int, splits: tuple[float, float, float], seed: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Seeded train/val/test permutation split (reference:
    ``scripts/train.py:148-162`` uses ``torch.random_split`` with a generator
    seeded to the global seed; here a numpy permutation)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_train = int(round(splits[0] * n))
    n_val = int(round(splits[1] * n))
    return perm[:n_train], perm[n_train : n_train + n_val], perm[n_train + n_val :]


def augment_regions(
    stacked: np.ndarray,
    cfg: AugmentationConfig,
    rng: np.random.Generator,
) -> np.ndarray:
    """Noise / amplitude-scale / circular-shift augmentation, applied
    independently per region with the reference's probabilities and magnitudes
    (dataset.py:227-261).  Draw order per region matches the reference:
    noise, scale, shift."""
    out = stacked.copy()
    for r in range(stacked.shape[0]):
        region = out[r]
        if rng.random() < cfg.noise_prob:
            std = max(float(region.std()) * cfg.noise_std_frac, 1e-6)
            region = region + rng.normal(0.0, std, region.shape).astype(np.float32)
        if rng.random() < cfg.amp_scale_prob:
            region = region * np.float32(
                rng.uniform(1.0 - cfg.amp_scale_range, 1.0 + cfg.amp_scale_range)
            )
        if rng.random() < cfg.shift_prob:
            shift = int(rng.integers(-cfg.max_shift, cfg.max_shift + 1))
            if shift != 0:
                region = np.roll(region, shift, axis=-1)
        out[r] = region
    return out


@dataclass
class Example:
    eeg: np.ndarray               # (R, C_max, T) float32
    decoder_input_ids: np.ndarray  # (L,) int32
    labels: np.ndarray             # (L,) int32 (-100 at pad)
    attention_mask: np.ndarray     # (L,) int32


class EEGTextDataset:
    """Chisco EEG→text dataset over the stacked-region layout."""

    def __init__(
        self,
        data_dir: str,
        montage_csv: str,
        tokenizer: ChineseCharTokenizer,
        config: DataConfig | None = None,
        *,
        augment: bool = True,
        seed: int = 42,
        scaler: RegionRobustScaler | None = None,
    ):
        self.cfg = config or DataConfig()
        self.tokenizer = tokenizer
        self.augment = augment
        self.seed = seed

        ch_names = load_montage(montage_csv)
        self.region_spec = RegionSpec.from_channel_names(ch_names, max_channels=None)
        self.corpus = ChiscoCorpus(
            data_dir,
            max_samples=self.cfg.max_samples,
            n_channels_total=self.cfg.n_channels_total,
        )
        if len(self.corpus) == 0:
            raise ValueError(f"no valid samples under {data_dir}")
        self.n_timepoints = self._probe_timepoints()
        self.scaler = scaler or self._fit_scaler()

    # ------------------------------------------------------------------
    def _probe_timepoints(self) -> int:
        for i in range(min(len(self.corpus), 16)):
            s = self.corpus.get(i)
            if s is None:
                continue
            eeg = clean_eeg(s["input_features"])
            if eeg is not None:
                return eeg.shape[-1]
        return self.cfg.n_timepoints

    def _stack_sample(self, sample) -> np.ndarray | None:
        eeg = clean_eeg(sample["input_features"])
        if eeg is None or eeg.shape[0] < self.region_spec.gather_indices.max() + 1:
            return None
        stacked = self.region_spec.stack(eeg)
        t = stacked.shape[-1]
        if t == self.n_timepoints:
            return stacked
        # static-shape guarantee: trim or zero-pad time to the probed length
        if t > self.n_timepoints:
            return stacked[..., : self.n_timepoints]
        out = np.zeros(stacked.shape[:-1] + (self.n_timepoints,), np.float32)
        out[..., :t] = stacked
        return out

    def _fit_scaler(self) -> RegionRobustScaler:
        """Deterministic analogue of ``_initialize_scalers_efficiently``
        (dataset.py:102-151): fit on min(100, max(10, N//10)) samples chosen
        by a seeded RNG."""
        n = len(self.corpus)
        size = min(self.cfg.scaler_fit_samples, max(10, n // 10))
        size = min(size, n)
        rng = np.random.default_rng(self.seed)
        chosen = rng.choice(n, size=size, replace=False)
        stacks = []
        for idx in chosen:
            s = self.corpus.get(int(idx))
            if s is None:
                continue
            st = self._stack_sample(s)
            if st is not None:
                stacks.append(st)
        if not stacks:
            raise ValueError("no valid samples available to fit scaler")
        scaler = RegionRobustScaler(quantile_range=self.cfg.scaler_quantile_range)
        scaler.fit(np.stack(stacks), self.region_spec.channel_mask)
        return scaler

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.corpus)

    def _fallback(self) -> Example:
        eeg = np.zeros(
            (len(self.region_spec.region_names), self.region_spec.max_channels, self.n_timepoints),
            np.float32,
        )
        tok = self.tokenizer.fallback_encoding(self.cfg.max_length)
        return Example(eeg=eeg, **tok)

    def get(self, idx: int, *, epoch: int = 0) -> Example:
        sample = self.corpus.get(idx)
        if sample is None:
            return self._fallback()
        stacked = self._stack_sample(sample)
        if stacked is None:
            return self._fallback()
        normalized = self.scaler.transform(stacked)
        # keep padded slots exactly zero after augmentation
        if self.augment and self.cfg.augmentation.enabled:
            rng = np.random.default_rng((self.seed, epoch, idx))
            normalized = augment_regions(normalized, self.cfg.augmentation, rng)
            normalized = np.where(
                self.region_spec.channel_mask[..., None], normalized, 0.0
            ).astype(np.float32)
        text = sample.get("text", "")
        tok = self.tokenizer.encode_for_seq2seq(text, self.cfg.max_length)
        return Example(eeg=normalized, **tok)

    def stats(self, *, sample_size: int = 50, seed: int = 0) -> dict:
        """Sampled regional statistics (reference:
        ``_compute_regional_stats_sample`` / ``get_sample_stats``,
        dataset.py:263-292, 541-550)."""
        rng = np.random.default_rng(seed)
        n = min(sample_size, len(self))
        idx = rng.choice(len(self), size=n, replace=False)
        acc = []
        for i in idx:
            acc.append(self.get(int(i)).eeg)
        stacked = np.stack(acc)  # (n, R, C, T)
        regional = {}
        for r, name in enumerate(self.region_spec.region_names):
            cnt = self.region_spec.counts[r]
            data = stacked[:, r, :cnt]
            regional[name] = {
                "num_channels": cnt,
                "overall_mean": float(data.mean()),
                "overall_std": float(data.std()),
                "shape": list(data.shape),
            }
        return {
            "total_samples": len(self),
            "loading_mode": "lazy_loading_with_caching",
            "normalization": f"RegionRobustScaler(quantile_range={self.cfg.scaler_quantile_range})",
            "augmentation_enabled": self.augment and self.cfg.augmentation.enabled,
            "region_channel_counts": dict(
                zip(self.region_spec.region_names, self.region_spec.counts)
            ),
            "regional_stats": regional,
        }

    def get_batch(self, indices, *, epoch: int = 0) -> dict[str, np.ndarray]:
        ex = [self.get(int(i), epoch=epoch) for i in indices]
        return {
            "eeg": np.stack([e.eeg for e in ex]),
            "decoder_input_ids": np.stack([e.decoder_input_ids for e in ex]),
            "labels": np.stack([e.labels for e in ex]),
            "attention_mask": np.stack([e.attention_mask for e in ex]),
            "channel_mask": self.region_spec.channel_mask,
        }
