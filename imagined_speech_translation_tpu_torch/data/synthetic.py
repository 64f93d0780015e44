"""Synthetic Chisco-layout corpus + montage for tests and benchmarks.

The real data is a 224-file OpenNeuro download (``main_model/data/dataset.sh``)
that cannot be assumed present; this generates pickles with the exact on-disk
layout the reference consumes: each file a list of
``{'input_features': (1, 125, T) float32, 'text': str}`` dicts
(SURVEY.md §4 test-strategy item (c)).

A copy of ``imagined_speech_translation_tpu.data.synthetic``: importing that
package loads jax (``data/__init__.py`` imports the device feed), and the
port never does.  ``tests/test_torch_data_pipeline.py`` holds the copy to
the original.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from .regions import ELECTRODE_REGIONS

DEFAULT_TEXTS = (
    "我想喝水",
    "请帮我打开窗户",
    "今天天气很好",
    "我需要休息一下",
    "谢谢你的帮助",
    "我们去公园散步",
    "请把音乐关掉",
    "晚饭吃什么",
)


def make_synthetic_montage(path: str | Path, n_channels: int = 125) -> list[str]:
    """Write a montage CSV whose ``label`` column contains the 48 mapped
    electrodes (interleaved among filler channels, mimicking the real montage
    where 48/125 rows map to regions)."""
    mapped = [ch for region in ELECTRODE_REGIONS.values() for ch in region]
    labels = []
    fill = 0
    rng = np.random.default_rng(0)
    positions = sorted(rng.choice(n_channels, size=len(mapped), replace=False))
    mapped_iter = iter(mapped)
    for i in range(n_channels):
        if positions and i == positions[0]:
            positions = positions[1:]
            labels.append(next(mapped_iter))
        else:
            labels.append(f"AUX{fill}")
            fill += 1
    lines = ["label,x,y,z"]
    for i, lab in enumerate(labels):
        lines.append(f"{lab},{i * 0.01:.3f},0.0,0.0")
    Path(path).write_text("\n".join(lines) + "\n")
    return labels


# ---- echo-mode layout (shared with the probe tests) -----------------------
# 8 classes in 4 text-pairs; codeword = one 2v2-split index per slot, length
# 3 over alphabet {0,1,2}, pairwise Hamming >= 2 (survives one corrupted
# region).  Pair 0's words are slot-0/2 REVERSES of each other — the one
# pair whose members are separable only positionally (pos-emb ablation);
# the other pairs differ even as {slot0,slot2} multisets.
ECHO_CODEBOOK = (
    (0, 1, 2), (2, 1, 0),   # pair 0 (positional pair)
    (0, 2, 1), (1, 0, 2),   # pair 1
    (1, 2, 0), (2, 0, 1),   # pair 2
    (0, 0, 0), (1, 1, 1),   # pair 3
)
ECHO_LAG = 64        # anchor->echo offset, >> conv receptive field (25)
ECHO_ANCHOR_LEN = 32
# per-slot echo envelope: slots 0/2 mirror the anchor EXACTLY (ordering is
# positional-only -> provably sealed from position-blind pooling); slot 1's
# echo is longer (content-ordered -> readable without positions)
ECHO_ECHO_LENS = (32, 48, 32)
# per-slot XOR bit: only slot 1 is XOR-masked.  Slots 0/2 carry the split
# bit directly — their ordered-sign code is unreadable without positions
# anyway, and the direct per-region correlation gives gradient descent a
# bootstrap path (the round-4 pilot showed the fully-XORed code is
# information-theoretically right but not FOUND by SGD); slot 1's mask
# keeps the content-ordered slot's weak pooled-statistic leak XOR-masked
# so cnn_only cannot ride it.
ECHO_XOR_SLOTS = (False, True, False)
# base carrier per slot (Hz); all far below the 36-60 Hz pair-signature
# band and mutually distinguishable by an RF-25 conv feature.
ECHO_FREQS = (8.0, 6.0, 8.0)
# alternate carrier for the ORDERED CARRIER-PAIR slots (0 and 2): the
# anchor takes one of {base, alt} and the echo takes the other — WHICH
# comes first is the bit.  The unordered burst multiset {base-burst,
# alt-burst} is identical for both bit values, so pooled local features,
# order statistics (max pooling), and even global magnitude spectra (no
# coherent cross-terms between distinct carriers) are all blind; reading
# the bit needs position-aware comparison, and a conv stem + positional
# attention learns it as "which frequency sits at the anchor position" —
# a frequency-detector + linear readout, the most SGD-natural form of the
# order code (phase-quadrature codes were never found by SGD in pilots).
# Slot 1 (alt=None) keeps the ±π/2 phase code instead.
ECHO_ALT_FREQS = (16.0, None, 16.0)


def echo_layout(n_timepoints: int) -> list[tuple[int, int]]:
    """Per-slot (anchor_start, echo_start) for echo mode at this T."""
    stride = (n_timepoints - 40) // 3
    return [(20 + j * stride, 20 + j * stride + ECHO_LAG) for j in range(3)]


def _echo_slot_bits(code, xi_bits, n_regions, splits):
    """Per-slot per-region bit array b(r, j) from the class codeword."""
    out = []
    for j, c in enumerate(code):
        _, grp_b = splits[c]
        in_b = np.zeros(n_regions, dtype=int)
        in_b[list(grp_b)] = 1
        out.append(in_b ^ int(xi_bits[j]))
    return out


def make_synthetic_corpus(
    data_dir: str | Path,
    *,
    n_files: int = 3,
    samples_per_file: int = 4,
    n_channels: int = 125,
    n_timepoints: int = 256,
    texts=DEFAULT_TEXTS,
    seed: int = 0,
    class_conditioned: bool | str = False,
    noise_scale: float = 1.0,
    montage_labels: list[str] | None = None,
) -> list[Path]:
    """Write pickle files; EEG is band-limited noise with per-channel offsets
    so robust scaling is non-trivial.

    ``class_conditioned=True`` makes the EEG *decodable*: each text gets a
    fixed per-channel oscillatory signature (distinct frequency/phase mix)
    that is added under the noise, so a model can generalize text from
    held-out windows — the training-proof corpus (imagined-speech stand-in
    with a learnable signal, unlike the pure-noise default).

    ``class_conditioned="relational"`` is the architecture-ablation mode:
    classes are grouped in PAIRS that share one per-channel local
    signature (so any region-local feature extractor — a pure CNN —
    structurally ceilings at pair-level identification), and the two
    classes of a pair are disambiguated ONLY by cross-region phase
    offsets: all classes share the same component frequencies/amplitudes
    (distinct integer DFT bins), each sample gets a random global phase
    per component, and a class-fixed per-region phase offset rides on
    top — so within a pair, region-local statistics are class-invariant
    by construction and separating the pair requires integrating phase
    ACROSS regions, the job of the cross-region attention / fusion stack
    the paper ablates (Table 24).  Requires ``montage_labels`` (channels
    not mapped to a region carry only the local pair signature + noise).

    ``class_conditioned="coupled"`` is the stricter successor (round-4
    verdict: the relational corpus let linear region mixes decode relative
    phase via summed-sinusoid amplitude, inverting the paper's CNN-family
    ordering).  Classes again come in pairs sharing a region-local
    signature; the pair MEMBER is coded by per-time-slot 2v2
    in-phase/anti-phase splits of the four regions:

    * per slot, exactly two regions burst at phase ψ and two at ψ+π, so
      EVERY linear mix over regions — uniform mean, region-axis convs, any
      fixed weighting — cancels identically to zero;
    * ψ and the carrier cycle count are random per sample/slot, so
      "phase at slot j" is not a stable region-local feature either;
    * the class-specific quantity is WHICH regions coincide per slot (a
      split code with pairwise Hamming ≥ 2), a pure pairwise-coincidence
      readout — the natural fixed point of attention's QKᵀ between region
      tokens and invisible to sum-then-nonlinearity mixers;
    * slots sit at fixed times, so temporal indexing (positional
      embeddings / in-region token attention) is load-bearing;
    * half the samples corrupt one region (signal dropped, 3× noise),
      rewarding dynamic region gating over uniform weights.

    ``class_conditioned="echo"`` is the round-4 successor to "coupled".
    The coupled corpus's 2v2 split is linearly invisible on RAW signals,
    but after the per-region encoders the burst phases live in feature
    space where ANY cross-region nonlinearity (the multi-scale gelu-conv
    over the region axis, present in every ablation variant) can decode
    the coincidence — which let the CNN-family variants win the sweep.
    Echo mode moves the member bit to a statistic that is first-order
    invisible to position-blind pooled conv features:

    * per slot j, every region emits an ANCHOR burst and an ECHO burst
      ``ECHO_LAG`` samples later — far beyond the conv stem's receptive
      field (kernels 9/7/5/5/3, stride 1 → RF = 25 samples);
    * the anchor's carrier phase θ(r,j) is i.i.d. uniform per
      region/slot/SAMPLE; the echo's phase is θ(r,j) ± π/2 with the SIGN
      carrying the bit b(r,j).  An ordered-sign code, not a phase flip:
      the unordered burst pair {θ, θ±π/2} has the SAME distribution for
      either sign ({θ, θ+π/2} ≡ {φ−π/2, φ} under φ=θ+π/2), so every
      permutation-invariant pooled statistic of local features — mean,
      max, attention pooling, any spectrum — is blind to b by symmetry
      (a π-flip code would leak |Δphase| ∈ {0, π} to max pooling).
      Reading b needs the SIGNED anchor×echo comparison at a 64-sample
      lag, i.e. position-aware cross-time products: the in-region token
      attention's QKᵀ (ablated by ``cnn_only``);
    * slots 0/2: echo envelope IDENTICAL to the anchor, so anchor/echo are
      distinguishable only by POSITION — without positional embeddings the
      network is permutation-equivariant past the conv stem (RF < gap) and
      provably cannot order the pair; b(r,j) = split(class,j)(r) directly
      (no XOR): a single region's lag-sign correlates with the class, the
      gradient-descent bootstrap path (a fully XOR-masked code is
      information-theoretically identical but was never FOUND by SGD in
      the round-4 pilots);
    * slot 1: echo envelope LONGER than the anchor (content-ordered, so a
      position-blind attention model can still read it) but XOR-masked by
      a fresh random bit ξ per sample — reading it needs BETWEEN-region
      comparison (b(r)⊕b(r') cancels ξ), and the content asymmetry's weak
      pooled-statistic leak stays class-uncorrelated region-locally;
    * pair 0's codewords differ ONLY in slots 0/2 (slot-1 code equal), so
      that pair needs the position-ordered slots — removing pos-emb costs
      one pair of eight, matching the paper's small Table-24 drop, while
      cnn_only (no in-region attention at all) reads NO slot;
    * a 0.3-probability corrupted region (signal dropped, extra noise)
      rewards dynamic region gating over uniform weights.

    Requires ``n_timepoints >= 384``.
    """
    relational = class_conditioned == "relational"
    coupled = class_conditioned == "coupled"
    echo = class_conditioned == "echo"
    if (relational or coupled or echo) and montage_labels is None:
        raise ValueError("relational/coupled/echo mode needs montage_labels")
    if echo and n_timepoints < 384:
        raise ValueError("echo mode needs n_timepoints >= 384")
    out_dir = Path(data_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    t = np.arange(n_timepoints) / 256.0
    signatures = {}
    region_of = np.full(n_channels, -1)
    rel_freqs = rel_amps = rel_deltas = None
    cpl_codes = cpl_slots = None
    # 2v2 in-phase/anti-phase splits of the 4 regions: every linear region
    # mix (uniform mean, conv over the region axis, any fixed weighting)
    # cancels EXACTLY, so the split is only visible to modules that compare
    # region time courses pairwise — the cross-region attention / fusion
    # stack the paper ablates (Table 24)
    CPL_SPLITS = (((0, 1), (2, 3)), ((0, 2), (1, 3)), ((0, 3), (1, 2)))
    if relational or coupled or echo:
        from .regions import ELECTRODE_REGIONS

        for r, (_, members) in enumerate(ELECTRODE_REGIONS.items()):
            mem = set(members)
            for c, lab in enumerate(montage_labels[:n_channels]):
                if lab in mem:
                    region_of[c] = r
        n_regions = len(ELECTRODE_REGIONS)
    if echo:
        sig_rng = np.random.default_rng(seed + 1)
        echo_slots = echo_layout(n_timepoints)
        # pair-level LOCAL signature (36-60 Hz per-channel mix, above the
        # 18/26 Hz burst carriers): the easy, region-locally decodable half
        # — every variant can find the pair; only position-aware lagged
        # comparison + cross-region integration finds the member
        for k_pair in range((len(texts) + 1) // 2):
            freqs = np.floor(sig_rng.uniform(36, 60, (n_channels, 3)))
            phases = sig_rng.uniform(0, 2 * np.pi, (n_channels, 3))
            amps = sig_rng.uniform(0.5, 2.0, (n_channels, 3))
            signatures[k_pair] = (
                amps[:, :, None]
                * np.sin(2 * np.pi * freqs[:, :, None] * t + phases[:, :, None])
            ).sum(axis=1)[None]  # (1, C, T)
    if coupled:
        sig_rng = np.random.default_rng(seed + 1)
        # J fixed, non-overlapping time slots (class-independent layout):
        # time-localized events make temporal indexing (positional
        # embeddings, in-region token attention) load-bearing
        n_slots = 4
        slot_len = n_timepoints // (2 * n_slots)
        starts = [
            (2 * j + 1) * n_timepoints // (2 * n_slots) - slot_len // 2
            for j in range(n_slots)
        ]
        cpl_slots = [(s, s + slot_len) for s in starts]
        # one split code per CLASS, pairwise Hamming >= 2 so the code
        # survives any single corrupted region
        while True:
            cand = sig_rng.integers(0, 3, (len(texts), n_slots))
            ok = all(
                (cand[a] != cand[b]).sum() >= 2
                for a in range(len(texts))
                for b in range(a + 1, len(texts))
            )
            if ok:
                cpl_codes = cand
                break
        # pair-level LOCAL signature (31-60 Hz per-channel mix): the easy,
        # region-locally decodable half of the task — every variant can
        # find the pair; only cross-region coincidence finds the member
        for k_pair in range((len(texts) + 1) // 2):
            freqs = np.floor(sig_rng.uniform(31, 60, (n_channels, 3)))
            phases = sig_rng.uniform(0, 2 * np.pi, (n_channels, 3))
            amps = sig_rng.uniform(0.5, 2.0, (n_channels, 3))
            signatures[k_pair] = (
                amps[:, :, None]
                * np.sin(2 * np.pi * freqs[:, :, None] * t + phases[:, :, None])
            ).sum(axis=1)[None]  # (1, C, T)
    if relational:
        sig_rng = np.random.default_rng(seed + 1)
        n_comp = 3
        # shared across ALL classes: spectra carry no class information.
        # Distinct INTEGER frequencies = exact DFT bins on the 1-s/256-pt
        # window, so the components don't leak into each other's bins and
        # the cross-region phase code stays clean under each component's
        # independent random global phase
        rel_freqs = np.sort(
            sig_rng.choice(np.arange(4, 31), n_comp, replace=False)
        ).astype(np.float64)
        rel_amps = sig_rng.uniform(1.0, 2.0, n_comp)
        # per-class per-region per-component phase offsets — the only
        # class-dependent quantity in the signal
        rel_deltas = sig_rng.uniform(
            0, 2 * np.pi, (len(texts), n_regions, n_comp)
        )
        # one local signature per PAIR of classes (k // 2): a region-local
        # model can find the pair but not the member
        for k_pair in range((len(texts) + 1) // 2):
            freqs = np.floor(sig_rng.uniform(31, 60, (n_channels, 3)))
            phases = sig_rng.uniform(0, 2 * np.pi, (n_channels, 3))
            amps = sig_rng.uniform(0.5, 2.0, (n_channels, 3))
            signatures[k_pair] = (
                amps[:, :, None]
                * np.sin(2 * np.pi * freqs[:, :, None] * t + phases[:, :, None])
            ).sum(axis=1)[None]  # (1, C, T)
    elif class_conditioned and not (coupled or echo):
        sig_rng = np.random.default_rng(seed + 1)
        for k_text, text in enumerate(texts):
            freqs = sig_rng.uniform(2.0, 40.0, (n_channels, 3))
            phases = sig_rng.uniform(0, 2 * np.pi, (n_channels, 3))
            amps = sig_rng.uniform(0.5, 2.0, (n_channels, 3))
            signatures[text] = (
                amps[:, :, None]
                * np.sin(2 * np.pi * freqs[:, :, None] * t + phases[:, :, None])
            ).sum(axis=1)[None]  # (1, C, T)
    paths = []
    k = 0
    for f in range(n_files):
        samples = []
        for _ in range(samples_per_file):
            text = texts[k % len(texts)]
            base = rng.normal(0, noise_scale, (1, n_channels, n_timepoints))
            drift = rng.normal(0, 5, (1, n_channels, 1))
            scalep = rng.uniform(0.5, 3.0, (1, n_channels, 1))
            eeg = base * scalep + drift
            if echo:
                k_text = texts.index(text)
                mapped = region_of >= 0
                sig = signatures[k_text // 2].copy()[0]  # (C, T) pair-local
                code = ECHO_CODEBOOK[k_text % len(ECHO_CODEBOOK)]
                for j, (a0, e0) in enumerate(echo_slots):
                    xi = int(rng.integers(0, 2)) if ECHO_XOR_SLOTS[j] else 0
                    _, grp_b = CPL_SPLITS[code[j]]
                    in_b = np.zeros(n_regions, dtype=int)
                    in_b[list(grp_b)] = 1
                    b_bits = in_b ^ xi
                    f_c = ECHO_FREQS[j]
                    f_alt = ECHO_ALT_FREQS[j]
                    e_len = ECHO_ECHO_LENS[j]
                    # per-burst amplitude jitter smears order statistics
                    # (max pooling) without touching the order code
                    amp_a = rng.uniform(0.8, 1.2, n_regions)
                    amp_e = rng.uniform(0.8, 1.2, n_regions)
                    ta = np.arange(ECHO_ANCHOR_LEN) / 256.0
                    te = np.arange(e_len) / 256.0
                    wa = np.hanning(ECHO_ANCHOR_LEN)
                    we = np.hanning(e_len)
                    if f_alt is not None:
                        # ordered carrier-pair code: anchor carrier = alt
                        # iff b, echo takes the other; phases i.i.d.
                        th_a = rng.uniform(0, 2 * np.pi, n_regions)
                        th_e = rng.uniform(0, 2 * np.pi, n_regions)
                        fa = np.where(b_bits == 1, f_alt, f_c)
                        fe = np.where(b_bits == 1, f_c, f_alt)
                        anchors = amp_a[:, None] * wa[None] * np.sin(
                            2 * np.pi * fa[:, None] * ta[None]
                            + th_a[:, None]
                        )
                        echoes = amp_e[:, None] * we[None] * np.sin(
                            2 * np.pi * fe[:, None] * te[None]
                            + th_e[:, None]
                        )
                    else:
                        # ordered-sign phase code: echo leads (+π/2) or
                        # trails (−π/2) the anchor's carrier phase
                        delta = np.pi / 2.0 * (1 - 2 * b_bits)
                        theta = rng.uniform(0, 2 * np.pi, n_regions)
                        anchors = amp_a[:, None] * wa[None] * np.sin(
                            2 * np.pi * f_c * ta[None] + theta[:, None]
                        )
                        echoes = amp_e[:, None] * we[None] * np.sin(
                            2 * np.pi * f_c * te[None]
                            + theta[:, None] + delta[:, None]
                        )
                    sig[mapped, a0:a0 + ECHO_ANCHOR_LEN] += (
                        4.5 * anchors[region_of[mapped]]
                    )
                    sig[mapped, e0:e0 + e_len] += (
                        4.5 * echoes[region_of[mapped]]
                    )
                # corrupted region (p=0.3): signal dropped, 3× noise —
                # dynamic region gating must learn to suppress it
                if rng.uniform() < 0.3:
                    r_bad = int(rng.integers(0, n_regions))
                    bad = mapped & (region_of == r_bad)
                    sig[bad] = 0.0
                    eeg[0, bad] += base[0, bad] * scalep[0, bad] * 2.0
                eeg = eeg + 3.0 * scalep * sig[None]
            elif coupled:
                k_text = texts.index(text)
                mapped = region_of >= 0
                sig = signatures[k_text // 2].copy()[0]  # (C, T) pair-local
                for j, (s0, s1) in enumerate(cpl_slots):
                    ls = s1 - s0
                    # integer cycles per slot -> the in/anti-phase code
                    # integrates cleanly; carrier randomized PER SAMPLE so
                    # "phase at slot j" is not a stable region-local feature
                    n_cyc = rng.integers(3, 6)
                    psi = rng.uniform(0, 2 * np.pi)
                    tau = np.arange(ls) / ls
                    burst = np.sin(2 * np.pi * n_cyc * tau + psi)
                    burst *= np.hanning(ls)  # no onset clicks
                    grp_a, grp_b = CPL_SPLITS[cpl_codes[k_text, j]]
                    sgn = np.zeros(n_regions)
                    sgn[list(grp_a)] = 1.0
                    sgn[list(grp_b)] = -1.0  # anti-phase: psi + pi
                    sig[mapped, s0:s1] += (
                        2.5 * sgn[region_of[mapped], None] * burst[None]
                    )
                # per-sample artifact: one region (p=0.5) loses its signal
                # and gains 3x noise — dynamic region gating must learn to
                # suppress it; uniform weighting averages the garbage in
                if rng.uniform() < 0.5:
                    r_bad = int(rng.integers(0, n_regions))
                    bad = mapped & (region_of == r_bad)
                    sig[bad] = 0.0
                    eeg[0, bad] += base[0, bad] * scalep[0, bad] * 2.0
                eeg = eeg + 3.0 * scalep * sig[None]
            elif relational:
                k_text = texts.index(text)
                # random global phase: absolute phase is uninformative,
                # only BETWEEN-region offsets separate a pair's members
                glob = rng.uniform(0, 2 * np.pi, 3)
                sig = np.zeros((n_channels, n_timepoints))
                for j in range(3):
                    ph = glob[j] + rel_deltas[k_text, :, j]  # (n_regions,)
                    wave = rel_amps[j] * np.sin(
                        2 * np.pi * rel_freqs[j] * t[None] + ph[:, None]
                    )  # (n_regions, T)
                    mapped = region_of >= 0
                    sig[mapped] += wave[region_of[mapped]]
                eeg = eeg + 3.0 * scalep * (sig[None] + signatures[k_text // 2])
            elif class_conditioned:
                eeg = eeg + 3.0 * scalep * signatures[text]
            samples.append(
                {
                    "input_features": eeg.astype(np.float32),
                    "text": text,
                }
            )
            k += 1
        p = out_dir / f"sub-0{f + 1}_task-imagine_run-1.pkl"
        with open(p, "wb") as fh:
            pickle.dump(samples, fh)
        paths.append(p)
    return paths
