"""Synthetic MIMIC-II-like medical dataset.

The real MIMIC II requires a data-use agreement; this generator reproduces its
*shape*: structured patient records (relational), free-text notes (sparse
term counts), and physiologic ECG-like waveforms (arrays), with a
hemodynamic-deterioration label wired into the waveform statistics so the
paper's §IV-B classifier has signal to find (Saeed & Mark's wavelet-signature
method can separate the classes).

Generation is numpy, seeded exactly as the reference package does it, so
both packages see the same data; containers wrap it on ``device`` (``None``
means the CUDA card, see ``tables.resolve_device``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.tables import (COOMatrix, ColumnarTable, DenseTensor,
                                     resolve_device, to_device)


def ecg_waveforms(n_patients: int, n_samples: int = 16384, seed: int = 0,
                  deterioration_frac: float = 0.3):
    """(N, T) float32 waveforms + (N,) binary deterioration labels, as
    numpy arrays.

    Healthy: stable quasi-periodic beats.  Deteriorating: progressive
    amplitude decay, rate drift and rising low-frequency variance — the
    multi-scale wavelet energy signature Saeed & Mark exploit.
    """
    rng = np.random.default_rng(seed)
    labels = (rng.random(n_patients) < deterioration_frac).astype(np.int32)
    t = np.arange(n_samples, dtype=np.float32)
    out = np.empty((n_patients, n_samples), np.float32)
    for i in range(n_patients):
        rate = rng.uniform(0.035, 0.055)            # beats per sample
        phase = rng.uniform(0, 2 * np.pi)
        beat = (np.sin(2 * np.pi * rate * t + phase)
                + 0.4 * np.sin(4 * np.pi * rate * t + 2 * phase)
                + 0.15 * np.sin(6 * np.pi * rate * t))
        noise = rng.normal(0, 0.12, n_samples).astype(np.float32)
        if labels[i]:
            decay = np.exp(-t / (n_samples * rng.uniform(0.7, 1.4)))
            drift = 0.35 * np.sin(2 * np.pi * rng.uniform(1.5, 4.0)
                                  * t / n_samples)
            lfn = np.cumsum(rng.normal(0, 0.02, n_samples)).astype(np.float32)
            sig = beat * decay + drift + lfn + noise
        else:
            sig = beat + noise
        out[i] = sig.astype(np.float32)
    return out, labels


def patients_table(n_patients: int, seed: int = 1, *,
                   device=None) -> ColumnarTable:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    cols = {
        "patient_id": np.arange(n_patients, dtype=np.int32),
        "age": rng.integers(18, 95, n_patients).astype(np.int32),
        "gender": rng.integers(0, 2, n_patients).astype(np.int32),
        "icu_type": rng.integers(0, 4, n_patients).astype(np.int32),
        "heart_rate_mean": rng.normal(82, 14, n_patients).astype(np.float32),
        "sapsi": rng.integers(0, 32, n_patients).astype(np.int32),
    }
    return ColumnarTable({c: to_device(v, dev) for c, v in cols.items()})


def notes_coo(n_patients: int, vocab: int = 4096, terms_per_note: int = 60,
              n_topics: int = 8, seed: int = 2, *, device=None) -> COOMatrix:
    """Doctor/nurse notes as a (patients × terms) sparse count matrix with
    topic structure (for the Text Analytics application)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    topic_of = rng.integers(0, n_topics, n_patients)
    rows, cols, vals = [], [], []
    base = rng.zipf(1.5, size=(n_topics, terms_per_note)) % vocab
    for i in range(n_patients):
        terms = np.unique(np.concatenate([
            base[topic_of[i]],
            rng.integers(0, vocab, terms_per_note // 3)]))
        rows.append(np.full(terms.shape, i, np.int32))
        cols.append(terms.astype(np.int32))
        vals.append(rng.poisson(2.0, terms.shape).astype(np.float32) + 1.0)
    return COOMatrix(to_device(np.concatenate(rows), dev),
                     to_device(np.concatenate(cols), dev),
                     to_device(np.concatenate(vals), dev),
                     (n_patients, vocab))


def mimic_like_dataset(n_patients: int = 600, n_samples: int = 16384,
                       seed: int = 0, *, device=None):
    """The full polystore-resident dataset of the paper's §III:
    waveforms -> array engine, demographics -> columnar, notes -> kv."""
    dev = resolve_device(device)
    waves, labels = ecg_waveforms(n_patients, n_samples, seed)
    return {
        "waveforms": DenseTensor(to_device(waves, dev)),
        "labels": labels,
        "patients": patients_table(n_patients, seed + 1, device=dev),
        "notes": notes_coo(n_patients, seed=seed + 2, device=dev),
    }
