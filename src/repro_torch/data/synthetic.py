"""Deterministic synthetic dataset generators for every paper experiment.

No datasets ship offline, so each generator builds a *learnable* synthetic
stand-in with the same tensor layout and difficulty knobs as the paper's
datasets (CIFAR10, MNIST, MovieLens1M, 20NewsGroups). All generators are pure
functions of a seed — experiments are bit-reproducible.

(A copy of ``repro/data/synthetic.py``: pure numpy, so both packages draw the
same data from a seed.)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClassificationData:
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray

    @property
    def num_classes(self) -> int:
        return int(self.y_train.max()) + 1


def gaussian_clusters(seed: int = 0, num_classes: int = 10, dim: int = 784,
                      n_train: int = 8192, n_test: int = 2048,
                      sep: float = 2.2, intrinsic_dim: int = 32) -> ClassificationData:
    """MNIST stand-in: classes are Gaussian blobs on a low-dim manifold
    embedded in ``dim`` with additive noise. ``sep`` controls difficulty —
    2.2 gives test accuracy ceilings near the paper's 92-95% MLR/DNN targets
    while remaining non-trivial (an untrained model sits at 1/num_classes)."""
    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((intrinsic_dim, dim)).astype(np.float32)
    basis /= np.linalg.norm(basis, axis=1, keepdims=True)
    centers = rng.standard_normal((num_classes, intrinsic_dim)).astype(np.float32) * sep

    def draw(n):
        y = rng.integers(0, num_classes, n)
        z = centers[y] + rng.standard_normal((n, intrinsic_dim)).astype(np.float32)
        x = z @ basis + 0.3 * rng.standard_normal((n, dim)).astype(np.float32)
        return x.astype(np.float32), y.astype(np.int32)

    xtr, ytr = draw(n_train)
    xte, yte = draw(n_test)
    return ClassificationData(xtr, ytr, xte, yte)


def synthetic_images(seed: int = 0, num_classes: int = 10, hw: int = 32,
                     channels: int = 3, n_train: int = 4096,
                     n_test: int = 1024, sep: float = 2.5) -> ClassificationData:
    """CIFAR10 stand-in: class templates are smoothed random images; samples
    are template + structured noise, so convolutions genuinely help."""
    rng = np.random.default_rng(seed)

    def smooth(img):
        # cheap separable blur to create spatial structure
        k = np.array([0.25, 0.5, 0.25], np.float32)
        img = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, img)
        img = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 2, img)
        return img

    templates = smooth(rng.standard_normal((num_classes, hw, hw, channels)).astype(np.float32)) * sep

    def draw(n):
        y = rng.integers(0, num_classes, n)
        noise = smooth(rng.standard_normal((n, hw, hw, channels)).astype(np.float32))
        x = templates[y] + noise
        return x.astype(np.float32), y.astype(np.int32)

    xtr, ytr = draw(n_train)
    xte, yte = draw(n_test)
    return ClassificationData(xtr, ytr, xte, yte)


def teacher_classification(seed: int = 0, num_classes: int = 10, dim: int = 784,
                           n_train: int = 16384, n_test: int = 4096,
                           latent: int = 24, teacher_hidden: int = 48,
                           margin: float = 0.25, label_noise: float = 0.02
                           ) -> ClassificationData:
    """MNIST stand-in with NONLINEAR class boundaries: labels come from a
    random 2-layer teacher MLP over a low-dim latent, samples near the
    decision boundary are resampled (margin), and a little label noise is
    added. Unlike Gaussian blobs this is not linearly separable — depth
    helps, and reaching the 92% target takes thousands of batches (needed so
    staleness slowdowns are measurable, mirroring the paper's MNIST runs)."""
    rng = np.random.default_rng(seed)
    # Mostly-linear teacher + a nonlinear correction (MNIST-like: a linear
    # model tops out near the low 90s, depth buys the rest).
    wl = rng.standard_normal((latent, num_classes)).astype(np.float32)
    w1 = rng.standard_normal((latent, teacher_hidden)).astype(np.float32)
    w2 = rng.standard_normal((teacher_hidden, num_classes)).astype(np.float32)
    basis = rng.standard_normal((latent, dim)).astype(np.float32) / np.sqrt(latent)

    def teacher(z):
        # normalized so the nonlinear part carries ~30% of the logit scale
        lin = z @ wl
        nonlin = np.tanh(z @ w1 / np.sqrt(latent)) @ w2 / np.sqrt(teacher_hidden)
        return lin + 2.0 * nonlin

    def draw(n):
        xs, ys = [], []
        need = n
        while need > 0:
            z = rng.standard_normal((2 * need, latent)).astype(np.float32)
            logits = teacher(z)
            top2 = np.sort(logits, axis=1)[:, -2:]
            keep = (top2[:, 1] - top2[:, 0]) > margin
            z = z[keep][:need]
            y = np.argmax(teacher(z), axis=1)
            x = z @ basis + 0.10 * rng.standard_normal((len(z), dim)).astype(np.float32)
            xs.append(x.astype(np.float32))
            ys.append(y.astype(np.int32))
            need -= len(z)
        x = np.concatenate(xs)[:n]
        y = np.concatenate(ys)[:n]
        flip = rng.random(n) < label_noise
        y[flip] = rng.integers(0, num_classes, flip.sum())
        return x, y

    xtr, ytr = draw(n_train)
    xte, yte = draw(n_test)
    return ClassificationData(xtr, ytr, xte, yte)


@dataclasses.dataclass(frozen=True)
class RatingsData:
    """MovieLens stand-in: observed entries of a noisy low-rank matrix."""
    rows: np.ndarray     # [n_obs] int32 user index
    cols: np.ndarray     # [n_obs] int32 item index
    vals: np.ndarray     # [n_obs] float32 rating
    num_users: int
    num_items: int
    true_rank: int


def low_rank_ratings(seed: int = 0, num_users: int = 600, num_items: int = 400,
                     rank: int = 5, density: float = 0.05,
                     noise: float = 0.1) -> RatingsData:
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((num_users, rank)).astype(np.float32) / np.sqrt(rank)
    v = rng.standard_normal((num_items, rank)).astype(np.float32) / np.sqrt(rank)
    n_obs = int(num_users * num_items * density)
    rows = rng.integers(0, num_users, n_obs).astype(np.int32)
    cols = rng.integers(0, num_items, n_obs).astype(np.int32)
    vals = np.einsum("nk,nk->n", u[rows], v[cols]) + noise * rng.standard_normal(n_obs)
    return RatingsData(rows, cols, vals.astype(np.float32), num_users, num_items, rank)


@dataclasses.dataclass(frozen=True)
class CorpusData:
    """20NewsGroups stand-in: documents sampled from an LDA generative model,
    so collapsed Gibbs has a true posterior to recover."""
    tokens: np.ndarray    # [n_docs, doc_len] int32 word ids (fixed length)
    num_docs: int
    vocab: int
    true_topics: int


def lda_corpus(seed: int = 0, n_docs: int = 400, doc_len: int = 64,
               vocab: int = 500, k_true: int = 10,
               alpha: float = 0.1, beta: float = 0.1) -> CorpusData:
    rng = np.random.default_rng(seed)
    topic_word = rng.dirichlet(np.full(vocab, beta), size=k_true).astype(np.float32)
    doc_topic = rng.dirichlet(np.full(k_true, alpha), size=n_docs).astype(np.float32)
    toks = np.empty((n_docs, doc_len), np.int32)
    for d in range(n_docs):
        z = rng.choice(k_true, size=doc_len, p=doc_topic[d])
        for j, zz in enumerate(z):
            toks[d, j] = rng.choice(vocab, p=topic_word[zz])
    return CorpusData(toks, n_docs, vocab, k_true)


def token_lm_stream(seed: int, vocab: int, seq_len: int, batch: int):
    """Infinite synthetic LM batches: order-1 Markov chain over the vocab with
    a sparse transition structure (so a transformer can beat unigram entropy).
    Yields (tokens[batch, seq_len+1]) — inputs/targets are shifted views."""
    rng = np.random.default_rng(seed)
    fan_out = 8
    nexts = rng.integers(0, vocab, (vocab, fan_out)).astype(np.int32)

    while True:
        state = rng.integers(0, vocab, batch).astype(np.int32)
        out = np.empty((batch, seq_len + 1), np.int32)
        out[:, 0] = state
        for t in range(1, seq_len + 1):
            pick = rng.integers(0, fan_out, batch)
            state = nexts[state, pick]
            out[:, t] = state
        yield out


def vae_data(seed: int = 0, dim: int = 784, n_train: int = 8192,
             n_test: int = 2048, latent: int = 8) -> ClassificationData:
    """Continuous data on a low-dim manifold (the VAE's natural habitat)."""
    rng = np.random.default_rng(seed)
    dec1 = rng.standard_normal((latent, 128)).astype(np.float32)
    dec2 = rng.standard_normal((128, dim)).astype(np.float32) / np.sqrt(128)

    def draw(n):
        z = rng.standard_normal((n, latent)).astype(np.float32)
        x = np.tanh(z @ dec1) @ dec2 + 0.05 * rng.standard_normal((n, dim)).astype(np.float32)
        return x.astype(np.float32), np.zeros(n, np.int32)

    xtr, ytr = draw(n_train)
    xte, yte = draw(n_test)
    return ClassificationData(xtr, ytr, xte, yte)
