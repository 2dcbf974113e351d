"""Deterministic procedural image datasets (port of
``repro.data.synthetic``; numpy only, byte-identical to the JAX
package's for the same arguments).

  * ``digits28``  — 28×28×1, 10 classes  (MNIST / FashionMNIST stand-in)
  * ``tiles32``   — 32×32×3, 10 classes  (CIFAR-10 stand-in)

Each class is a smooth procedural template plus per-sample integer noise
and a random circular shift.  Everything returned is int32 in
[-127, 127] after the paper's MAD pre-processing (with train statistics).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core import preprocessing


class Dataset(NamedTuple):
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int
    input_shape: tuple[int, ...]


def _class_template(cls: int, h: int, w: int, c: int, rng: np.random.Generator) -> np.ndarray:
    """Low-frequency integer pattern unique to ``cls``."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    t = np.zeros((h, w, c))
    for ch in range(c):
        fx, fy = rng.uniform(0.5, 3.0, 2)
        px, py = rng.uniform(0, 2 * np.pi, 2)
        t[:, :, ch] = (
            np.sin(2 * np.pi * fx * xx / w + px) * np.cos(2 * np.pi * fy * yy / h + py)
        )
    amp = 50 + 7 * (cls % 5)
    return np.round(amp * t).astype(np.int64)


def make_image_dataset(
    name: str = "tiles32",
    n_train: int = 4096,
    n_test: int = 1024,
    num_classes: int = 10,
    noise: int = 45,
    seed: int = 0,
) -> Dataset:
    if name == "digits28":
        h, w, c = 28, 28, 1
    elif name == "tiles32":
        h, w, c = 32, 32, 3
    else:
        raise ValueError(f"unknown dataset {name!r}")
    rng = np.random.default_rng(seed)
    templates = np.stack(
        [_class_template(k, h, w, c, np.random.default_rng(1000 + k)) for k in range(num_classes)]
    )

    def gen(n: int, rng: np.random.Generator):
        y = rng.integers(0, num_classes, n)
        x = templates[y].copy()
        for i in range(n):  # random circular shift per sample
            sh, sw = rng.integers(-3, 4, 2)
            x[i] = np.roll(x[i], (sh, sw), axis=(0, 1))
        x = x + rng.integers(-noise, noise + 1, x.shape)
        return x, y.astype(np.int32)

    x_tr, y_tr = gen(n_train, rng)
    x_te, y_te = gen(n_test, rng)
    mu, omega = preprocessing.integer_statistics(x_tr)
    x_tr = preprocessing.normalize(x_tr, mu, omega).numpy()
    x_te = preprocessing.normalize(x_te, mu, omega).numpy()
    x_tr = np.clip(x_tr, -127, 127).astype(np.int32)
    x_te = np.clip(x_te, -127, 127).astype(np.int32)
    return Dataset(x_tr, y_tr, x_te, y_te, num_classes, (h, w, c))


def make_token_dataset(
    vocab_size: int, seq_len: int, n_seqs: int, seed: int = 0
) -> np.ndarray:
    """Zipf-distributed token ids, (n_seqs, seq_len) int32 (the LM
    substrate's corpus, numpy-identical to the JAX package's)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    return rng.choice(vocab_size, size=(n_seqs, seq_len), p=probs).astype(np.int32)


def batches(x: np.ndarray, y: np.ndarray, batch_size: int, seed: int = 0):
    """Shuffled full-epoch minibatch iterator (drops the ragged tail)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(x))
    for i in range(0, len(x) - batch_size + 1, batch_size):
        idx = order[i : i + batch_size]
        yield x[idx], y[idx]


def flatten_for_mlp(ds: Dataset) -> Dataset:
    """(N,H,W,C) → (N, H·W·C) for the MLP architectures."""
    d = 1
    for s in ds.input_shape:
        d *= s
    return Dataset(
        ds.x_train.reshape(len(ds.x_train), d),
        ds.y_train,
        ds.x_test.reshape(len(ds.x_test), d),
        ds.y_test,
        ds.num_classes,
        (d,),
    )
