"""Deterministic synthetic surrogates for the paper's datasets (a copy of
`repro/data/synthetic.py`: the same name and seed give the same arrays,
bit for bit).

The paper evaluates on cpusmall, cadata (regression, LIBSVM), ijcnn1
(binary classification, LIBSVM) and USPS (10-class digits). This container
is offline, so we generate seeded surrogates with the same dimensionality,
sample counts and task type; EXPERIMENTS.md reports results as surrogate
reproductions validating the paper's *relative orderings* (API-BCD vs
I-BCD vs WPG on time/communication), not absolute NMSE values.

Generators are fully deterministic given (name, seed).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.losses import Problem


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    kind: str           # 'lsq' | 'logistic' | 'softmax'
    num_samples: int
    num_features: int
    num_classes: int = 2
    noise: float = 0.1
    condition: float = 8.0    # singular-value spread of the design
                              # matrix (H condition ~64, typical for
                              # standardized tabular data like cpusmall)


DATASETS: Dict[str, DatasetSpec] = {
    # regression (paper Figs. 3-4)
    "cpusmall": DatasetSpec("cpusmall", "lsq", 8192, 12, noise=0.15),
    "cadata": DatasetSpec("cadata", "lsq", 20640, 8, noise=0.25),
    # classification (paper Figs. 5-6)
    "ijcnn1": DatasetSpec("ijcnn1", "logistic", 49990, 22),
    "usps": DatasetSpec("usps", "softmax", 7291, 256, num_classes=10),
}


def _design_matrix(rng, n, p, condition):
    """Correlated features with controlled conditioning (realistic tabular).

    Columns are standardized (zero mean, unit variance) like preprocessed
    LIBSVM data, so the Gram matrix A^T A / n has trace p with a decaying
    eigenspectrum of condition ~``condition``^2.
    """
    a = rng.standard_normal((n, p))
    # impose decaying singular-value spectrum
    u, _, vt = np.linalg.svd(a, full_matrices=False)
    s = np.logspace(0, -np.log10(condition), p)
    a = (u * s) @ vt
    a = (a - a.mean(axis=0)) / a.std(axis=0)
    return a


def surrogate_dataset(name: str, seed: int = 0,
                      subsample: int | None = None
                      ) -> Tuple[np.ndarray, np.ndarray, DatasetSpec]:
    """Returns (features [n, p], targets [n], spec)."""
    spec = DATASETS[name]
    # stable across processes (builtin hash() is PYTHONHASHSEED-salted)
    name_seed = int.from_bytes(name.encode()[:4].ljust(4, b"\0"), "little")
    rng = np.random.default_rng(name_seed + seed)
    n = spec.num_samples if subsample is None else min(subsample,
                                                       spec.num_samples)
    a = _design_matrix(rng, n, spec.num_features, spec.condition)

    if spec.kind == "lsq":
        x_true = rng.standard_normal(spec.num_features)
        b = a @ x_true + spec.noise * rng.standard_normal(n)
        # standardize targets as LIBSVM users commonly do
        b = (b - b.mean()) / b.std()
        return a, b, spec

    if spec.kind == "logistic":
        x_true = rng.standard_normal(spec.num_features)
        # margin scale 3 keeps label noise moderate (Bayes acc ~0.9),
        # so accuracy curves have headroom like the real ijcnn1
        logits = 3.0 * (a @ x_true) / np.std(a @ x_true)
        prob = 1.0 / (1.0 + np.exp(-logits))
        y = np.where(rng.uniform(size=n) < prob, 1.0, -1.0)
        return a, y, spec

    if spec.kind == "softmax":
        # Gaussian-mixture surrogate (digit-like): one mean per class,
        # within-class spread sized for ~96% linear separability like USPS
        # (hard enough that the convergence dynamics are visible).
        means = rng.standard_normal((spec.num_classes, spec.num_features))
        means *= 0.3 / np.sqrt(spec.num_features)
        y = rng.integers(spec.num_classes, size=n).astype(np.int32)
        a = means[y] + rng.standard_normal((n, spec.num_features)) / np.sqrt(
            spec.num_features)
        return a, y, spec

    raise ValueError(spec.kind)


def make_problem(name: str, num_agents: int, seed: int = 0,
                 test_fraction: float = 0.2,
                 subsample: int | None = None) -> Problem:
    """Build a decentralized Problem: shard the train split over N agents.

    Data are distributed contiguously (non-iid-ish ordering is avoided by a
    global shuffle first — the paper assumes a benign split).
    """
    a, b, spec = surrogate_dataset(name, seed=seed, subsample=subsample)
    rng = np.random.default_rng(seed + 1)
    perm = rng.permutation(len(a))
    a, b = a[perm], b[perm]

    n_test = int(len(a) * test_fraction)
    a_test, b_test = a[:n_test], b[:n_test]
    a_train, b_train = a[n_test:], b[n_test:]

    shards_a = np.array_split(a_train, num_agents)
    shards_b = np.array_split(b_train, num_agents)

    dim = spec.num_features
    if spec.kind == "softmax":
        dim = spec.num_features * spec.num_classes

    return Problem(
        kind=spec.kind,
        features=tuple(shards_a),
        targets=tuple(shards_b),
        dim=dim,
        num_classes=spec.num_classes,
        test_features=a_test,
        test_targets=b_test,
    )
