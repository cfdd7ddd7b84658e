"""Federated data partitioning: iid and label-skew non-iid (paper setup:
"each worker has training data only from a subset of all labels",
e.g. 3 of 10 classes). A NumPy copy of ``repro.fed.partition``."""
from __future__ import annotations

from typing import List

import numpy as np


def partition_iid(n: int, num_clients: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.RandomState(seed)
    idx = rng.permutation(n)
    return [np.sort(s) for s in np.array_split(idx, num_clients)]


def partition_label_skew(labels: np.ndarray, num_clients: int,
                         classes_per_client: int = 3,
                         seed: int = 0) -> List[np.ndarray]:
    """Each client sees only `classes_per_client` labels (non-iid S1).

    Client shards are pairwise DISJOINT and, for every class at least one
    client drew, they jointly COVER that class's whole pool: each client
    first draws its class subset, then every class's (shuffled) pool is
    dealt out contiguously across exactly the clients that drew it. A
    client's shard can only come up empty in the degenerate case where
    every one of its classes has fewer samples than clients sharing it
    (demand > supply).
    """
    rng = np.random.RandomState(seed)
    num_classes = int(labels.max()) + 1
    by_class = [np.where(labels == c)[0] for c in range(num_classes)]
    for c in by_class:
        rng.shuffle(c)
    # draw every client's class subset first so each class knows its takers
    choices = [rng.choice(num_classes, classes_per_client, replace=False)
               for _ in range(num_clients)]
    take: List[List[np.ndarray]] = [[] for _ in range(num_clients)]
    for c in range(num_classes):
        takers = [k for k in range(num_clients) if c in choices[k]]
        if not takers:
            continue  # nobody drew this class; its pool stays unused
        for k, shard in zip(takers, np.array_split(by_class[c], len(takers))):
            take[k].append(shard)
    empty = np.array([], dtype=np.int64)
    return [np.sort(np.concatenate(t)) if t else empty for t in take]
