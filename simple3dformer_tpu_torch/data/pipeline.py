"""Device-resident datasets (port of DeviceResidentDataset from
simple3dformer_tpu/data/pipeline.py).

The voxel corpora are small next to the card's memory (ModelNet40: 12k x 30^3
uint8, about 332 MB), so a whole split goes to the device once and each
batch is an on-device gather by an index tensor. Per step the host sends
nothing; an epoch's index matrix goes over once.

Under data parallelism every rank holds the whole split on its own card, as
the JAX package replicates the corpus over the mesh, and ``gather`` takes the
rank's columns of each row of the index matrix (parallel/mesh.rank_columns,
applied by the train and eval runners).

``host_batches`` and ``collate`` are the host-side batching of a
__getitem__ / __len__ dataset, for corpora that do not fit on the card.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch


class DeviceResidentDataset:
    """Named arrays held on ``device`` as [n, prod(rest)] rows; batches by gather."""

    def __init__(self, arrays: dict[str, np.ndarray], device="cuda"):
        self.device = torch.device(device)
        self.n = len(next(iter(arrays.values())))
        self.shapes: dict[str, tuple] = {}
        self.arrays: dict[str, torch.Tensor] = {}
        for k, v in arrays.items():
            if len(v) != self.n:
                raise ValueError(f"array {k!r} length {len(v)} != {self.n}")
            v = np.ascontiguousarray(v)
            self.shapes[k] = v.shape[1:]
            flat = v.reshape(self.n, -1) if v.ndim > 1 else v
            self.arrays[k] = torch.from_numpy(flat).to(self.device)

    def __len__(self):
        return self.n

    def gather(self, idx: torch.Tensor) -> dict[str, torch.Tensor]:
        """idx [B] (or [S, B]) on the device -> batch dict, arrays in their own dtypes."""
        flat = idx.reshape(-1)
        return {k: v.index_select(0, flat).reshape(*idx.shape, *self.shapes[k])
                for k, v in self.arrays.items()}

    def put_indices(self, idx: np.ndarray) -> torch.Tensor:
        """An index matrix on the device, sent once."""
        return torch.from_numpy(np.asarray(idx, np.int64)).to(self.device)

    def epoch_indices(self, batch_size: int, rng: np.random.RandomState, shuffle: bool = True,
                      drop_last: bool = True) -> np.ndarray:
        """[num_batches, batch_size] int32 index matrix for one epoch."""
        order = rng.permutation(self.n) if shuffle else np.arange(self.n)
        if drop_last:
            nb = self.n // batch_size
            order = order[: nb * batch_size]
        else:
            pad = (-len(order)) % batch_size
            order = np.concatenate([order, order[:pad]])
        return order.reshape(-1, batch_size).astype(np.int32)


def host_batches(
    dataset, batch_size: int, rng: np.random.RandomState | None = None,
    shuffle: bool = True, drop_last: bool = False,
) -> Iterator[list]:
    """Simple host-side batch iterator over a __getitem__/__len__ dataset."""
    n = len(dataset)
    order = rng.permutation(n) if (shuffle and rng is not None) else np.arange(n)
    for start in range(0, n, batch_size):
        idx = order[start : start + batch_size]
        if drop_last and len(idx) < batch_size:
            return
        yield [dataset[int(i)] for i in idx]


def collate(samples: list, keys: tuple[str, ...] | None = None):
    """Stack a list of dict or tuple samples into batched numpy arrays."""
    if isinstance(samples[0], dict):
        keys = keys or tuple(samples[0].keys())
        return {k: np.stack([s[k] for s in samples]) for k in keys}
    n_fields = len(samples[0])
    return tuple(np.stack([s[i] for s in samples]) for i in range(n_fields))
