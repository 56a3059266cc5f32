"""Device-resident feature store: the dataset's flat feature matrix lives in
device memory and a batch carries row indices only (the JAX package's
``data/feature_store.py``).

Learning-to-rank datasets are small beside a card's memory (WEB30K train:
2.1M documents x 136 features = 1.1 GB in fp32), while a [B, L, F] batch is
large beside the [B, L] int32 matrix of its rows. With the store the flat
[n_docs, F] matrix is uploaded once, and each batch of
``SlateBatcher(emit_row_indices=True)`` becomes features on the device by
one gather. Slate fixing is untouched: the host draws the same per-(seed,
epoch, slate) subsamples; only the feature rows stop travelling.

Enable with ``data.device_cache: true``. The port runs on one device, where
``data.device_cache_sharding: sharded`` is served replicated by the JAX
package's own downgrade rule (``effective_sharding``); the row-sharded
store and its collective gather are not yet ported.
"""

from __future__ import annotations

import torch

from allrank_tpu_torch.models.factory import as_dtype
from allrank_tpu_torch.utils.device import resolve_device


def table_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(table [rows, F], idx [B, L] int) -> features [B, L, F]: one
    ``index_select`` on the device."""
    rows = table.index_select(0, idx.reshape(-1).to(torch.int64))
    return rows.reshape(*idx.shape, table.shape[-1])


class DeviceFeatureStore:
    """A dataset's flat feature matrix plus one all-zero sentinel row for
    padded slots, uploaded to ``device`` (default: the GPU) once.

    ``table`` is the [n_docs + 1, F] tensor, in fp32 or in ``dtype``;
    ``sentinel`` (the document count) is the row that batchers put in
    padded slots; ``table_gather(table, idx)`` turns an index batch into
    features."""

    def __init__(self, dataset, device=None, dtype=None,
                 sharding: str = "replicated"):
        if sharding not in ("replicated", "sharded"):
            raise ValueError(
                f"device_cache_sharding must be 'replicated' or 'sharded', "
                f"got {sharding!r}")
        self.sharding = effective_sharding(sharding)
        flat_X = dataset.flat_slate_buffers()[0]
        table = torch.zeros((flat_X.shape[0] + 1, flat_X.shape[1]),
                            dtype=torch.float32)
        # one copy, which also reads a binary cache's read-only memory map
        table.numpy()[:-1] = flat_X
        if dtype is not None:
            # a bf16 store for bf16 runs: the tower casts its input to the
            # compute dtype first, and rounding commutes with the gather,
            # so what follows is bit for bit the fp32 store's
            table = table.to(as_dtype(
                "bfloat16" if str(dtype) == "bf16" else dtype))
        self.table = table.to(resolve_device(device))
        self.sentinel = int(flat_X.shape[0])


def effective_sharding(sharding: str, data_size: int = 1) -> str:
    """The store's one downgrade rule: "sharded" over a data axis of one
    device (the port's every run) is served replicated."""
    return ("sharded" if sharding == "sharded" and data_size > 1
            else "replicated")


def resolve_store_dtype(device_cache_dtype: str, compute_dtype: str):
    """The store dtype of ``data.device_cache_dtype``: "auto" follows the
    compute dtype (a bf16 table for bf16 runs), explicit values pass
    through, fp32 compute keeps an fp32 store (None)."""
    if device_cache_dtype and device_cache_dtype != "auto":
        return device_cache_dtype
    return "bfloat16" if str(compute_dtype) == "bfloat16" else None
