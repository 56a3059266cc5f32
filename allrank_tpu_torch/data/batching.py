"""Fixed-shape slate batching and the host-to-device feed (the JAX package's
``data/batching.py``).

* Every batch has the same shape [B, L, F]: the trailing partial batch is
  padded with dummy slates marked False in ``slate_mask`` [B].
* Shuffling redraws each epoch from ``seed + epoch``. Batches are assembled
  by the C++ assembler (``data/native.py``, ``assembly="native"``, the
  default) on ``max(1, num_workers)`` threads: a slate longer than L is
  subsampled (or, at L, permuted) from a splitmix64 stream per (seed, epoch,
  slate), so a batch does not depend on which thread or position assembles
  it. The Python row loop stays as the plain version (``assembly=
  "python"``): the same padding, with numpy ``RandomState`` draws per
  (seed, epoch, slate), on a thread pool of ``num_workers`` when that is
  above 1. Same seed, epoch and assembly: the same arrays as the JAX
  package's batchers (whose default is its C++ assembler).
* ``DevicePrefetcher`` copies batch t+1 from pinned host memory on a side
  stream while the device computes on batch t.
* ``emit_row_indices=True`` yields index batches for the device feature
  store (``data/feature_store.py``): ``x`` is [B, L] int32 rows of the
  dataset's flat feature matrix, padded and dummy slots the store's zero
  sentinel row; the same batches as the JAX package's, bit for bit.

Not yet ported: ``local_rows`` (multi-host row ownership); asking for it
raises.
"""

from __future__ import annotations

import collections
import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from allrank_tpu_torch.constants import PADDED_Y_VALUE
from allrank_tpu_torch.data.native import assemble_rows_native
from allrank_tpu_torch.data.slate_fixing import fix_slate
from allrank_tpu_torch.utils.device import resolve_device

ASSEMBLIES = ("native", "python")


class SlateBatch(NamedTuple):
    x: np.ndarray  # [B, L, F] float32
    y: np.ndarray  # [B, L] float32, PADDED_Y_VALUE at padded docs
    indices: np.ndarray  # [B, L] int32, original ranks, -1 at pads
    slate_mask: np.ndarray  # [B] bool, False for batch-padding dummy slates


def _check_options(local_rows, assembly) -> None:
    if local_rows is not None:
        raise NotImplementedError(
            "local_rows is not yet ported to allrank_tpu_torch's batchers")
    if assembly not in ASSEMBLIES:
        raise ValueError(f"unknown assembly {assembly!r} (expected one of "
                         f"{ASSEMBLIES})")


class SlateBatcher:
    """Iterates fixed-shape batches over a SlateDataset.

    Shuffle and randomised subsampling redraw each epoch from
    ``seed + epoch``; call ``set_epoch`` before each pass (train role).
    ``assembly`` and ``num_workers`` choose the assembler and its threads,
    ``emit_row_indices`` index batches in place of features (the module
    docstring).
    """

    def __init__(self, dataset, slate_length: int, batch_size: int,
                 shuffle: bool = False, seed: int = 42,
                 local_rows: Optional[np.ndarray] = None,
                 num_workers: int = 0, emit_row_indices: bool = False,
                 assembly: str = "native"):
        _check_options(local_rows, assembly)
        self.dataset = dataset
        self.slate_length = int(slate_length)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.emit_row_indices = bool(emit_row_indices)
        self.num_workers = int(num_workers or 0)
        self.assembly = assembly

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _order(self) -> np.ndarray:
        """The epoch's slate permutation."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        return order

    def _slate_rng(self, ds_idx: int) -> np.random.RandomState:
        """Per-(seed, epoch, slate) stream of the Python row loop:
        subsampling is independent of which batch position assembles the
        slate."""
        s = (self.seed * 1000003 + self.epoch) * 1000003 + int(ds_idx)
        return np.random.RandomState(s % (2**31 - 1))

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _fill_row(self, bufs, row: int, ds_idx: int,
                  arange_L: np.ndarray) -> None:
        x, y, indices, slate_mask = bufs
        L = self.slate_length
        sx, sy = self.dataset[int(ds_idx)]
        n = len(sy)
        if n < L:
            # pad: straight into the batch buffers
            x[row, :n] = sx
            y[row, :n] = sy
            indices[row, :n] = arange_L[:n]
        else:
            # n >= L: random subsample or permutation with the relevance
            # guard (full-length slates are permuted too)
            fx, fy, fi = fix_slate(sx, sy, L, self._slate_rng(ds_idx))
            x[row], y[row], indices[row] = fx, fy, fi
        slate_mask[row] = True

    def _iter_row_indices(self) -> Iterator[SlateBatch]:
        """Index batches, derived from the materialising batches of either
        assembly: their ``indices`` record each slot's position within its
        slate, so ``slate_offset + indices`` is the slot's flat row, with
        the same slate-fixing draws; padded and dummy slots get the
        sentinel ``offsets[-1]``."""
        flat = getattr(self.dataset, "flat_slate_buffers", lambda: None)()
        if flat is None:
            raise ValueError("emit_row_indices requires flat slate buffers")
        _, _, offsets, index_map = flat
        sentinel = np.int64(offsets[-1])
        order = self._order()
        G = self.batch_size
        for start, batch in zip(range(0, len(order), G),
                                self._iter_materialized()):
            chunk = order[start:start + G]
            slates = chunk if index_map is None else index_map[chunk]
            row_off = np.zeros((G, 1), dtype=np.int64)
            row_off[:len(chunk), 0] = offsets[slates]
            xi = np.where(batch.indices >= 0, row_off + batch.indices,
                          sentinel).astype(np.int32)
            yield SlateBatch(xi, batch.y, batch.indices, batch.slate_mask)

    def __iter__(self) -> Iterator[SlateBatch]:
        if self.emit_row_indices:
            return self._iter_row_indices()
        return self._iter_materialized()

    def _iter_materialized(self) -> Iterator[SlateBatch]:
        order = self._order()
        G, L = self.batch_size, self.slate_length
        n_features = self.dataset.n_features
        arange_L = np.arange(L, dtype=np.int32)
        native = (self.dataset.flat_slate_buffers()
                  if self.assembly == "native" else None)
        pooled = native is None and self.num_workers > 1
        with (ThreadPoolExecutor(max_workers=self.num_workers) if pooled
              else contextlib.nullcontext()) as pool:
            for start in range(0, len(order), G):
                chunk = order[start:start + G]  # may be short
                x = np.zeros((G, L, n_features), dtype=np.float32)
                y = np.full((G, L), float(PADDED_Y_VALUE), dtype=np.float32)
                indices = np.full((G, L), PADDED_Y_VALUE, dtype=np.int32)
                slate_mask = np.zeros((G,), dtype=bool)
                bufs = (x, y, indices, slate_mask)
                todo = list(enumerate(chunk))
                if native is not None:
                    flat_X, flat_y, offsets, index_map = native
                    slates = (chunk.astype(np.int64) if index_map is None
                              else index_map[chunk])
                    # the stream is keyed by the dataset's own slate index
                    assemble_rows_native(
                        flat_X, flat_y, offsets,
                        np.arange(len(chunk), dtype=np.int64), slates, slates,
                        n_features, L, self.seed * 1000003 + self.epoch,
                        self.num_workers, x, y, indices, slate_mask)
                elif pool is not None and len(todo) > self.num_workers:
                    # one task a worker: a task a row drowns in the
                    # executor's own cost
                    def fill_span(span):
                        for row, ds_idx in span:
                            self._fill_row(bufs, row, ds_idx, arange_L)

                    size = -(-len(todo) // self.num_workers)
                    list(pool.map(fill_span, [todo[i:i + size] for i in
                                              range(0, len(todo), size)]))
                else:
                    for row, ds_idx in todo:
                        self._fill_row(bufs, row, ds_idx, arange_L)
                yield SlateBatch(x, y, indices, slate_mask)


class _SubsetDataset:
    """A view over selected slates of a SlateDataset."""

    def __init__(self, dataset, indices: np.ndarray):
        self.dataset = dataset
        self.indices = np.asarray(indices, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int):
        return self.dataset[int(self.indices[idx])]

    @property
    def n_features(self) -> int:
        return self.dataset.n_features

    def flat_slate_buffers(self):
        base = getattr(self.dataset, "flat_slate_buffers", lambda: None)()
        if base is None:
            return None
        X, y, offsets, index_map = base
        mapped = (self.indices if index_map is None
                  else index_map[self.indices])
        return X, y, offsets, mapped


class BucketedSlateBatcher:
    """Validation batcher with per-bucket padded slate lengths: slates are
    sorted by length and split into ``n_buckets`` groups of about equal
    count, and each group pads to its own maximum (rounded up to ``align``).
    Metrics do not depend on padding, so results match pad-to-longest while
    the O(L^2) losses run at smaller shapes."""

    def __init__(self, dataset, batch_size: int, n_buckets: int = 4,
                 local_rows: Optional[np.ndarray] = None,
                 num_workers: int = 0, align: int = 8,
                 emit_row_indices: bool = False, assembly: str = "native"):
        _check_options(local_rows, assembly)
        lengths = np.array([len(dataset[i][1]) for i in range(len(dataset))])
        order = np.argsort(lengths, kind="stable")
        self.buckets = []  # (bucket_length, slate indices)
        for group in np.array_split(order, max(1, int(n_buckets))):
            if len(group) == 0:
                continue
            length = -(-int(lengths[group].max()) // align) * align
            if self.buckets and self.buckets[-1][0] == length:
                prev_len, prev_idx = self.buckets[-1]
                self.buckets[-1] = (prev_len,
                                    np.concatenate([prev_idx, group]))
            else:
                self.buckets.append((length, group))
        self._batchers = [
            SlateBatcher(_SubsetDataset(dataset, idxs), length, batch_size,
                         shuffle=False, num_workers=num_workers,
                         emit_row_indices=emit_row_indices, assembly=assembly)
            for length, idxs in self.buckets]

    def set_epoch(self, epoch: int) -> None:
        for b in self._batchers:
            b.set_epoch(epoch)

    def __len__(self) -> int:
        return sum(len(b) for b in self._batchers)

    def __iter__(self) -> Iterator[SlateBatch]:
        for b in self._batchers:
            yield from b


class DevicePrefetcher:
    """Wraps a batch iterator, moving batches to ``device`` (default: the
    GPU) ahead of compute; yields ``SlateBatch``es of tensors.

    On a GPU each array goes through pinned host memory and a non-blocking
    copy on a side stream, ``depth`` batches in flight, so the copy of batch
    t+1 overlaps the compute on batch t; the consumer's stream waits for a
    batch's copy just before the batch is handed out. On the CPU the arrays
    are wrapped as tensors."""

    def __init__(self, batches, device=None, depth: int = 2):
        self.batches = batches
        self.device = resolve_device(device)
        self.depth = depth

    def __iter__(self):
        dev = self.device
        if dev.type == "cpu":
            for batch in self.batches:
                yield SlateBatch(*(torch.from_numpy(np.ascontiguousarray(a))
                                   for a in batch))
            return
        side = torch.cuda.Stream(device=dev)
        queue: collections.deque = collections.deque()

        def put(batch: SlateBatch):
            with torch.cuda.stream(side):
                moved = SlateBatch(*(
                    torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                    .to(dev, non_blocking=True) for a in batch))
                copied = torch.cuda.Event()
                copied.record(side)
            return moved, copied

        it = iter(self.batches)
        try:
            for _ in range(self.depth):
                queue.append(put(next(it)))
        except StopIteration:
            pass
        while queue:
            ready, copied = queue.popleft()
            try:
                queue.append(put(next(it)))
            except StopIteration:
                pass
            current = torch.cuda.current_stream(dev)
            current.wait_event(copied)
            for t in ready:
                t.record_stream(current)
            yield ready
