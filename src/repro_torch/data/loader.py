"""Region-template-backed training data loader.

The data pipeline is a coarse-grain *stage* in the paper's sense: a
producer stages global batches into a storage backend (DMS by default) as
versioned data regions over the domain (step, batch, seq); the trainer
reads its ROI — on a multi-host pod each host would read only its batch
shard (the bounding-box read IS the sharding).  A prefetch thread keeps
``depth`` batches device-resident (paper S3.2.1 asynchronous copies).

A copy of ``repro.data.loader`` over the port's stores; batches go to
``runtime.prefetch.prefetch_to_device`` with an explicit ``device`` (``None``:
the CUDA card), where the reference passes a sharding.
"""
from __future__ import annotations

import threading
from typing import Iterator

import numpy as np

from repro_torch.core import BoundingBox, ElementType, RegionKey
from repro_torch.core.regions import StorageBackend
from repro_torch.runtime.prefetch import prefetch_to_device


class RegionTemplateLoader:
    """Producer/consumer batch exchange through a global storage backend."""

    def __init__(
        self,
        source,  # iterable of {"tokens","labels"} host batches
        storage: StorageBackend,
        *,
        namespace: str = "data",
        stage_ahead: int = 4,
        device_prefetch: int = 2,
        device=None,
    ) -> None:
        self.source = source
        self.storage = storage
        self.namespace = namespace
        self.stage_ahead = stage_ahead
        self.device_prefetch = device_prefetch
        self.device = device
        self._staged = threading.Semaphore(0)
        self._stop = False
        self._producer_error: BaseException | None = None
        self._n_staged = 0
        self._producer = threading.Thread(target=self._produce, daemon=True)
        self._producer.start()

    def _key(self, name: str, step: int) -> RegionKey:
        return RegionKey(self.namespace, name, ElementType.INT32, timestamp=step)

    def _produce(self) -> None:
        try:
            for step, batch in enumerate(self.source):
                while self._n_staged - getattr(self, "_consumed", 0) >= self.stage_ahead:
                    if self._stop:
                        return
                    threading.Event().wait(0.001)
                if self._stop:
                    return
                for name in ("tokens", "labels"):
                    arr = np.asarray(batch[name], np.int32)
                    bb = BoundingBox.from_shape(arr.shape, t_lo=step, t_hi=step + 1)
                    self.storage.put(self._key(name, step), bb, arr)
                self._n_staged += 1
                self._staged.release()
        except BaseException as e:  # noqa: BLE001
            self._producer_error = e
            self._staged.release()

    def _host_batches(self) -> Iterator[dict]:
        step = 0
        self._consumed = 0
        while True:
            self._staged.acquire()
            if self._producer_error is not None:
                raise RuntimeError("data producer failed") from self._producer_error
            tokens_key = self._key("tokens", step)
            # consumer reads its ROI (full batch on a single host)
            tok_entries = self.storage.query(self.namespace, "tokens")
            bb = next(b for k, b in tok_entries if k == tokens_key)
            batch = {
                "tokens": self.storage.get(tokens_key, bb),
                "labels": self.storage.get(self._key("labels", step), bb),
            }
            # retire consumed regions (paper: delete input-only regions)
            self.storage.delete(tokens_key)
            self.storage.delete(self._key("labels", step))
            self._consumed += 1
            yield batch
            step += 1

    def __iter__(self) -> Iterator[dict]:
        return prefetch_to_device(
            self._host_batches(), depth=self.device_prefetch, device=self.device
        )

    def close(self) -> None:
        self._stop = True
