"""Host-side input pipeline: fixed-capacity packing + threaded prefetch.

The port's own copy of ``tpu3dssf/data/pipeline.py``
(host code: the port imports nothing of the JAX package).

Replaces the reference's torch DataLoader + ragged ``fusion_collate_fn``
(utils/dataloader.py:165-242). Differences, by design:

  * points are packed into a *static* capacity ``point_capacity`` (pad
    with zeros / truncate) instead of per-batch max-length padding — XLA
    needs static shapes, and a single bucket avoids recompilation;
  * the collate mask keeps the reference's semantics: True where the slot
    holds a real point AND its label != 0 (dataloader.py:236-239 — the
    padding mask doubles as the not-noise mask);
  * batches are prefetched by a background thread into a bounded queue
    (the reference ships with num_workers=0 everywhere —
    nuscenesTestConfig22.yaml:37,43,49 — i.e. no overlap at all).

If the native C++ loader extension is built
(tpu3dssf_torch.data.native), the ``.bin``-file reading and label remap
run there; this module falls back to pure numpy transparently.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


def pack_sample(sample: Dict, point_capacity: int,
                ignore_index: int = 0) -> Dict:
    """Pad/truncate one sample's points to the static capacity."""
    if sample.get("packed"):
        # native loader already packed at capacity (data/native.py)
        assert sample["points"].shape[0] == point_capacity, (
            "native pack capacity mismatch: "
            f"{sample['points'].shape[0]} != {point_capacity}")
        packed = {k: sample[k] for k in
                  ("points", "labels", "point_valid", "mask",
                   "cam_intrinsics", "lidar2cam")}
        packed["num_points"] = np.int32(sample["num_points"])
        if "images" in sample:
            packed["images"] = sample["images"]
        return packed
    pts = sample["points"]
    labels = sample["labels"].reshape(-1)
    P = min(pts.shape[0], point_capacity)

    out_pts = np.zeros((point_capacity, pts.shape[1]), np.float32)
    out_lab = np.zeros((point_capacity,), np.int32)
    out_pts[:P] = pts[:P]
    out_lab[:P] = labels[:P]
    point_valid = np.zeros((point_capacity,), bool)
    point_valid[:P] = True
    mask = np.zeros((point_capacity,), bool)
    mask[:P] = out_lab[:P] != ignore_index

    packed = {
        "points": out_pts,
        "labels": out_lab,
        # point_valid: slot holds a real point (→ voxelization); the
        # reference voxelizes its zero padding too (lidar.py:45-61 on the
        # collate-padded tensor) — we exclude padding instead.
        "point_valid": point_valid,
        # mask: real AND not-noise (→ loss), reference dataloader.py:236-239
        "mask": mask,
        "num_points": np.int32(P),
        "cam_intrinsics": sample["cam_intrinsics"].astype(np.float32),
        "lidar2cam": sample["lidar2cam"].astype(np.float32),
    }
    if "images" in sample:
        packed["images"] = sample["images"]
    return packed


class HostDataPipeline:
    """Shuffling, batching, prefetching iterator over a dataset.

    ``dataset`` is any index-addressable object returning the sample dict
    contract (see tpu3dssf_torch.data.synthetic).
    """

    def __init__(self, dataset, batch_size: int, point_capacity: int,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = True, prefetch: int = 2,
                 ignore_index: int = 0, num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.point_capacity = point_capacity
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.ignore_index = ignore_index
        # >1: samples within a batch load in a thread pool (the C++
        # loader and numpy IO release the GIL, so threads overlap IO)
        self.num_workers = max(0, num_workers)
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batch_indices(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        end = (n // self.batch_size) * self.batch_size if self.drop_last \
            else n
        for start in range(0, end, self.batch_size):
            yield idx[start:start + self.batch_size]

    def _make_batch(self, indices) -> Dict[str, np.ndarray]:
        def load(i):
            return pack_sample(self.dataset[int(i)],
                               self.point_capacity, self.ignore_index)

        if self.num_workers > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(self.num_workers) as pool:
                packed = list(pool.map(load, indices))
        else:
            packed = [load(i) for i in indices]
        return {
            k: np.stack([p[k] for p in packed]) for k in packed[0]
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self._epoch += 1
        q: "queue.Queue[Optional[Dict]]" = queue.Queue(
            maxsize=self.prefetch)
        err = []
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that gives up when the consumer is gone — a
            # plain q.put would block forever if the iterator is
            # abandoned mid-epoch (break / exception / islice) with the
            # queue full, leaking the producer thread and its batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                for indices in self._batch_indices():
                    if not put(self._make_batch(indices)):
                        return
            except Exception as e:  # surface worker errors to the consumer
                err.append(e)
            finally:
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
        finally:
            stop.set()           # unblock a producer stuck in put()
            t.join(timeout=5.0)
        if err:
            raise err[0]
