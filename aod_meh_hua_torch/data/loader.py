"""Batch loaders: host-side assembly of fixed-shape batches.

Port of aod_meh_hua_tpu/data/loader.py:41-343, the RetinaNet path
(`_shared_pool`, `_Prefetcher`, `_pad_gt`, `TrainLoader`, `EvalLoader`)
and Fast R-CNN's proposals (`transform_proposals` :91-104,
`_pad_proposals` :107-115, the TrainLoader's `proposal_source`),
which replaces the reference's DataLoader + GroupSampler + collate stack
(mmdet/datasets/builder.py:76-147, samplers/group_sampler.py):

* Batches are orientation-homogeneous: two static canvases (landscape /
  portrait), each batch tagged with its orientation.
* TrainLoader: a seeded shuffle of whole same-orientation batches, the
  dataset-repeat multiplier, GT padded to max_gt, per-image anchor
  validity from the /32 pad extent, for the anchors of the config's
  family (RetinaNet's, SSD's, or Faster R-CNN's RPN anchors). The RNG stream, the batch order and
  the per-sample seeds are the JAX package's, so the same seed gives the
  same batches, bit for bit (tests/test_torch_data.py).
* Across ranks (parallel/), a TrainLoader gives each rank its block of
  rows of the global batch (`rows`): every rank draws the whole batch's
  order, flips and per-sample seeds, and decodes only its own images.
* With a `proposal_source` (Fast R-CNN) the TrainLoader yields
  engine/rpn_only.py ProposalBatch: each image's original-coordinate
  proposals through its own resize, clip and flip, padded into the
  config's num_proposals slots.
* EvalLoader: a sequential sweep per orientation group; the tail batch is
  padded to full size and flagged invalid; batches carry their source
  indices. A rank sweeps its parallel.rank_indices slice.
* Both prefetch on a background thread, and decode on a shared thread
  pool.

Batches hold numpy arrays; the steps upload them. The options of other
families raise NotImplementedError with their ROADMAP item.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence, Tuple

import numpy as np

from ..engine.batch import Batch, EvalBatch
from ..ops.anchors import anchor_valid_flags
from .pipeline import PipelineConfig, load_image, prepare_sample

ORIENTATIONS = ("landscape", "portrait")

_SHARED_POOL = None


def _shared_pool(num_workers: int):
    """One process-wide decode pool: loaders are created per AL cycle and
    a per-instance executor would leak threads across cycles."""
    global _SHARED_POOL
    if _SHARED_POOL is None:
        _SHARED_POOL = ThreadPoolExecutor(max(num_workers, 1))
    return _SHARED_POOL


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


class _Prefetcher:
    """Run a batch-producing generator on a background thread."""

    def __init__(self, gen_fn, depth: int = 3):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._worker, args=(gen_fn,), daemon=True)
        self._thread.start()

    def _worker(self, gen_fn):
        try:
            for item in gen_fn():
                self._q.put(item)
        except BaseException as e:  # propagate into the consumer
            self._q.put(e)
        self._q.put(StopIteration)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is StopIteration:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item


def _pad_gt(samples, max_gt):
    b = len(samples)
    boxes = np.zeros((b, max_gt, 4), np.float32)
    labels = np.zeros((b, max_gt), np.int32)
    valid = np.zeros((b, max_gt), bool)
    for i, s in enumerate(samples):
        n = min(len(s["gt_labels"]), max_gt)
        boxes[i, :n] = s["gt_bboxes"][:n]
        labels[i, :n] = s["gt_labels"][:n]
        valid[i, :n] = True
    return boxes, labels, valid


def transform_proposals(props: np.ndarray, sample: dict) -> np.ndarray:
    """Original-coordinate proposals [P, 4] through the sample's geometry,
    the scale, clip and flip prepare_sample applies to its gt boxes (the
    reference transforms loaded proposals with the bboxes,
    datasets/pipelines/transforms.py Resize and RandomFlip)."""
    props = np.asarray(props, np.float32).reshape(-1, 4) * sample["scale_factor"]
    new_h, new_w = int(sample["img_shape"][0]), int(sample["img_shape"][1])
    props[:, 0::2] = np.clip(props[:, 0::2], 0, new_w)
    props[:, 1::2] = np.clip(props[:, 1::2], 0, new_h)
    if sample["flipped"]:
        x1 = props[:, 0].copy()
        props[:, 0] = new_w - props[:, 2]
        props[:, 2] = new_w - x1
    return props


def _pad_proposals(prop_list, num_slots: int):
    """Per-image proposals -> ([B, num_slots, 4], valid [B, num_slots]),
    the first num_slots of each."""
    b = len(prop_list)
    out = np.zeros((b, num_slots, 4), np.float32)
    valid = np.zeros((b, num_slots), bool)
    for i, p in enumerate(prop_list):
        n = min(len(p), num_slots)
        out[i, :n] = p[:n]
        valid[i, :n] = True
    return out, valid


def _orientation_of(dataset, idx: int) -> str:
    return "landscape" if dataset.aspect_flag(int(idx)) else "portrait"


class TrainLoader:
    """Yields (orientation, Batch) pairs."""

    def __init__(
        self,
        dataset,
        indices: Sequence[int],
        model_cfg,
        pipeline: PipelineConfig,
        batch_size: int,
        repeat: int = 1,
        seed: int = 20,
        prefetch: bool = True,
        augment_fn=None,
        num_workers: int = 4,
        with_masks: bool = False,
        proposal_source=None,
        rows: Tuple[int, int] = (0, 1),
    ):
        """num_workers: decode/resize thread pool size (the host analog of
        the reference's worker processes, datasets/builder.py:104-147).
        rows=(index, count): yield the index-th of `count` equal blocks of
        each global batch's rows (parallel.data_sharding), decoding only
        those images; batch_size stays the global batch.
        augment_fn(img, ann, rng) -> (img, ann) runs before prepare_sample
        with the sample's own RandomState (the SSD augment chain,
        data/ssd_augment.py). proposal_source: callable(dataset index) ->
        [P, 4] float32 proposals in original-image coordinates (the
        reference's proposal_file, datasets/custom.py:181); the loader then
        yields engine/rpn_only.py ProposalBatch, the proposals through the
        sample's resize, clip and flip (transform_proposals), in
        model_cfg.num_proposals slots (Fast R-CNN). with_masks (Mask R-CNN)
        belongs to a family the port does not have yet and raises."""
        if with_masks:
            _not_ported("with_masks (the Mask R-CNN family)", "15.4")
        self.dataset = dataset
        self.indices = np.asarray(indices)
        self.cfg = model_cfg
        self.pipeline = pipeline
        self.batch_size = batch_size
        self.repeat = repeat
        self.rng = np.random.RandomState(seed)
        index, count = rows
        if batch_size % count or not 0 <= index < count:
            raise ValueError(f"rows {rows}: the global batch {batch_size} splits into "
                             f"{count} equal blocks, index below {count}")
        per = batch_size // count
        self.rows = range(index * per, (index + 1) * per)
        self.prefetch = prefetch
        self.augment_fn = augment_fn
        self.proposal_source = proposal_source
        self.num_workers = num_workers
        self._pool = _shared_pool(num_workers) if num_workers > 0 else None
        self._gen = model_cfg.build_anchor_generator()

    def __len__(self):
        n = 0
        for o in ORIENTATIONS:
            k = sum(1 for i in np.repeat(self.indices, self.repeat)
                    if _orientation_of(self.dataset, i) == o)
            n += (k + self.batch_size - 1) // self.batch_size if k else 0
        return n

    def _epoch_batches(self):
        idx = np.repeat(self.indices, self.repeat)
        groups = {o: [] for o in ORIENTATIONS}
        for i in idx:
            groups[_orientation_of(self.dataset, i)].append(i)
        batches = []
        for o, grp in groups.items():
            grp = np.asarray(grp)
            self.rng.shuffle(grp)
            for i in range(0, len(grp), self.batch_size):
                batches.append((o, grp[i:i + self.batch_size]))
        order = self.rng.permutation(len(batches))
        return [batches[i] for i in order]

    def _make_batch(self, orientation: str, batch_idx: np.ndarray) -> Batch:
        # deterministic per-sample seeds drawn in order, then parallel prep;
        # every rank draws the whole batch's seeds, so the stream, and so
        # the global batch, is the single-process one on each rank
        seeds = [int(self.rng.randint(0, 2 ** 31 - 1)) for _ in batch_idx]

        def prep(i, seed):
            r = np.random.RandomState(seed)
            img = load_image(self.dataset.img_path(int(i)))
            ann = self.dataset.get_ann_info(int(i))
            if self.augment_fn is not None:
                img, ann = self.augment_fn(img, ann, r)
            sample = prepare_sample(img, ann, self.pipeline, rng=r)
            if self.proposal_source is not None:
                sample["proposals"] = transform_proposals(self.proposal_source(int(i)), sample)
            return sample

        # a short tail repeats its samples to keep the shape: global row r
        # is sample r % len(batch_idx); this rank decodes its rows' samples
        src = [r % len(batch_idx) for r in self.rows]
        need = sorted(set(src))
        if self._pool is not None:
            done = list(self._pool.map(prep, batch_idx[need], [seeds[k] for k in need]))
        else:
            done = [prep(batch_idx[k], seeds[k]) for k in need]
        by_sample = dict(zip(need, done))
        samples = [by_sample[k] for k in src]
        images = np.stack([s["image"] for s in samples])
        boxes, labels, valid = _pad_gt(samples, self.cfg.max_gt)
        pad_shapes = np.stack([s["pad_shape"] for s in samples])
        sizes = self.cfg.for_orientation(orientation).featmap_sizes()
        av = anchor_valid_flags(self._gen, sizes, pad_shapes)
        shapes = np.stack([s["img_shape"] for s in samples])
        if self.proposal_source is not None:
            from ..engine.rpn_only import ProposalBatch

            props, pvalid = _pad_proposals([s["proposals"] for s in samples],
                                           self.cfg.num_proposals)
            return ProposalBatch(images, boxes, labels, valid, shapes, props, pvalid)
        return Batch(images, boxes, labels, valid, av, shapes)

    def burn_epochs(self, n: int) -> None:
        """Consume exactly n epochs of RNG draws without decoding any
        image: replays the shuffle + per-sample seed stream so a
        mid-cycle resume sees the identical remaining batch sequence."""
        for _ in range(n):
            for _, bi in self._epoch_batches():
                for _ in bi:
                    self.rng.randint(0, 2 ** 31 - 1)

    def __iter__(self) -> Iterator[Tuple[str, Batch]]:
        plan = self._epoch_batches()

        def gen():
            for o, bi in plan:
                yield o, self._make_batch(o, bi)

        return iter(_Prefetcher(gen)) if self.prefetch else gen()


class EvalLoader:
    """Yields (orientation, EvalBatch, indices) triples, grouped by
    orientation; `indices` maps each row back to the source index."""

    def __init__(
        self,
        dataset,
        indices: Sequence[int],
        pipeline: PipelineConfig,
        batch_size: int,
        prefetch: bool = True,
        num_workers: int = 8,
        transform_fn=None,
        cache=None,
    ):
        """cache: a data/canvas_cache.py CanvasCache — decoded canvases are
        read from / written to it, so repeat sweeps of the same immutable
        pool (every AL cycle) skip the JPEG decode. transform_fn (the
        robustness corruptions of tools/analysis) is not ported yet and
        raises."""
        if transform_fn is not None:
            _not_ported("transform_fn (the robustness corruptions)", "13")
        self.dataset = dataset
        self.indices = np.asarray(indices)
        self.pipeline = pipeline
        self.batch_size = batch_size
        self.prefetch = prefetch
        self.cache = cache
        self._pool = _shared_pool(num_workers) if num_workers > 0 else None

    def __len__(self):
        n = 0
        for o in ORIENTATIONS:
            k = sum(1 for i in self.indices if _orientation_of(self.dataset, i) == o)
            n += (k + self.batch_size - 1) // self.batch_size if k else 0
        return n

    def _make_batch(self, batch_idx: np.ndarray) -> EvalBatch:
        def prep(i):
            i = int(i)
            if self.cache is not None:
                s = self.cache.get(i)
                if s is not None:
                    return s
            img = load_image(self.dataset.img_path(i))
            s = prepare_sample(img, None, self.pipeline, flip=False)
            if self.cache is not None:
                self.cache.put(i, s)
            return s

        if self._pool is not None:
            samples = list(self._pool.map(prep, batch_idx))
        else:
            samples = [prep(i) for i in batch_idx]
        valid = [True] * len(samples)
        while len(samples) < self.batch_size:
            samples.append(samples[-1])
            valid.append(False)
        return EvalBatch(
            np.stack([s["image"] for s in samples]),
            np.stack([s["img_shape"] for s in samples]),
            np.stack([s["scale_factor"] for s in samples]),
            np.asarray(valid),
        )

    def __iter__(self):
        groups = {o: [] for o in ORIENTATIONS}
        for i in self.indices:
            groups[_orientation_of(self.dataset, i)].append(int(i))

        def gen():
            for o in ORIENTATIONS:
                grp = np.asarray(groups[o], dtype=np.int64)
                for i in range(0, len(grp), self.batch_size):
                    bi = grp[i:i + self.batch_size]
                    yield o, self._make_batch(bi), bi

        return iter(_Prefetcher(gen)) if self.prefetch else gen()
