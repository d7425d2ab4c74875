"""Host-side training/eval pipelines and the training loader, the
counterpart of ``glsdet_tpu.data.loader``.

Behavioral reference: the YOLOX train pipeline
(configs/yolox/yolox_s_8x8_300e_coco.py:28-52: Mosaic -> RandomAffine ->
MixUp -> YOLOXHSVRandomAug -> RandomFlip -> Resize -> Pad) wrapped by
``MultiImageMixDataset``, and ``build_dataloader``
(mmdet/datasets/builder.py:86: worker seeding, group sampling).

``TrainPipeline``, ``EvalPipeline``, the samplers and ``eval_loader``
are the JAX package's, carried over.  ``train_loader`` keeps its stream
and moves its work into worker processes: the main process draws each
epoch's schedule and every sample's seed from the master
``RandomState(seed)`` exactly as the JAX package's producer thread
does, and a ``torch.utils.data.DataLoader`` hands ``(index, seed)``
pairs to its workers (``spawn``ed processes), which build the samples
off the interpreter lock that the training thread needs.  The same seed
gives the same batches as the JAX package: boxes, labels and ``*_valid``
bit for bit, images wherever the port's image ops equal OpenCV's
(``tests/test_torch_loader.py``).
"""

from __future__ import annotations

import atexit
import os
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from glsdet_tpu_torch.data.augment import (
    affine_boxes,
    hsv_aug,
    letterbox,
    mixup,
    mosaic4,
    mosaic4_boxes,
    mosaic4_params,
    random_affine,
    random_affine_params,
    random_flip,
    sample_hsv_deltas,
)
from glsdet_tpu_torch.data.coco import (CocoDataset, make_batch, normalize,
                                        pad_gts)
from glsdet_tpu_torch.data.device_geom import (flip_affine,
                                               inverse_affine_2x3,
                                               quads_to_array)


class TrainPipeline:
    """Mosaic+affine+mixup+hsv+flip -> fixed (H, W) + padded GTs."""

    def __init__(self, dataset: CocoDataset, img_hw: Tuple[int, int],
                 max_gt: int = 300, mosaic: bool = True,
                 enable_mixup: bool = True, hsv: bool = True,
                 flip_prob: float = 0.5, raw_uint8: bool = False,
                 device_color: bool = False, device_geom: bool = False,
                 geom_src_hw: Optional[Tuple[int, int]] = None):
        self.ds = dataset
        self.img_hw = img_hw
        self.max_gt = max_gt
        self.mosaic = mosaic
        self.mixup = enable_mixup
        self.hsv = hsv
        self.flip_prob = flip_prob
        # raw_uint8: skip host-side normalize; the train step normalizes
        # on device (4x smaller host->device transfer)
        self.raw_uint8 = raw_uint8
        # device_color: move the COLOR stage (mixup pixel blend + HSV
        # jitter) on device too: the host samples the parameters and
        # does the exact box geometry, the train step renders the pixels
        # (data/device_color.py).  Implies raw uint8 images; batches gain
        # mix_images/mix_weight/hsv_deltas keys.
        self.device_color = device_color
        # device_geom: ALSO move the geometric stage (mosaic paint +
        # affine warp) on device as a fused gather-warp
        # (data/device_geom.py).  Host keeps parameter sampling + exact
        # box math; batches gain geom_sources/geom_quads/geom_mat and
        # drop "images" while mosaic is active.  Opt-in: it enlarges
        # host->device transfer (raw sources vs the final canvas).
        self.device_geom = device_geom
        if device_geom and not device_color:
            raise ValueError("device_geom requires device_color")
        # static padded source size for geom batches; images must fit
        self.geom_src_hw = geom_src_hw

    def disable_aug(self):
        """YOLOXModeSwitchHook analog: last-15-epochs plain pipeline."""
        self.mosaic = False
        self.mixup = False

    def _load(self, idx: int):
        rec = self.ds.records[idx]
        img = self.ds.load_image(rec)
        return img, rec.boxes.copy(), rec.labels.copy()

    def __call__(self, idx: int, rng: np.random.RandomState) -> dict:
        n = len(self.ds)
        mix_img = None              # device_color: deferred pixel blend
        geom = None                 # device_geom: deferred pixel warp
        if self.mosaic:
            idxs = [idx] + [rng.randint(n) for _ in range(3)]
            imgs, bxs, lbs = zip(*[self._load(i) for i in idxs])
            if self.device_geom:
                # SAME rng draws and box math as the host path below —
                # only the pixel rendering is deferred to the device
                shapes = [im.shape[:2] for im in imgs]
                _cx, _cy, quads = mosaic4_params(shapes, self.img_hw, rng)
                boxes, labels = mosaic4_boxes(quads, bxs, lbs, self.img_hw)
                h2, w2 = self.img_hw[0] * 2, self.img_hw[1] * 2
                mat = random_affine_params(rng, (h2, w2), self.img_hw)
                boxes, labels = affine_boxes(mat, boxes, labels,
                                             self.img_hw)
                geom = [list(imgs), quads, mat]
                img = None
            else:
                img, boxes, labels = mosaic4(
                    imgs, bxs, lbs, self.img_hw, rng)
                img, boxes, labels = random_affine(
                    img, boxes, labels, rng, self.img_hw)
            if self.mixup and rng.rand() < 0.5 and len(self.ds) > 1:
                img2, b2, l2 = self._load(rng.randint(n))
                img2, b2, _, _ = letterbox(img2, b2, self.img_hw)
                if self.device_color:
                    # GT concat is mixup()'s box half; pixels blend in
                    # the train step (device_color.apply_color)
                    mix_img = img2
                    boxes = (np.concatenate([boxes, b2])
                             if len(b2) else boxes)
                    labels = (np.concatenate([labels, l2])
                              if len(l2) else labels)
                else:
                    img, boxes, labels = mixup(
                        img, boxes, labels, img2, b2, l2, rng)
        else:
            img, boxes, labels = self._load(idx)
            img, boxes, _, _ = letterbox(img, boxes, self.img_hw)
        hsv_deltas = np.zeros((3,), np.float32)
        if self.hsv:
            if self.device_color:
                # identical rng stream to hsv_aug (shared sampling
                # helper); the conversion happens on device
                hsv_deltas = sample_hsv_deltas(rng)
            else:
                img = hsv_aug(img, rng)
        if self.device_color:
            # flip commutes with the per-pixel color stage: flip both
            # blend inputs here, blend+jitter on device
            do_flip = rng.rand() < self.flip_prob
            if do_flip:
                w = self.img_hw[1]
                if geom is not None:
                    # fold the output flip into the affine matrix
                    geom[2] = flip_affine(geom[2], w)
                else:
                    img = img[:, ::-1]
                if len(boxes):
                    boxes = boxes.copy()
                    boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
                if mix_img is not None:
                    mix_img = mix_img[:, ::-1]
        else:
            img, boxes = random_flip(img, boxes, rng, self.flip_prob)
        gt_boxes, gt_labels, gt_valid = pad_gts(boxes, labels, self.max_gt)
        sample = {
            "gt_boxes": gt_boxes,
            "gt_labels": gt_labels,
            "gt_valid": gt_valid,
        }
        if geom is not None:
            imgs4, quads, mat = geom
            hs, ws = self.geom_src_hw or (
                max(im.shape[0] for im in imgs4),
                max(im.shape[1] for im in imgs4))
            srcs = np.zeros((4, hs, ws, 3), np.uint8)
            for i, im in enumerate(imgs4):
                if im.shape[0] > hs or im.shape[1] > ws:
                    raise ValueError(
                        f"geom_src_hw {(hs, ws)} too small for source "
                        f"{im.shape[:2]} — raise TrainPipeline geom_src_hw")
                srcs[i, :im.shape[0], :im.shape[1]] = im
            sample["geom_sources"] = srcs
            sample["geom_quads"] = quads_to_array(
                quads, [im.shape[:2] for im in imgs4])
            sample["geom_mat"] = inverse_affine_2x3(mat)
        else:
            sample["images"] = (
                np.ascontiguousarray(img, np.uint8)
                if (self.raw_uint8 or self.device_color)
                else normalize(img))
        if self.device_color:
            # Keys are emitted ONLY for stages that are statically
            # enabled: a mixup-off pipeline (e.g. after disable_aug)
            # stops shipping the zero (H, W, 3) mix canvas that would
            # double upload bytes, and an hsv=False pipeline skips the
            # device HSV round-trip entirely (uint8 HSV quantization is
            # NOT a no-op at zero deltas) — key presence picks the
            # compiled program in device_color.prep_batch_images.
            if self.mosaic and self.mixup:
                h, w = self.img_hw
                if mix_img is None:
                    sample["mix_images"] = np.zeros((h, w, 3), np.uint8)
                    sample["mix_weight"] = np.float32(1.0)
                else:
                    sample["mix_images"] = np.ascontiguousarray(
                        mix_img, np.uint8)
                    sample["mix_weight"] = np.float32(0.5)
            if self.hsv:
                sample["hsv_deltas"] = hsv_deltas
        return sample


class EvalPipeline:
    """Deterministic letterbox -> normalize; keeps undo metadata.

    ``raw_uint8``: ship the letterboxed uint8 canvas and normalize on
    the device (4x less host->device transfer, no host normalize
    pass)."""

    def __init__(self, dataset: CocoDataset, img_hw: Tuple[int, int],
                 raw_uint8: bool = False):
        self.ds = dataset
        self.img_hw = img_hw
        self.raw_uint8 = raw_uint8

    def __call__(self, idx: int) -> dict:
        rec = self.ds.records[idx]
        img = self.ds.load_image(rec)
        out, _, scale, (dx, dy) = letterbox(
            img, np.zeros((0, 4), np.float32), self.img_hw)
        return {
            "images": (np.ascontiguousarray(out, np.uint8)
                       if self.raw_uint8 else normalize(out)),
            "img_id": np.int64(rec.img_id),
            "scale": np.float32(scale),
            "offset": np.array([dx, dy], np.float32),
            "orig_hw": np.array([rec.height, rec.width], np.int32),
        }


def aspect_ratio_flags(dataset: CocoDataset) -> np.ndarray:
    """Per-image group flag: 1 for landscape (w/h > 1) else 0 — the
    grouping key of mmdet's GroupSampler (samplers/group_sampler.py:23
    ``self.flag`` set by CustomDataset._set_group_flag)."""
    return np.array(
        [1 if rec.width / max(rec.height, 1) > 1 else 0
         for rec in dataset.records], np.int64)


class GroupSampler:
    """Aspect-ratio grouped batch sampler (group_sampler.py:10 analog).

    Every emitted batch is drawn from a single aspect group so a
    per-batch letterbox orientation never mixes portrait and landscape
    padding.  Each group is shuffled per epoch and padded up to a
    multiple of ``batch_size`` by repeating random members, then the
    batch order is shuffled across groups — exactly the reference's
    epoch schedule, made deterministic by (seed, epoch).

    Under this stack's fixed-shape letterbox the grouping is an
    optimization, not a correctness requirement; it exists for parity
    and for pipelines that pick the canvas orientation per batch.
    """

    def __init__(self, dataset_or_flags, batch_size: int, seed: int = 0):
        flags = (dataset_or_flags
                 if isinstance(dataset_or_flags, np.ndarray)
                 else aspect_ratio_flags(dataset_or_flags))
        self.flags = flags
        self.batch_size = batch_size
        self.seed = seed
        self.groups = [np.flatnonzero(flags == g)
                       for g in np.unique(flags)]

    def epoch_batches(self, epoch: int = 0) -> list:
        """List of index arrays, each of length ``batch_size`` and
        single-group; covers every index at least once."""
        rng = np.random.RandomState((self.seed * 1_000_003 + epoch)
                                    % (2 ** 31))
        batches = []
        for idxs in self.groups:
            if len(idxs) == 0:
                continue
            order = rng.permutation(idxs)
            pad = (-len(order)) % self.batch_size
            if pad:
                extra = rng.choice(idxs, size=pad, replace=True)
                order = np.concatenate([order, extra])
            batches.extend(order.reshape(-1, self.batch_size))
        perm = rng.permutation(len(batches))
        return [batches[i] for i in perm]

    def __iter__(self):
        for b in self.epoch_batches(0):
            yield b


class DistributedGroupSampler(GroupSampler):
    """Sharded variant (group_sampler.py:51): the global grouped batch
    schedule is padded to a multiple of ``num_replicas`` and dealt
    round-robin, so every replica sees the same number of single-group
    batches per epoch with no coordination (the reference needs the
    torch.distributed rank handshake; here the schedule is a pure
    function of (seed, epoch, rank))."""

    def __init__(self, dataset_or_flags, batch_size: int,
                 num_replicas: int, rank: int, seed: int = 0):
        super().__init__(dataset_or_flags, batch_size, seed)
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} not in [0, {num_replicas})")
        self.num_replicas = num_replicas
        self.rank = rank

    def epoch_batches(self, epoch: int = 0) -> list:
        global_batches = super().epoch_batches(epoch)
        pad = (-len(global_batches)) % self.num_replicas
        global_batches = global_batches + global_batches[:pad]
        return global_batches[self.rank::self.num_replicas]


class InfiniteGroupBatchSampler:
    """Iteration-based grouped sampler (infinite stream, no epochs).

    Behavioral reference: ``yolox-ufp/mmdet/datasets/samplers/
    infinite_sampler.py:9`` (InfiniteGroupBatchSampler, the
    IterBasedRunner data path, detectron2 buffering logic): an endless
    seeded permutation stream, sliced ``rank::world_size``, with
    per-aspect-group buffers that emit a batch whenever one group
    accumulates ``batch_size`` members.  Unlike the epoch samplers
    there is no padding and no epoch boundary — coverage is asymptotic
    and batches are always single-group.

    Deterministic pure function of (seed, rank): no torch generator or
    dist handshake needed.
    """

    infinite = True

    def __init__(self, dataset_or_flags, batch_size: int,
                 num_replicas: int = 1, rank: int = 0, seed: int = 0,
                 shuffle: bool = True):
        flags = (dataset_or_flags
                 if isinstance(dataset_or_flags, np.ndarray)
                 else aspect_ratio_flags(dataset_or_flags))
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} not in [0, {num_replicas})")
        self.flags = flags
        self.batch_size = batch_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.shuffle = shuffle
        self.size = len(flags)

    def _infinite_indices(self):
        rng = np.random.RandomState(self.seed % (2 ** 31))
        while True:
            if self.shuffle:
                yield from rng.permutation(self.size)
            else:
                yield from range(self.size)

    def __iter__(self):
        import itertools

        buffers = {int(g): [] for g in np.unique(self.flags)}
        stream = itertools.islice(self._infinite_indices(), self.rank,
                                  None, self.num_replicas)
        for idx in stream:
            buf = buffers[int(self.flags[idx])]
            buf.append(int(idx))
            if len(buf) == self.batch_size:
                yield np.asarray(buf[:])
                del buf[:]


class _Samples(torch.utils.data.Dataset):
    """The pipeline as a map-style dataset whose keys are ``(index, seed,
    mosaic, mixup)``: a worker builds ``pipeline(index,
    RandomState(seed))`` with the augmentation flags that the main
    process's pipeline had when the key was drawn (so
    ``TrainPipeline.disable_aug`` reaches the workers)."""

    def __init__(self, pipeline: TrainPipeline):
        self.pipeline = pipeline

    def __len__(self):
        return len(self.pipeline.ds)

    def __getitem__(self, key):
        idx, seed, mosaic, mix = key
        self.pipeline.mosaic, self.pipeline.mixup = mosaic, mix
        return self.pipeline(idx, np.random.RandomState(seed))


class _Schedule:
    """The JAX package's producer loop as a batch sampler: per epoch the
    sampler's (or a plain seeded permutation's) batches, each with
    ``batch_size`` seeds drawn from the master stream; endless."""

    def __init__(self, pipeline: TrainPipeline, batch_size: int, seed: int,
                 sampler):
        self.pipeline = pipeline
        self.batch_size = batch_size
        self.seed = seed
        self.sampler = sampler

    def __iter__(self):
        n = len(self.pipeline.ds)
        bs, sampler = self.batch_size, self.sampler
        epoch = 0
        master = np.random.RandomState(self.seed)
        while True:
            if getattr(sampler, "infinite", False):
                schedule = sampler          # endless batch stream
            elif sampler is not None:
                schedule = sampler.epoch_batches(epoch)
            else:
                order = master.permutation(n)
                schedule = [order[s:s + bs]
                            for s in range(0, n - bs + 1, bs)]
            for idxs in schedule:
                seeds = master.randint(0, 2 ** 31, size=bs)
                flags = (self.pipeline.mosaic, self.pipeline.mixup)
                yield [(int(i), int(s), *flags) for i, s in zip(idxs, seeds)]
            epoch += 1


def _worker_init(_worker_id: int) -> None:
    """A spawned worker returns into the interpreter's finalization while
    its queue's daemon feeder thread may still be sending a batch that a
    closed loader will never read; finalization then unwinds that thread
    through C++ frames and the process aborts ("terminate called without
    an active exception"), which the loader reports as a failed worker.
    Exit as a forked worker does, at once: multiprocessing's own cleanup
    (``Process._bootstrap``) has run by the time atexit handlers do."""
    atexit.register(os._exit, 0)


def collate(samples: Sequence[dict]) -> dict:
    """Stack sample dicts (``make_batch``) into CPU tensors."""
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in make_batch(samples).items()}


def train_loader(pipeline: TrainPipeline, batch_size: int, seed: int = 0,
                 num_workers: int = 4, prefetch: int = 2,
                 sampler: Optional[GroupSampler] = None,
                 pin_memory: bool = False) -> Iterator[dict]:
    """Endless stream of batches (dicts of CPU tensors; pinned with
    ``pin_memory``, for a ``non_blocking`` copy to the card).

    ``sampler``: optional GroupSampler / DistributedGroupSampler /
    InfiniteGroupBatchSampler supplying the batch schedule; default is a
    plain seeded permutation per epoch.  ``num_workers`` processes build
    the samples (0: the calling thread does), each holding ``prefetch``
    batches in flight.  ``TrainPipeline.disable_aug`` reaches the batches
    drawn after it; the ``num_workers * prefetch`` batches already in
    flight keep the pipeline they were drawn with (the JAX package's
    thread loader likewise keeps what its queue holds).  Closing the
    generator (``close()``, or leaving the loop that drives it) stops
    and joins every worker."""
    kw = {}
    if num_workers > 0:
        kw = dict(multiprocessing_context="spawn", prefetch_factor=prefetch,
                  worker_init_fn=_worker_init)
    loader = torch.utils.data.DataLoader(
        _Samples(pipeline),
        batch_sampler=_Schedule(pipeline, batch_size, seed, sampler),
        num_workers=num_workers, collate_fn=collate, pin_memory=pin_memory,
        **kw)
    it = iter(loader)
    try:
        while True:
            yield next(it)
    finally:
        shutdown = getattr(it, "_shutdown_workers", None)
        if shutdown is not None:
            shutdown()


def eval_loader(pipeline: EvalPipeline, batch_size: int) -> Iterator[dict]:
    """Sequential fixed-size batches; the tail batch repeats the last
    sample (consumers dedupe by img_id)."""
    n = len(pipeline.ds)
    for start in range(0, n, batch_size):
        idxs = list(range(start, min(start + batch_size, n)))
        while len(idxs) < batch_size:
            idxs.append(idxs[-1])
        yield make_batch([pipeline(i) for i in idxs])
