"""Dataset wrappers, the port's copy of ``glsdet_tpu.data.wrappers``.

Behavioral reference: ``mmdet/datasets/dataset_wrappers.py`` —
ConcatDataset (:17), RepeatDataset (:153), ClassBalancedDataset (:209,
oversample images containing rare categories per the LVIS recipe),
MultiImageMixDataset (:335 — in this rebuild the mosaic/mixup mixing
lives directly in ``loader.TrainPipeline``, which draws its own extra
indices, so no wrapper is needed for it).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import List, Sequence

from glsdet_tpu_torch.data.coco import CocoDataset, CocoRecord


class _RecordView:
    """Minimal dataset interface: .records, .load_image, .class_names."""

    def __init__(self, base: CocoDataset, records: List[CocoRecord]):
        self._base = base
        self.records = records
        self.class_names = base.class_names
        self.ignore_regions = base.ignore_regions

    def __len__(self):
        return len(self.records)

    def load_image(self, rec):
        return self._base.load_image(rec)


class ConcatDataset:
    """Concatenate datasets with identical class lists."""

    def __init__(self, datasets: Sequence):
        assert datasets
        self.datasets = list(datasets)
        self.class_names = datasets[0].class_names
        for d in datasets[1:]:
            assert d.class_names == self.class_names, "class mismatch"
        self.records = []
        self._owner = []
        for d in self.datasets:
            for r in d.records:
                self.records.append(r)
                self._owner.append(d)

    def __len__(self):
        return len(self.records)

    def load_image(self, rec):
        return self._owner[self.records.index(rec)].load_image(rec)


class RepeatDataset(_RecordView):
    """Repeat a dataset N times (epoch-size multiplier)."""

    def __init__(self, dataset, times: int):
        super().__init__(dataset, list(dataset.records) * times)


class ClassBalancedDataset(_RecordView):
    """Oversample images containing rare categories.

    Repeat factor per image = max over its categories of
    ``max(1, sqrt(oversample_thr / category_frequency))``
    (dataset_wrappers.py:209, LVIS recipe).
    """

    def __init__(self, dataset, oversample_thr: float = 1e-3):
        n_img = len(dataset.records)
        cat_img_count: defaultdict = defaultdict(int)
        for rec in dataset.records:
            for c in set(rec.labels.tolist()):
                cat_img_count[c] += 1
        cat_freq = {c: n / n_img for c, n in cat_img_count.items()}
        cat_repeat = {
            c: max(1.0, math.sqrt(oversample_thr / f))
            for c, f in cat_freq.items()
        }
        records = []
        for rec in dataset.records:
            cats = set(rec.labels.tolist())
            r = max((cat_repeat[c] for c in cats), default=1.0)
            records.extend([rec] * int(math.ceil(r)))
        super().__init__(dataset, records)
