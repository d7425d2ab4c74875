"""The port's training loader against the JAX package's.

``TrainPipeline`` samples and the first batches of ``train_loader`` (the
port's on ``spawn``ed worker processes and in the calling thread, the
JAX package's on its threads) from the same seed are equal key for key:
boxes, labels, ``*_valid`` and, since every pixel op of the port equals
OpenCV here (tests/test_torch_augment.py), the images too; bit for bit,
no tolerance.  The samplers' schedules are equal; the mode switch
reaches the workers; closing the loader leaves no worker alive.
"""

import multiprocessing
import time

import numpy as np
import pytest
import torch

from glsdet_tpu.data import coco as jcoco
from glsdet_tpu.data import loader as jl
from glsdet_tpu_torch.data import coco as tcoco
from glsdet_tpu_torch.data import loader as tl

from torch_port_util import write_png_dataset

HW = (48, 48)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_png_dataset(str(tmp_path_factory.mktemp("ds")))


def pipelines(dataset, **kw):
    return (jl.TrainPipeline(jcoco.CocoDataset(*dataset), HW, 20, **kw),
            tl.TrainPipeline(tcoco.CocoDataset(*dataset), HW, 20, **kw))


def assert_batches_equal(want, got):
    assert set(want) == set(got)
    for k in want:
        g = got[k].numpy() if torch.is_tensor(got[k]) else got[k]
        assert g.dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(g, want[k], err_msg=k)


MODES = {
    "host": {},
    "no_mosaic": {"mosaic": False},
    "no_mixup": {"enable_mixup": False, "raw_uint8": True},
    "device_color": {"device_color": True},
    "device_geom": {"device_color": True, "device_geom": True,
                    "geom_src_hw": (80, 100)},
    "no_hsv_flip": {"hsv": False, "flip_prob": 1.0, "device_color": True},
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_train_pipeline_samples_equal_jax(dataset, mode):
    jp, tp = pipelines(dataset, **MODES[mode])
    for i in range(8):
        rj, rt = np.random.RandomState(i), np.random.RandomState(i)
        assert_batches_equal(jp(i, rj), tp(i, rt))
        assert rj.randint(2 ** 31) == rt.randint(2 ** 31)


def test_eval_pipeline_and_loader_equal_jax(dataset):
    for raw in (False, True):
        jp = jl.EvalPipeline(jcoco.CocoDataset(*dataset), HW, raw_uint8=raw)
        tp = tl.EvalPipeline(tcoco.CocoDataset(*dataset), HW, raw_uint8=raw)
        for want, got in zip(jl.eval_loader(jp, 3), tl.eval_loader(tp, 3)):
            assert_batches_equal(want, got)


def first_batches(loader, n):
    out = [next(loader) for _ in range(n)]
    loader.close()
    return out


@pytest.mark.parametrize("workers,mode", [(0, "host"), (2, "device_color"),
                                          (0, "device_geom")])
def test_train_loader_batches_equal_jax(dataset, workers, mode):
    jp, tp = pipelines(dataset, **MODES[mode])
    want = first_batches(jl.train_loader(jp, 3, seed=5, num_threads=2), 5)
    got = first_batches(tl.train_loader(tp, 3, seed=5,
                                        num_workers=workers), 5)
    for w, g in zip(want, got):
        assert_batches_equal(w, g)


@pytest.mark.parametrize("which", ["group", "distributed", "infinite"])
def test_samplers_equal_jax(dataset, which):
    jd, td = jcoco.CocoDataset(*dataset), tcoco.CocoDataset(*dataset)
    np.testing.assert_array_equal(tl.aspect_ratio_flags(td),
                                  jl.aspect_ratio_flags(jd))
    if which == "group":
        js, ts = jl.GroupSampler(jd, 2, seed=3), tl.GroupSampler(td, 2, seed=3)
    elif which == "distributed":
        js = jl.DistributedGroupSampler(jd, 2, 3, 1, seed=3)
        ts = tl.DistributedGroupSampler(td, 2, 3, 1, seed=3)
        with pytest.raises(ValueError):
            tl.DistributedGroupSampler(td, 2, 3, 3)
    else:
        js = jl.InfiniteGroupBatchSampler(jd, 2, 2, 1, seed=3)
        ts = tl.InfiniteGroupBatchSampler(td, 2, 2, 1, seed=3)
        jit, tit = iter(js), iter(ts)
        for _ in range(20):
            np.testing.assert_array_equal(next(tit), next(jit))
        return
    for epoch in range(3):
        for a, b in zip(js.epoch_batches(epoch), ts.epoch_batches(epoch),
                        strict=True):
            np.testing.assert_array_equal(b, a)
    want = first_batches(jl.train_loader(
        jl.TrainPipeline(jd, HW, 20), 2, seed=1, sampler=js), 6)
    got = first_batches(tl.train_loader(
        tl.TrainPipeline(td, HW, 20), 2, seed=1, num_workers=0,
        sampler=ts), 6)
    for w, g in zip(want, got):
        assert_batches_equal(w, g)


def test_disable_aug_reaches_the_workers(dataset):
    """Batches drawn after the switch come from the plain pipeline in the
    worker processes; the ``workers * prefetch`` batches already drawn
    keep the mosaic, as the loader's docstring says."""
    _, tp = pipelines(dataset, device_color=True)
    loader = tl.train_loader(tp, 2, seed=0, num_workers=1, prefetch=2)
    try:
        first = next(loader)
        assert "mix_images" in first
        tp.disable_aug()
        keys = [set(next(loader)) for _ in range(4)]
    finally:
        loader.close()
    assert ["mix_images" in k for k in keys] == [True, True, False, False]
    plain = tl.TrainPipeline(tcoco.CocoDataset(*dataset), HW, 20,
                             mosaic=False, device_color=True)
    assert set(plain(0, np.random.RandomState(0))) == keys[-1]


def test_closing_the_loader_leaves_no_worker(dataset):
    _, tp = pipelines(dataset)
    before = set(multiprocessing.active_children())
    loader = tl.train_loader(tp, 2, seed=0, num_workers=2)
    next(loader)
    workers = set(multiprocessing.active_children()) - before
    assert len(workers) == 2
    loader.close()
    deadline = time.time() + 30
    while any(p.is_alive() for p in workers) and time.time() < deadline:
        time.sleep(0.1)
    assert not any(p.is_alive() for p in workers)


def test_batches_come_out_as_cpu_tensors(dataset):
    _, tp = pipelines(dataset, device_color=True)
    batch = first_batches(tl.train_loader(tp, 2, num_workers=0), 1)[0]
    assert all(torch.is_tensor(v) and v.device.type == "cpu"
               for v in batch.values())
    assert batch["images"].dtype == torch.uint8
    assert batch["gt_labels"].dtype == torch.int32
