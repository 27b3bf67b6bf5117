"""The port's data feed against the JAX package's on the CPU: the SplitMix64
draw key, the procedural faces and their attribute probe, the CelebA split
and items (with each of JAX's resize backends), and the threaded
`DataPipeline`'s batch stream, all bit-equal; then the port-only parts: a
worker's error, `start`, `to_device` (its pinned path to the card is in
tests/test_torch_cuda_kernels.py)."""

import numpy as np
import pytest
import torch
from PIL import Image

from dwcgan_tpu import native as jax_native
from dwcgan_tpu.data import celeba as jax_celeba
from dwcgan_tpu.data import procedural as jax_procedural
from dwcgan_tpu.data.drawkey import draw_key as jax_draw_key
from dwcgan_tpu.data.pipeline import DataPipeline as JaxDataPipeline
from dwcgan_tpu_torch.data import celeba, procedural
from dwcgan_tpu_torch.data.drawkey import draw_key
from dwcgan_tpu_torch.data.pipeline import DataPipeline, to_device

torch.set_num_threads(1)

ATTRS = ("Black_Hair", "Blond_Hair", "Brown_Hair", "Male", "Smiling", "Young",
         "Eyeglasses", "No_Beard", "Bald", "Bangs")


def _equal_items(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("vals", [(), (0,), (1234, 0, 0, 0), (1235, 3, 7, 11),
                                  (2**63, 1, 2), (-5, 9), (7,) * 6])
def test_draw_key_matches_jax(vals):
    assert draw_key(*vals) == jax_draw_key(*vals)


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_procedural_items_match_jax(mode, epoch):
    kw = dict(n_samples=24, image_size=32, seed=5, mode=mode, max_text_len=20)
    ours, theirs = procedural.ProceduralFaceDataset(**kw), \
        jax_procedural.ProceduralFaceDataset(**kw)
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    for i in (0, 7, 23):
        a, b = ours.item(i, epoch), theirs.item(i, epoch)
        _equal_items(a, b)
        assert (procedural.measure_attributes(a[0])
                == jax_procedural.measure_attributes(b[0])).all()
    # the stateful __getitem__ (the sample grid's fixed batch) too
    _equal_items(ours[3], theirs[3])


def test_attribute_probe_reads_the_renderer_as_jax():
    rng, jrng = np.random.default_rng(2), np.random.default_rng(2)
    labels = procedural.sample_labels(16, rng)
    np.testing.assert_array_equal(labels, jax_procedural.sample_labels(16, jrng))
    faces = np.stack([procedural.render_face(l, 64, np.random.default_rng(i))
                      for i, l in enumerate(labels)])
    np.testing.assert_array_equal(
        procedural.attribute_accuracy(faces, labels),
        jax_procedural.attribute_accuracy(faces, labels))


@pytest.fixture(scope="module")
def celeba_files(tmp_path_factory):
    """A generated attribute file and 12 small PNGs, 45 x 38 (w x h): with
    crop 36 the horizontal offset is (45 - 36) // 2 = 4 of an odd 9, so a
    flip applied after the crop would land one column off."""
    tmp = tmp_path_factory.mktemp("celeba")
    rng = np.random.default_rng(0)
    lines = ["12", " ".join(ATTRS)]
    for i in range(12):
        name = f"{i:06d}.png"
        Image.fromarray(rng.integers(0, 256, (38, 45, 3), dtype=np.uint8)).save(
            tmp / name)
        lines.append(name + " " + " ".join(rng.choice(["1", "-1"], len(ATTRS))))
    (tmp / "attrs.txt").write_text("\n".join(lines) + "\n")
    return tmp


@pytest.mark.parametrize("backend", ["auto", "native", "pil"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_celeba_split_and_items_match_jax(celeba_files, mode, backend):
    assert jax_native.available()   # else JAX's `auto` would take PIL
    kw = dict(mode=mode, crop_size=36, image_size=32, max_text_len=20, seed=3,
              test_split=4)
    args = (str(celeba_files), str(celeba_files / "attrs.txt"))
    ours = celeba.CelebADataset(*args, resize_backend=backend, **kw)
    theirs = jax_celeba.CelebADataset(*args, resize_backend=backend, **kw)
    assert ours.samples == theirs.samples
    assert len(ours) == (4 if mode == "test" else 8)
    flips = 0
    for epoch in (0, 1):
        for i in range(len(ours)):
            a, b = ours.item(i, epoch), theirs.item(i, epoch)
            _equal_items(a[1:], b[1:])
            assert a[0].shape == (32, 32, 3) and a[0].dtype == np.float32
            np.testing.assert_array_equal(a[0], b[0])
            # the flip JAX drew, seen in the image
            with Image.open(celeba_files / ours.samples[i][0]) as im:
                unflipped = celeba._center_crop_resize(im, 36, 32, backend)
            flips += not np.array_equal(a[0], unflipped)
    assert (flips > 0) == (mode == "train")


def _procedural(n=40):
    return procedural.ProceduralFaceDataset(n_samples=n, image_size=32, seed=7,
                                            max_text_len=20)


@pytest.mark.parametrize("num_workers", [1, 3])
def test_pipeline_stream_matches_jax_over_two_epochs(num_workers):
    """40 rows at batch 8: 5 batches an epoch; 10 batches = two epochs."""
    ds = _procedural()
    jds = jax_procedural.ProceduralFaceDataset(n_samples=40, image_size=32,
                                               seed=7, max_text_len=20)
    ours = DataPipeline(ds, 8, num_workers=num_workers, seed=7)
    theirs = JaxDataPipeline(jds, 8, num_workers=num_workers, seed=7,
                             process_index=0, process_count=1)
    a, b = iter(ours), iter(theirs)
    try:
        for _ in range(10):
            _equal_items(next(a), next(b))
    finally:
        a.close()
        b.close()


def test_pipeline_start_skips_batches_without_building_them():
    calls = []

    class Counting(procedural.ProceduralFaceDataset):
        def item(self, index, epoch):
            calls.append((index, epoch))
            return super().item(index, epoch)

    ds = Counting(n_samples=40, image_size=32, seed=7, max_text_len=20)
    full = iter(DataPipeline(_procedural(), 8, num_workers=2, seed=7))
    late = iter(DataPipeline(ds, 8, num_workers=1, prefetch=1, seed=7, start=7))
    try:
        want = [next(full) for _ in range(9)][7:]
        got = [next(late) for _ in range(2)]
    finally:
        full.close()
        late.close()
    for a, b in zip(got, want):
        _equal_items(a, b)
    # the first items built are batch 7's (epoch 1, the stream's 8th slice)
    stream = DataPipeline(_procedural(), 8, seed=7)._index_stream()
    epoch, idxs = [next(stream) for _ in range(8)][7]
    assert calls[:8] == [(int(i), epoch) for i in idxs] and epoch == 1


def test_worker_error_is_raised_in_the_consumer():
    class Bad(procedural.ProceduralFaceDataset):
        def item(self, index, epoch):
            raise ValueError("boom")

    pipe = DataPipeline(Bad(n_samples=16, image_size=32, seed=3, max_text_len=20),
                        4, num_workers=2, seed=3)
    with pytest.raises(RuntimeError, match="data pipeline worker failed") as e:
        next(iter(pipe))
    assert isinstance(e.value.__cause__, ValueError)


def test_pipeline_refuses_a_dataset_smaller_than_a_batch():
    with pytest.raises(ValueError, match="smaller than one global batch"):
        DataPipeline(_procedural(6), 8)


def test_to_device_on_the_cpu_keeps_nhwc_and_the_host_lengths():
    it = iter(DataPipeline(_procedural(), 8, num_workers=1, seed=7))
    try:
        b = next(it)
    finally:
        it.close()
    t = to_device(b, "cpu")
    assert t.image.shape == (8, 32, 32, 3) and t.image.dtype == torch.float32
    assert t.txt.dtype == torch.int64 and t.txt_len.dtype == torch.int64
    for x, y in zip(t, b):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
