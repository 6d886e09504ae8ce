"""The port's SSD data path against OpenCV and the JAX package's, on the
CPU: the HSV conversions and the augment chain
(aod_meh_hua_torch/data/ssd_augment.py), the float32 linear resize
(data/pipeline.py resize_linear_f32), prepare_sample's float path, and
TrainLoader with the SSD augment chain (data/loader.py augment_fn).

Tolerances: none. The randomly initialised SSD is sensitive to the last
bit of its input (L2Norm lifts a near-zero conv4_3 vector to norm 20;
one ulp in a training batch moved the JAX --mini run's loss by 7%), so
the port follows OpenCV's float arithmetic (its vector paths' fused
multiply-adds, the scalar tail of each row of cvtColor) and every image
here is held to cv2 bit for bit. The float resize is bit-equal for
sources of at least 40 columns; narrower ones differ from cv2 in a few
border columns, and the augment chain's crops keep at least 30% of each
side of a VOC image. Boxes, labels, the RandomState streams and the
loaders' batches are exact.
"""

import cv2
import numpy as np
import pytest

from aod_meh_hua_tpu.data import PipelineConfig as JPipelineConfig
from aod_meh_hua_tpu.data import TrainLoader as JTrainLoader
from aod_meh_hua_tpu.data import ssd_augment as jaug
from aod_meh_hua_tpu.data.pipeline import prepare_sample as jprepare_sample
from aod_meh_hua_tpu.data.voc import VOCDataset as JVOCDataset
from aod_meh_hua_tpu.utils.config import SSDConfig as JSSDConfig
from aod_meh_hua_torch.data import ssd_augment as taug
from aod_meh_hua_torch.data.loader import TrainLoader
from aod_meh_hua_torch.data.pipeline import PipelineConfig, prepare_sample, resize_linear_f32
from aod_meh_hua_torch.data.voc import VOCDataset
from aod_meh_hua_torch.utils.config import SSDConfig

from test_data import make_voc
from torch_parity import THIN_SSD
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

SSD_PIPE = dict(img_scale=(300, 300), canvas=(300, 300), std=(1.0, 1.0, 1.0), keep_ratio=False,
                device_normalize=True)


def _float_image(rng, h, w, grey_rows=0):
    """A float BGR image over [-40, 300) (brightness shifts leave that
    range); the first grey_rows rows grey (diff = 0), then rows with
    r == g and with b == r (ties for the max), and hues on both sides of
    0 / 360 (b slightly above g with r the max)."""
    img = (rng.rand(h, w, 3) * 340 - 40).astype(np.float32)
    img[:grey_rows] = img[:grey_rows, :, :1]
    q = h // 5
    img[grey_rows:grey_rows + q, :, 2] = img[grey_rows:grey_rows + q, :, 1]
    img[grey_rows + q:grey_rows + 2 * q, :, 0] = img[grey_rows + q:grey_rows + 2 * q, :, 2]
    w0 = grey_rows + 2 * q
    img[w0:w0 + q, :, 2] = 250.0
    img[w0:w0 + q, :, 1] = 100.0
    img[w0:w0 + q, :, 0] = 100.0 + rng.uniform(-1e-3, 1e-3, (q, w)).astype(np.float32)
    return img


@pytest.mark.parametrize("shape", [(200, 200), (201, 203), (7, 5), (375, 500), (333, 500)])
def test_bgr_to_hsv_bit_equal_to_cv2(shape):
    """H in degrees in [0, 360], S in [0, 1], V on the input's scale, for
    widths with and without a scalar tail (width % 8)."""
    img = _float_image(np.random.RandomState(sum(shape)), *shape, grey_rows=shape[0] // 5)
    want = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    got = taug.bgr_to_hsv(img)
    np.testing.assert_array_equal(got, want)
    assert (got[..., 1] == 0).any() and (got[..., 0] > 359).any()


@pytest.mark.parametrize("shape", [(200, 200), (201, 203), (7, 5), (375, 500)])
def test_hsv_to_bgr_bit_equal_to_cv2(shape):
    """After the distortion's saturation scale and hue shift with its
    wrap-around, as photo_metric_distortion applies them."""
    rng = np.random.RandomState(sum(shape) + 1)
    hsv = cv2.cvtColor(_float_image(rng, *shape, grey_rows=shape[0] // 5), cv2.COLOR_BGR2HSV)
    hsv[..., 1] *= np.float32(1.37)
    hsv[..., 0] += np.float32(17.3)
    hsv[..., 0][hsv[..., 0] > 360] -= 360
    np.testing.assert_array_equal(taug.hsv_to_bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


# (src h, src w): VOC sizes; expand canvases up to 4x; crops down to a
# third of a side; an exact 2x downscale; odd sizes; upscales
RESIZE_SHAPES = [(375, 500), (500, 375), (333, 500), (1500, 2000), (1200, 1600), (1000, 1333),
                 (90, 120), (120, 90), (150, 420), (200, 150), (600, 600), (301, 299), (40, 300),
                 (300, 300)]


@pytest.mark.parametrize("shape", RESIZE_SHAPES)
def test_resize_linear_f32_bit_equal_to_cv2(shape):
    rng = np.random.RandomState(shape[0] * 7 + shape[1])
    img = (rng.rand(*shape, 3) * 340 - 40).astype(np.float32)
    want = cv2.resize(img, (300, 300), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(resize_linear_f32(img, 300, 300), want)


def test_resize_linear_f32_refuses_uint8():
    with pytest.raises(TypeError):
        resize_linear_f32(np.zeros((4, 4, 3), np.uint8), 2, 2)


def _ann(rng, h, w, n):
    xy = rng.uniform(0, 1, (n, 2)) * [w * 0.6, h * 0.6]
    wh = rng.uniform(0.1, 0.4, (n, 2)) * [w, h]
    return {"bboxes": np.concatenate([xy, xy + wh], 1).astype(np.float32),
            "labels": rng.randint(0, 20, n)}


@pytest.mark.parametrize("seed", range(12))
def test_ssd_train_augment_matches_jax(seed):
    """The whole chain on a uint8 image from the same RandomState: the
    image bit for bit, boxes and labels exact, and the two streams in
    the same state after it (every draw in the same order)."""
    rng = np.random.RandomState(100 + seed)
    h, w = (375, 500) if seed % 2 else (500, 333)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    ann = _ann(rng, h, w, 1 + seed % 4)
    jr, tr = np.random.RandomState(seed), np.random.RandomState(seed)
    jimg, jann = jaug.ssd_train_augment(img, {k: v.copy() for k, v in ann.items()}, jr)
    timg, tann = taug.ssd_train_augment(img, {k: v.copy() for k, v in ann.items()}, tr)
    assert timg.dtype == jimg.dtype == np.float32
    np.testing.assert_array_equal(timg, jimg)
    np.testing.assert_array_equal(tann["bboxes"], jann["bboxes"])
    np.testing.assert_array_equal(tann["labels"], jann["labels"])
    assert jr.randint(2 ** 31) == tr.randint(2 ** 31)


@pytest.mark.parametrize("seed", range(6))
def test_prepare_sample_float_path_matches_jax(seed):
    """An augmented float image through prepare_sample with the SSD
    pipeline (exact warp, host normalisation with std 1, flips): the
    canvas bit for bit, the boxes and metadata exact."""
    rng = np.random.RandomState(200 + seed)
    img = rng.randint(0, 256, (375, 500, 3)).astype(np.uint8)
    ann = _ann(rng, 375, 500, 3)
    aug, aann = jaug.ssd_train_augment(img, ann, np.random.RandomState(seed))
    want = jprepare_sample(aug, {k: v.copy() for k, v in aann.items()},
                           JPipelineConfig(**SSD_PIPE), rng=np.random.RandomState(seed))
    got = prepare_sample(aug, {k: v.copy() for k, v in aann.items()}, PipelineConfig(**SSD_PIPE),
                         rng=np.random.RandomState(seed))
    assert got["image"].dtype == np.float32 and got["image"].shape == (300, 300, 3)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.fixture(scope="module")
def voc_tree(tmp_path_factory):
    base, _, _ = make_voc(str(tmp_path_factory.mktemp("ssdvoc")), "VOC2007", n=10, seed=4)
    return base


def _loaders(voc_tree, workers):
    lst = f"{voc_tree}/ImageSets/Main/trainval.txt"
    kw = dict(batch_size=4, repeat=2, seed=9, prefetch=False, num_workers=workers)
    j = JTrainLoader(JVOCDataset(lst, voc_tree), np.arange(6), JSSDConfig(**THIN_SSD),
                     JPipelineConfig(**SSD_PIPE), augment_fn=jaug.ssd_train_augment, **kw)
    t = TrainLoader(VOCDataset(lst, voc_tree), np.arange(6), SSDConfig(**THIN_SSD),
                    PipelineConfig(**SSD_PIPE), augment_fn=taug.ssd_train_augment, **kw)
    return j, t


@pytest.mark.parametrize("workers", [0, 4])
def test_train_loader_with_ssd_augment_matches_jax(voc_tree, workers):
    """One epoch of each package's TrainLoader with the SSD chain: the
    same batches, bit for bit (images, boxes, labels, flags, shapes)."""
    j, t = _loaders(voc_tree, workers)
    jb, tb = list(j), list(t)
    assert len(jb) == len(tb) >= 3
    for (jo, jbatch), (to, tbatch) in zip(jb, tb):
        assert jo == to
        for name, a, b in zip(jbatch._fields, jbatch, tbatch):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=name)
        assert np.asarray(tbatch.images).dtype == np.float32
