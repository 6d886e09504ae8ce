"""The port's data path (aod_meh_hua_torch/data/) against OpenCV and the
JAX package's, on the CPU.

1. The JPEG decoder (data/jpeg.py) is bit-equal to cv2.imdecode(...,
   IMREAD_COLOR) on JPEGs cv2.imencode makes here: qualities 50, 75 and
   95; 4:2:0, 4:2:2 and 4:4:4; greyscale; restart intervals; optimized
   Huffman tables; odd sizes down to 1x1; the eight EXIF orientations.
   What it does not read raises ValueError. jpeg_size reads the frame
   header as PIL does. The committed fixtures still hash as fixtures.json
   says, through cv2 and through the port.
2. resize_linear_u8 is bit-equal to cv2.resize(INTER_LINEAR).
3. prepare_sample, VOCDataset/ConcatVOC, TrainLoader, EvalLoader, the
   canvas cache and the splits give outputs equal to the JAX package's
   (which decodes and resizes with OpenCV) on the same seeds, RNG states
   included.

Every comparison is exact: the port copies these functions or holds them
to OpenCV's integer arithmetic.
"""

import hashlib
import json
import os
import struct

import cv2
import numpy as np
import pytest

from aod_meh_hua_tpu.data import ConcatVOC as JConcatVOC
from aod_meh_hua_tpu.data import EvalLoader as JEvalLoader
from aod_meh_hua_tpu.data import PipelineConfig as JPipelineConfig
from aod_meh_hua_tpu.data import TrainLoader as JTrainLoader
from aod_meh_hua_tpu.data import VOCDataset as JVOCDataset
from aod_meh_hua_tpu.data import canvas_cache as jcache
from aod_meh_hua_tpu.data import pipeline as jpipe
from aod_meh_hua_tpu.data import splits as jsplits
from aod_meh_hua_tpu.utils.config import tiny_test_config as jtiny
from aod_meh_hua_torch.data import canvas_cache as tcache
from aod_meh_hua_torch.data import jpeg
from aod_meh_hua_torch.data import pipeline as tpipe
from aod_meh_hua_torch.data import splits as tsplits
from aod_meh_hua_torch.data.loader import EvalLoader, TrainLoader
from aod_meh_hua_torch.data.voc import ConcatVOC, VOCDataset
from aod_meh_hua_torch.utils.config import tiny_test_config as ttiny

from test_data import make_voc
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "aod_meh_hua_torch", "data", "fixtures")
SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}


def _image(h, w, seed, smooth=True):
    rng = np.random.RandomState(seed)
    if not smooth:
        return rng.randint(0, 256, (h, w, 3), np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 17.0 + c) * np.cos(y / 23.0 - c) for c in range(3)], -1)
    return np.clip(img + rng.randn(h, w, 3) * 6, 0, 255).astype(np.uint8)


def _encode(img, quality=95, sampling="420", extra=()):
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                                         *extra])
    assert ok
    return buf


def _assert_decodes_like_cv2(buf):
    want = cv2.imdecode(buf, cv2.IMREAD_COLOR)
    got = jpeg.decode(buf.tobytes())
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --- 1. the decoder ------------------------------------------------------------

DECODE_CASES = (
    # quality x sampling on an odd size, noise (every coefficient coded)
    [(f"q{q}-{s}-17x29-noise", (17, 29), q, s, (), False) for q in (50, 75, 95)
     for s in ("420", "422", "444")]
    # VOC sizes, smooth content
    + [("q75-420-333x500", (333, 500), 75, "420", (), True),
       ("q95-444-375x500", (375, 500), 95, "444", (), True),
       ("q95-422-500x333", (500, 333), 95, "422", (), True),
       ("q50-420-500x375", (500, 375), 50, "420", (), True)]
    # restart intervals, optimized tables
    + [(f"rst{n}-61x83", (61, 83), 75, "420", (cv2.IMWRITE_JPEG_RST_INTERVAL, n), False)
       for n in (1, 3)]
    + [("optimize-q95-333x500", (333, 500), 95, "420", (cv2.IMWRITE_JPEG_OPTIMIZE, 1), True),
       ("optimize-q50-422-31x45", (31, 45), 50, "422", (cv2.IMWRITE_JPEG_OPTIMIZE, 1), False)]
    # edges: one MCU, partial MCUs, chroma planes 1 or 2 samples wide
    # (jdsample.c upsamples those by replication)
    + [(f"{s}-{h}x{w}", (h, w), 90, s, (), False) for s in ("420", "422")
       for h, w in ((1, 1), (2, 3), (3, 4), (5, 5), (8, 8), (9, 17), (16, 33))]
)


@pytest.mark.parametrize("name,hw,quality,sampling,extra,smooth", DECODE_CASES,
                         ids=[c[0] for c in DECODE_CASES])
def test_decode_bit_equal_to_cv2(name, hw, quality, sampling, extra, smooth):
    img = _image(*hw, seed=len(name), smooth=smooth)
    _assert_decodes_like_cv2(_encode(img, quality, sampling, extra))


@pytest.mark.parametrize("hw", [(17, 29), (375, 500)])
def test_decode_greyscale(hw):
    """One component: IMREAD_COLOR returns three equal channels."""
    buf = _encode(_image(*hw, seed=1)[..., 1], 75)
    _assert_decodes_like_cv2(buf)


def _with_exif(buf, orientation: int, endian: str) -> bytes:
    """The JPEG with an APP1 Exif segment carrying `orientation` in IFD0."""
    e = "<" if endian == "II" else ">"
    tiff = (endian.encode() + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0))
    payload = b"Exif\x00\x00" + tiff
    data = buf.tobytes()
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload + data[2:]


@pytest.mark.parametrize("orientation", range(1, 9))
def test_decode_exif_orientation(orientation, tmp_path):
    """cv2.imread and cv2.imdecode apply the EXIF orientation; so does
    the port. jpeg_size reports the stored frame, as PIL's size does."""
    buf = _encode(_image(13, 22, seed=orientation, smooth=False), 80)
    data = _with_exif(buf, orientation, "II" if orientation % 2 else "MM")
    path = str(tmp_path / "o.jpg")
    with open(path, "wb") as f:
        f.write(data)
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(jpeg.imread(path), want)
    assert jpeg.jpeg_size(path) == (22, 13)


def test_decoder_refuses_what_it_does_not_read(tmp_path):
    img = _image(24, 40, seed=2, smooth=False)
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match=r"prog\.jpg: progressive"):
        jpeg.decode(prog.tobytes(), "prog.jpg")
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode(cv2.imencode(".png", img)[1].tobytes())
    data = _encode(img).tobytes()
    with pytest.raises(ValueError, match="truncated"):
        jpeg.decode(data[:len(data) // 2])
    # 4:4:0 sampling (luma 1x2)
    ok, s440 = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])
    with pytest.raises(ValueError, match="sampling"):
        jpeg.decode(s440.tobytes())
    # 12-bit precision in the frame header
    sof = data.index(b"\xff\xc0")
    with pytest.raises(ValueError, match="12-bit"):
        jpeg.decode(data[:sof + 4] + b"\x0c" + data[sof + 5:])


def test_jpeg_size_matches_pil(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    for i, (h, w) in enumerate([(375, 500), (500, 333), (17, 29)]):
        path = str(tmp_path / f"{i}.jpg")
        cv2.imwrite(path, _image(h, w, seed=i, smooth=False))
        with Image.open(path) as im:
            assert jpeg.jpeg_size(path) == im.size == (w, h)


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_fixture_hashes():
    """The committed fixtures (tests/make_jpeg_fixtures.py): cv2 here, and
    the port, still give the hashes of fixtures.json."""
    with open(os.path.join(FIXTURES, "fixtures.json")) as f:
        table = json.load(f)["files"]
    assert len(table) >= 6
    for name, e in table.items():
        path = os.path.join(FIXTURES, name)
        dec = cv2.imread(path, cv2.IMREAD_COLOR)
        assert _sha(dec) == e["decode_sha256"], name
        w, h = e["resize"]
        assert _sha(cv2.resize(dec, (w, h), interpolation=cv2.INTER_LINEAR)) == e["resize_sha256"]
        got = jpeg.imread(path)
        assert _sha(got) == e["decode_sha256"], name
        assert _sha(tpipe.resize_linear_u8(got, w, h)) == e["resize_sha256"], name
        assert (w, h) == tpipe.rescale_size(*jpeg.jpeg_size(path), (1000, 600))[:2]


# --- 2. the resize -----------------------------------------------------------------

def _mini(w, h):
    return tpipe.rescale_size(w, h, (250, 120))[:2]


RESIZE_CASES = [
    # (src h, src w) -> (dst w, dst h); VOC sizes to the default (1000, 600)
    ((375, 500), (800, 600)), ((500, 375), (600, 800)), ((333, 500), (901, 600)),
    ((500, 333), (600, 901)), ((281, 500), (600, 338)), ((480, 640), (800, 600)),
    # downscales, and --mini's img_scale (250, 120)
    ((300, 400), (160, 120)), ((375, 500), _mini(500, 375)), ((500, 375), _mini(375, 500)),
    ((247, 311), _mini(311, 247)), ((399, 301), _mini(301, 399)),
    # odd and tiny shapes, exact 2x down, the identity
    ((17, 29), (70, 40)), ((1, 1), (5, 5)), ((7, 5), (2, 3)), ((100, 100), (53, 37)),
    ((64, 96), (48, 32)), ((33, 47), (47, 33)),
]


@pytest.mark.parametrize("src,dst", RESIZE_CASES, ids=[f"{s[1]}x{s[0]}-{d[0]}x{d[1]}"
                                                       for s, d in RESIZE_CASES])
def test_resize_bit_equal_to_cv2(src, dst):
    img = _image(*src, seed=src[0], smooth=False)
    want = cv2.resize(img, dst, interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(tpipe.resize_linear_u8(img, *dst), want)


def test_resize_refuses_float_images():
    with pytest.raises(TypeError):
        tpipe.resize_linear_u8(np.zeros((4, 4, 3), np.float32), 8, 8)


# --- 3. against the JAX package --------------------------------------------------------

@pytest.mark.parametrize("device_normalize", [False, True])
def test_prepare_sample_matches_jax(device_normalize):
    for seed, (h, w) in enumerate([(375, 500), (500, 333), (211, 307)]):
        img = _image(h, w, seed=seed, smooth=False)
        rng = np.random.RandomState(seed)
        xy = rng.uniform(0, min(h, w) / 2, (4, 2))
        ann = {"bboxes": np.concatenate([xy, xy + rng.uniform(5, 60, (4, 2))], 1)
               .astype(np.float32), "labels": rng.randint(0, 20, 4)}
        for flip in (None, True, False):
            kw = dict(img_scale=(1000, 600), canvas=(608, 1024),
                      device_normalize=device_normalize)
            want = jpipe.prepare_sample(img, {k: v.copy() for k, v in ann.items()},
                                        JPipelineConfig(**kw), rng=np.random.RandomState(seed),
                                        flip=flip)
            got = tpipe.prepare_sample(img, {k: v.copy() for k, v in ann.items()},
                                       tpipe.PipelineConfig(**kw),
                                       rng=np.random.RandomState(seed), flip=flip)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
                assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    assert tpipe.rescale_size(500, 375, (1000, 600)) == jpipe.rescale_size(500, 375, (1000, 600))


@pytest.fixture(scope="module")
def voc_tree(tmp_path_factory):
    """Two make_voc years; in VOC2012 one annotation lacks <size>."""
    root = str(tmp_path_factory.mktemp("tvoc"))
    b07, l07, ids07 = make_voc(root, "VOC2007", n=6, seed=0)
    b12, l12, ids12 = make_voc(root, "VOC2012", n=3, seed=5)
    xml = os.path.join(b12, "Annotations", f"{ids12[1]}.xml")
    with open(xml) as f:
        text = f.read()
    start, end = text.index("<size>"), text.index("</size>") + len("</size>")
    with open(xml, "w") as f:
        f.write(text[:start] + text[end:])
    return (b07, l07), (b12, l12)


def _ann_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k


def test_voc_dataset_matches_jax(voc_tree):
    pytest.importorskip("PIL")  # the JAX package reads a size-less image with PIL
    (b07, l07), (b12, l12) = voc_tree
    for kw in (dict(), dict(test_mode=True), dict(min_size=30)):
        j = [JVOCDataset(l07, b07, **kw), JVOCDataset(l12, b12, **kw)]
        t = [VOCDataset(l07, b07, **kw), VOCDataset(l12, b12, **kw)]
        for jd, td in zip(j, t):
            assert td.img_ids == jd.img_ids
            for i in range(len(jd)):
                assert td.img_path(i) == jd.img_path(i)
                assert td.image_size(i) == jd.image_size(i)
                assert td.aspect_flag(i) == jd.aspect_flag(i)
                _ann_equal(td.get_ann_info(i), jd.get_ann_info(i))
        jc, tc = JConcatVOC(j), ConcatVOC(t)
        assert len(tc) == len(jc)
        for i in range(len(jc)):
            assert (tc.img_path(i), tc.image_size(i), tc.aspect_flag(i)) == \
                (jc.img_path(i), jc.image_size(i), jc.aspect_flag(i))
            _ann_equal(tc.get_ann_info(i), jc.get_ann_info(i))


def _pools(voc_tree):
    (b07, l07), _ = voc_tree
    return JVOCDataset(l07, b07), VOCDataset(l07, b07)


def _mini_pipes(device_normalize=True):
    kw = dict(img_scale=(250, 120), canvas=ttiny().canvas, device_normalize=device_normalize)
    return JPipelineConfig(**kw), tpipe.PipelineConfig(**kw)


def _batches_equal(got, want):
    assert len(got) == len(want)
    for (go, gb), (wo, wb) in zip(got, want):
        assert go == wo
        assert gb._fields == wb._fields
        for name, g, w in zip(wb._fields, gb, wb):
            np.testing.assert_array_equal(g, w, err_msg=name)
            assert g.dtype == w.dtype, name


@pytest.mark.parametrize("num_workers", [0, 4])
def test_train_loader_matches_jax(voc_tree, num_workers):
    """Two epochs of the same seed: the same batches, bit for bit (three
    images repeated twice without workers, all six once with them)."""
    jds, tds = _pools(voc_tree)
    jp, tp = _mini_pipes(device_normalize=num_workers == 0)
    idx = np.arange(len(jds)) if num_workers else np.arange(3)
    repeat = 1 if num_workers else 2
    jl = JTrainLoader(jds, idx, jtiny(), jp, batch_size=2, repeat=repeat, seed=7,
                      num_workers=num_workers)
    tl = TrainLoader(tds, idx, ttiny(), tp, batch_size=2, repeat=repeat, seed=7,
                     num_workers=num_workers)
    assert len(tl) == len(jl)
    for _ in range(2):
        _batches_equal(list(tl), list(jl))
    assert tl.rng.randint(0, 2 ** 31 - 1) == jl.rng.randint(0, 2 ** 31 - 1)


def test_burn_epochs_replays_the_stream(voc_tree):
    _, tds = _pools(voc_tree)
    _, tp = _mini_pipes()
    idx = np.arange(4)
    fresh = TrainLoader(tds, idx, ttiny(), tp, batch_size=2, seed=3, prefetch=False)
    fresh.burn_epochs(1)  # no decode
    burned = list(fresh)
    ref = TrainLoader(tds, idx, ttiny(), tp, batch_size=2, seed=3, prefetch=False)
    list(ref)
    _batches_equal(burned, list(ref))


def test_loader_options_of_other_families_raise(voc_tree):
    """The options of families the port does not have raise (augment_fn,
    the SSD chain's, is ported: tests/test_torch_ssd_data.py; Fast
    R-CNN's proposal_source: tests/test_torch_rpn_fast_rcnn.py)."""
    _, tds = _pools(voc_tree)
    _, tp = _mini_pipes()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TrainLoader(tds, [0], ttiny(), tp, batch_size=2, with_masks=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EvalLoader(tds, [0], tp, batch_size=2, transform_fn=lambda img, i: img)


def _eval_batches(loader):
    return [(o, b, i) for o, b, i in loader]


@pytest.mark.parametrize("cached", [False, True])
def test_eval_loader_matches_jax(voc_tree, tmp_path, cached):
    """The sweep, without and with the canvas cache (a cold sweep that
    fills it, then a warm one that reads it back)."""
    jds, tds = _pools(voc_tree)
    jp, tp = _mini_pipes()
    idx = np.arange(len(jds))[::-1]
    want = _eval_batches(JEvalLoader(jds, idx, jp, batch_size=4))
    cache = tcache.open_canvas_cache(str(tmp_path / "cache"), tds, tp) if cached else None
    for sweep in range(2 if cached else 1):
        got = _eval_batches(EvalLoader(tds, idx, tp, batch_size=4, cache=cache))
        _batches_equal([(o, b) for o, b, _ in got], [(o, b) for o, b, _ in want])
        for (_, _, gi), (_, _, wi) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
    if cached:
        assert cache.n_filled == len(tds)


def test_canvas_cache_roundtrip_and_fingerprint(voc_tree, tmp_path):
    jds, tds = _pools(voc_tree)
    jp, tp = _mini_pipes()
    assert tcache._fingerprint(tds, tp) == jcache._fingerprint(jds, jp)
    d = str(tmp_path / "c")
    cache = tcache.CanvasCache(d, tds, tp)
    img = jpeg.imread(tds.img_path(2))
    sample = tpipe.prepare_sample(img, None, tp, flip=False)
    assert cache.get(2) is None
    cache.put(2, sample)
    got = cache.get(2)
    for k in ("image", "img_shape", "pad_shape", "scale_factor", "flipped", "orientation"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(sample[k]), err_msg=k)
    # reopened with the same pipeline: still filled; with another: rebuilt
    assert tcache.CanvasCache(d, tds, tp).n_filled == 1
    other = tpipe.PipelineConfig(img_scale=(240, 120), canvas=tp.canvas, device_normalize=True)
    assert tcache._fingerprint(tds, other) != tcache._fingerprint(tds, tp)
    assert tcache.CanvasCache(d, tds, other).n_filled == 0
    with pytest.raises(ValueError):
        tcache.CanvasCache(d, tds, tpipe.PipelineConfig())
    assert tcache.open_canvas_cache(None, tds, tp) is None


def _split_calls(m):
    """Every splits function on seeded inputs with exact-zero ties; returns
    the outputs and the RNG's state after."""
    rng = np.random.RandomState(11)
    out = [m.init_split(40, 6, rng), m.init_split_disjoint(40, 6, rng),
           m.init_split_all(40, rng), m.init_split_double(40, 6, rng)]
    unc = np.random.RandomState(3).rand(40)
    unc[::3] = 0.0  # exact zeros, as HUA emits
    unc[5], unc[7] = unc[9], unc[9]  # ties
    mconf = np.random.RandomState(4).rand(40)
    x_all = np.random.RandomState(2).permutation(40)
    x_l = np.sort(x_all[:6])
    for zero_rate in (0.0, 0.15, 0.5, 1.0):
        out.append(m.update_labeled_set(unc, x_all, x_l, 8, rng, zero_rate=zero_rate))
    for use in ("min", "max"):
        out.append(m.update_labeled_set(unc, x_all, x_l, 8, rng, zero_rate=0.5,
                                        max_conf=mconf, use_max_conf=use))
    out.append(m.update_labeled_set(np.ones(40), x_all, x_l, 8, rng, zero_rate=0.5))
    out.append(m.update_labeled_set_reselect(unc, x_all, x_l, 5, rng))
    out.append(m.update_labeled_set_plain(unc, x_all, x_l, 5, rng))
    return out, rng.get_state()


def test_splits_match_jax(tmp_path):
    want, want_state = _split_calls(jsplits)
    got, got_state = _split_calls(tsplits)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    for a, b in zip(got_state, want_state):
        np.testing.assert_array_equal(a, b)
    x_l, x_u, unc = np.arange(4), np.arange(4, 9), np.linspace(0, 1, 9)
    tsplits.save_cycle_state(str(tmp_path / "t"), 2, x_l, x_u, unc)
    jsplits.save_cycle_state(str(tmp_path / "j"), 2, x_l, x_u, unc)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    for a, b in zip(tsplits.load_cycle_state(str(tmp_path / "t"), 2), (x_l, x_u)):
        np.testing.assert_array_equal(a, b)
    assert tsplits.load_cycle_state(str(tmp_path / "t"), 3) is None
