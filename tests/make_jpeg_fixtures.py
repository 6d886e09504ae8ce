"""Writes the JPEG fixtures of aod_meh_hua_torch/data/fixtures/ with
OpenCV, and beside them fixtures.json: for each file the sha256 of
cv2.imread(path, IMREAD_COLOR) and of its cv2.resize(INTER_LINEAR) to
the rescale_size((1000, 600)) size, which chip_smoke.py holds the port's
decoder and resize to on a machine without OpenCV.

    python tests/make_jpeg_fixtures.py

The content is smooth and synthetic (gradients, soft discs and bars, a
little seeded noise); the files cover the forms the port's decoder reads.
"""

import hashlib
import json
import os
import sys

import cv2
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from aod_meh_hua_torch.data.pipeline import rescale_size  # noqa: E402

OUT = os.path.join(REPO, "aod_meh_hua_torch", "data", "fixtures")
S = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
     "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
# name, (width, height), quality, sampling, extra imwrite parameters, grey
FIXTURES = [
    ("s420_q75_500x375", (500, 375), 75, "420", [], False),
    ("s420_q95_375x500", (375, 500), 95, "420", [], False),
    ("s422_q75_500x333", (500, 333), 75, "422", [], False),
    ("s444_q95_500x375", (500, 375), 95, "444", [], False),
    ("grey_q75_375x500", (375, 500), 75, "420", [], True),
    ("rst_q75_500x333", (500, 333), 75, "420", [cv2.IMWRITE_JPEG_RST_INTERVAL, 4], False),
    ("opt_q95_375x500", (375, 500), 95, "420", [cv2.IMWRITE_JPEG_OPTIMIZE, 1], False),
    ("s422_q95_500x375", (500, 375), 95, "422", [], False),
]


def synthetic(w, h, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([60 + 120 * x / w, 40 + 150 * y / h, 200 - 100 * (x + y) / (w + h)], -1)
    for _ in range(6):
        cx, cy, r = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(20, 90)
        colour = rng.uniform(0, 255, 3)
        a = np.clip((r - np.hypot(x - cx, y - cy)) / 6.0, 0, 1)[..., None]
        img = img * (1 - a) + colour * a
    for _ in range(3):
        x0, y0 = rng.randint(0, w - 60), rng.randint(0, h - 30)
        img[y0:y0 + rng.randint(10, 30), x0:x0 + rng.randint(30, 60)] = rng.uniform(0, 255, 3)
    img = cv2.GaussianBlur(img, (5, 5), 1.5) + rng.randn(h, w, 3) * 2.0
    return np.clip(img + 0.5, 0, 255).astype(np.uint8)


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main():
    os.makedirs(OUT, exist_ok=True)
    table = {}
    for i, (name, (w, h), q, samp, extra, grey) in enumerate(FIXTURES):
        img = synthetic(w, h, seed=i)
        if grey:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        path = os.path.join(OUT, name + ".jpg")
        cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, q,
                                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, S[samp]] + extra)
        dec = cv2.imread(path, cv2.IMREAD_COLOR)
        nw, nh, _ = rescale_size(w, h, (1000, 600))
        res = cv2.resize(dec, (nw, nh), interpolation=cv2.INTER_LINEAR)
        table[name + ".jpg"] = {"shape": list(dec.shape), "decode_sha256": sha(dec),
                                "resize": [nw, nh], "resize_sha256": sha(res)}
    table = {"made_with": f"OpenCV {cv2.__version__}", "files": table}
    with open(os.path.join(OUT, "fixtures.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
