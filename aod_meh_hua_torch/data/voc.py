"""PASCAL VOC dataset: XML annotation parsing + split files.

A copy of aod_meh_hua_tpu/data/voc.py (`VOC_CLASSES`, `VOCDataset`,
`ConcatVOC`), which mirrors the reference's xml_style.py:29-147
(int(float(coord)) boxes shifted by -1, difficult objects to the ignore
lists, unknown names skipped) and custom.py:163 (the aspect-ratio group
flag). Where an annotation has no <size>, the JAX package opens the JPEG
with PIL (voc.py:82); the machine with the card has no PIL, so the copy
reads the frame header with data/jpeg.py `jpeg_size`.
"""

from __future__ import annotations

import os.path as osp
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence

import numpy as np

from .jpeg import jpeg_size

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


class VOCDataset:
    """One VOC year directory (e.g. .../VOC2007) + an image-id list file."""

    def __init__(
        self,
        ann_file: str,
        img_prefix: str,
        classes: Sequence[str] = VOC_CLASSES,
        test_mode: bool = False,
        min_size: Optional[int] = None,
        filter_empty_gt: bool = True,
    ):
        self.img_prefix = img_prefix
        self.classes = tuple(classes)
        self.cat2label = {c: i for i, c in enumerate(self.classes)}
        self.test_mode = test_mode
        self.min_size = min_size
        with open(ann_file) as f:
            self.img_ids = [l.strip().split()[0] for l in f if l.strip()]
        self._ann_cache: Dict[str, dict] = {}
        self._size_cache: Dict[str, tuple] = {}
        if not test_mode:
            self.img_ids = [
                i for i in self.img_ids if self._keep(i, filter_empty_gt)
            ]

    def __len__(self):
        return len(self.img_ids)

    def img_path(self, idx: int) -> str:
        return osp.join(self.img_prefix, "JPEGImages", f"{self.img_ids[idx]}.jpg")

    def _xml_root(self, img_id: str):
        return ET.parse(osp.join(self.img_prefix, "Annotations", f"{img_id}.xml")).getroot()

    def _keep(self, img_id: str, filter_empty_gt: bool) -> bool:
        w, h = self.image_size_by_id(img_id)
        if min(w, h) < 32:
            return False
        if not filter_empty_gt:
            return True
        root = self._xml_root(img_id)
        return any(
            obj.find("name").text in self.cat2label for obj in root.findall("object")
        )

    def image_size_by_id(self, img_id: str):
        if img_id not in self._size_cache:
            root = self._xml_root(img_id)
            size = root.find("size")
            if size is not None:
                w = int(size.find("width").text)
                h = int(size.find("height").text)
            else:
                w, h = jpeg_size(osp.join(self.img_prefix, "JPEGImages", f"{img_id}.jpg"))
            self._size_cache[img_id] = (w, h)
        return self._size_cache[img_id]

    def image_size(self, idx: int):
        return self.image_size_by_id(self.img_ids[idx])

    def get_ann_info(self, idx: int) -> dict:
        img_id = self.img_ids[idx]
        if img_id in self._ann_cache:
            return self._ann_cache[img_id]
        root = self._xml_root(img_id)
        bboxes, labels, bboxes_ig, labels_ig = [], [], [], []
        for obj in root.findall("object"):
            name = obj.find("name").text
            if name not in self.cat2label:
                continue
            label = self.cat2label[name]
            difficult = obj.find("difficult")
            difficult = 0 if difficult is None else int(difficult.text)
            bb = obj.find("bndbox")
            box = [
                int(float(bb.find("xmin").text)), int(float(bb.find("ymin").text)),
                int(float(bb.find("xmax").text)), int(float(bb.find("ymax").text)),
            ]
            ignore = False
            if self.min_size:
                w, h = box[2] - box[0], box[3] - box[1]
                ignore = w < self.min_size or h < self.min_size
            if difficult or ignore:
                bboxes_ig.append(box)
                labels_ig.append(label)
            else:
                bboxes.append(box)
                labels.append(label)
        ann = dict(
            bboxes=(np.array(bboxes, np.float32).reshape(-1, 4) - 1
                    if bboxes else np.zeros((0, 4), np.float32)),
            labels=np.array(labels, np.int64) if labels else np.zeros((0,), np.int64),
            bboxes_ignore=(np.array(bboxes_ig, np.float32).reshape(-1, 4) - 1
                           if bboxes_ig else np.zeros((0, 4), np.float32)),
            labels_ignore=(np.array(labels_ig, np.int64)
                           if labels_ig else np.zeros((0,), np.int64)),
        )
        self._ann_cache[img_id] = ann
        return ann

    def aspect_flag(self, idx: int) -> int:
        """Group flag: 1 if width / height > 1 (custom.py:163)."""
        w, h = self.image_size(idx)
        return int(w / h > 1)


class ConcatVOC:
    """VOC07+12 concatenation: global index -> (dataset, local index).

    Mirrors the reference's ConcatDataset of the two trainval year splits
    (Config_RetinaNet.py:133-139): indices below len(d0) are year-07.
    """

    def __init__(self, datasets: List[VOCDataset]):
        self.datasets = datasets
        self.offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def _locate(self, idx: int):
        d = int(np.searchsorted(self.offsets, idx, side="right")) - 1
        return self.datasets[d], idx - int(self.offsets[d])

    def img_path(self, idx: int) -> str:
        ds, i = self._locate(idx)
        return ds.img_path(i)

    def get_ann_info(self, idx: int) -> dict:
        ds, i = self._locate(idx)
        return ds.get_ann_info(i)

    def image_size(self, idx: int):
        ds, i = self._locate(idx)
        return ds.image_size(i)

    def aspect_flag(self, idx: int) -> int:
        ds, i = self._locate(idx)
        return ds.aspect_flag(i)
