"""Package exported detector programs into one deployable archive.

Port of tools/deployment/package_model.py of the JAX package (`package`,
`load_archive`, `main`, :32-158; after the reference's
tools/deployment/mmdet2torchserve.py, which zips a MANIFEST with the
model files into a TorchServe .mar). The deployable unit here is the
torch.export program of export_model.py, weights inside; the archive is
a tar of that program (and a portrait one) with a MANIFEST.json: model
name, version, family, score threshold, class names and the `geometry`
block (canvas, resize rule, batch, normalisation, class count), so that
a serving host (serve.py ArchiveDetector) preprocesses without the
model's config. Every exported family packages alike, the two-stage
ones (Faster, Cascade, Dynamic and Double-Head R-CNN) as the dense ones:
the geometry is the family's default pipeline, as JAX :130-145 takes it.

    python -m aod_meh_hua_torch.tools.deployment.package_model det.pt2 \\
        --output-folder model_store --model-name retinanet_meh \\
        [--artifact-portrait p.pt2] [--family retinanet|cascade_rcnn|...] \\
        [--model-version 1.0] [--score-thr 0.5] [--batch 8] [--force]
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os
import tarfile
from typing import Optional, Sequence

from .export_model import EXPORTED_FAMILIES, config_for, load_program

ARTIFACTS = {"landscape": "model.pt2", "portrait": "model_portrait.pt2"}


def package(artifact: str, output_folder: str, model_name: str,
            family: str = "retinanet", model_version: str = "1.0",
            score_thr: float = 0.5, artifact_portrait: Optional[str] = None,
            classes=None, geometry: Optional[dict] = None, force: bool = False) -> str:
    """Write {output_folder}/{model_name}.tar; returns its path. Refuses
    to overwrite an archive without `force` (mmdet2torchserve.py:41-43)."""
    os.makedirs(output_folder, exist_ok=True)
    out = os.path.join(output_folder, f"{model_name}.tar")
    if os.path.exists(out) and not force:
        raise FileExistsError(f"{out} exists; pass --force to overwrite")
    manifest = {
        "model_name": model_name,
        "model_version": model_version,
        "family": family,
        "score_thr": score_thr,
        "runtime": "torch.export",
        "artifacts": {"landscape": ARTIFACTS["landscape"]},
        "classes": list(classes) if classes is not None else None,
    }
    if artifact_portrait:
        manifest["artifacts"]["portrait"] = ARTIFACTS["portrait"]
    if geometry:
        manifest["geometry"] = geometry
    with tarfile.open(out, "w") as tf:
        blob = json.dumps(manifest, indent=2).encode()
        info = tarfile.TarInfo("MANIFEST.json")
        info.size = len(blob)
        tf.addfile(info, io.BytesIO(blob))
        tf.add(artifact, arcname=ARTIFACTS["landscape"])
        if artifact_portrait:
            tf.add(artifact_portrait, arcname=ARTIFACTS["portrait"])
    return out


def load_archive(path: str):
    """Read an archive back: (manifest, {orientation: ExportedProgram}).
    Importing export_model registers what the programs need (the fused
    operator, EvalBatch and NMSResult), as the JAX function registers its
    namedtuples before it deserialises."""
    programs = {}
    with tarfile.open(path, "r") as tf:
        manifest = json.loads(tf.extractfile("MANIFEST.json").read())
        for orientation, member in manifest["artifacts"].items():
            programs[orientation] = load_program(io.BytesIO(tf.extractfile(member).read()))
    return manifest, programs


def geometry_for(cfg, batch: int, mini: bool = False) -> dict:
    """The manifest's geometry block: the pipeline the program's canvases
    come from (the tiny one with `mini`), normalised on the host."""
    from ...api import _default_pipeline
    from ...data.pipeline import PipelineConfig

    pipe = (PipelineConfig(img_scale=(250, 120), canvas=cfg.canvas)
            if mini else _default_pipeline(cfg))
    # exported programs are traced on float32 canvases (export_model.py)
    pipe = dataclasses.replace(pipe, device_normalize=False)
    return {
        "canvas": list(pipe.canvas), "img_scale": list(pipe.img_scale),
        "keep_ratio": pipe.keep_ratio, "batch": batch,
        "mean": list(pipe.mean), "std": list(pipe.std),
        "to_rgb": pipe.to_rgb, "flip_ratio": 0.0,
        "num_fg_classes": cfg.num_fg_classes,
    }


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description="Package exported detector into one archive")
    ap.add_argument("artifact", help="exported .pt2 (export_model.py)")
    ap.add_argument("--artifact-portrait", default=None)
    ap.add_argument("--output-folder", required=True)
    ap.add_argument("--model-name", default=None,
                    help="default: artifact basename (mmdet2torchserve uses the checkpoint stem)")
    ap.add_argument("--model-version", default="1.0")
    ap.add_argument("--family", default="retinanet", choices=sorted(EXPORTED_FAMILIES))
    ap.add_argument("--score-thr", type=float, default=0.5)
    ap.add_argument("--voc-classes", action="store_true",
                    help="embed the VOC class list in the manifest")
    ap.add_argument("--batch", type=int, default=1,
                    help="batch size the artifact was exported with")
    ap.add_argument("--mini", action="store_true", help="tiny-config geometry (smoke/test mode)")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    classes = None
    if args.voc_classes:
        from ...data.voc import VOC_CLASSES

        classes = VOC_CLASSES
    cfg = config_for(args.family, args.mini)
    name = args.model_name or os.path.splitext(os.path.basename(args.artifact))[0]
    out = package(args.artifact, args.output_folder, name, family=args.family,
                  model_version=args.model_version, score_thr=args.score_thr,
                  artifact_portrait=args.artifact_portrait, classes=classes,
                  geometry=geometry_for(cfg, args.batch, args.mini), force=args.force)
    print(f"packaged -> {out} ({os.path.getsize(out) / 1e6:.1f} MB)")
    return out


if __name__ == "__main__":
    main()
