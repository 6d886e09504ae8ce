"""Real torch checkpoint FORMAT roundtrips (VERDICT r3 directive #5).

The converters were previously exercised only on synthetic dict trees;
the actual serialized artifact the parity-day run will load — a
zip-serialized (torch >= 1.6) or legacy-serialized (torch 1.5, the
reference's pinned version, README.md:16-27) `.pth` file — was never
read in CI. torch (cpu) is available in this image, so these tests
write REAL checkpoints through torch.save in both wire formats plus
the mmcv-style {'state_dict': ..., 'meta': ...} wrapper the reference's
CheckpointHook produces, and roundtrip them through
models/pretrained.load_torch_state_dict -> the converters.

Reference load sites matched:
* tools/train_RetinaNet.py:170 load_checkpoint(map_location='cpu')
* tools/train_RetinaNet.py:213-219 raw torch.save(state_dict) snapshots
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import flax.core

from aod_meh_hua_tpu.models import init_retinanet
from aod_meh_hua_tpu.models.pretrained import (
    attach_pretrained_backbone, load_torch_state_dict)
from aod_meh_hua_tpu.models.reference_convert import (
    convert_reference_retinanet, export_reference_retinanet)
from aod_meh_hua_tpu.utils.config import tiny_test_config
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

CFG = tiny_test_config()


def _tiny_torchvision_sd(rng):
    """A torchvision-resnet-grammar state dict matching the tiny config
    geometry (block_counts (1,1,1,1), stem 8)."""
    sd = {}

    def conv(name, cout, cin, k):
        sd[name + ".weight"] = rng.randn(cout, cin, k, k).astype(np.float32)

    def bn(name, c):
        sd[name + ".weight"] = rng.rand(c).astype(np.float32) + 0.5
        sd[name + ".bias"] = rng.randn(c).astype(np.float32)
        sd[name + ".running_mean"] = rng.randn(c).astype(np.float32)
        sd[name + ".running_var"] = rng.rand(c).astype(np.float32) + 0.5
        sd[name + ".num_batches_tracked"] = np.asarray(100, np.int64)

    w = CFG.stem_width
    conv("conv1", w, 3, 7)
    bn("bn1", w)
    cin = w
    for stage in range(4):
        planes = w * (2 ** stage)
        conv(f"layer{stage + 1}.0.conv1", planes, cin, 1)
        bn(f"layer{stage + 1}.0.bn1", planes)
        conv(f"layer{stage + 1}.0.conv2", planes, planes, 3)
        bn(f"layer{stage + 1}.0.bn2", planes)
        conv(f"layer{stage + 1}.0.conv3", planes * 4, planes, 1)
        bn(f"layer{stage + 1}.0.bn3", planes * 4)
        conv(f"layer{stage + 1}.0.downsample.0", planes * 4, cin, 1)
        bn(f"layer{stage + 1}.0.downsample.1", planes * 4)
        cin = planes * 4
    sd["fc.weight"] = rng.randn(10, cin).astype(np.float32)  # dropped
    sd["fc.bias"] = rng.randn(10).astype(np.float32)
    return sd


def _save(sd_np, path, fmt):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in sd_np.items()}
    if fmt == "zip":
        torch.save(t, path)
    elif fmt == "legacy":
        # the wire format torch 1.5 (the reference env) writes
        torch.save(t, path, _use_new_zipfile_serialization=False)
    elif fmt == "mmcv_wrapper":
        torch.save({"state_dict": t, "meta": {"mmdet_version": "2.13.0"}},
                   path)
    else:
        raise ValueError(fmt)


@pytest.mark.parametrize("fmt", ["zip", "legacy", "mmcv_wrapper"])
def test_torchvision_pth_roundtrip(tmp_path, fmt):
    """Real .pth -> load_torch_state_dict -> attach_pretrained_backbone:
    the exact parity-day pretrained-R50 input path."""
    rng = np.random.RandomState(0)
    sd = _tiny_torchvision_sd(rng)
    p = str(tmp_path / f"r50_{fmt}.pth")
    _save(sd, p, fmt)

    loaded = load_torch_state_dict(p)
    assert set(loaded) == set(sd)
    np.testing.assert_array_equal(loaded["conv1.weight"], sd["conv1.weight"])

    _, variables = init_retinanet(CFG, jax.random.PRNGKey(0))
    variables = flax.core.unfreeze(variables)
    new_vars = attach_pretrained_backbone(variables, p,
                                          block_counts=CFG.block_counts)
    got = np.asarray(new_vars["params"]["backbone"]["conv1"]["kernel"])
    want = np.transpose(sd["conv1.weight"], (2, 3, 1, 0))  # OIHW -> HWIO
    np.testing.assert_array_equal(got, want)
    got_var = np.asarray(
        new_vars["batch_stats"]["backbone"]["layer3_0"]["bn2"]["var"])
    np.testing.assert_array_equal(got_var, sd["layer3.0.bn2.running_var"])


@pytest.mark.parametrize("fmt", ["zip", "legacy"])
def test_reference_cycle_snapshot_pth_roundtrip(tmp_path, fmt):
    """The reference's `*_mycode.pth` cycle snapshot (raw state_dict,
    train_RetinaNet.py:213-219) written as a REAL torch file, then
    through the reference2jax conversion path bit-exactly."""
    cfg = tiny_test_config()
    _, variables = init_retinanet(cfg, jax.random.PRNGKey(1))
    variables = jax.tree.map(np.asarray, flax.core.unfreeze(variables))
    ref_sd = export_reference_retinanet(variables, stacked_convs=1)
    p = str(tmp_path / f"cycle_{fmt}.pth")
    _save(ref_sd, p, fmt)

    back, leftover = convert_reference_retinanet(
        load_torch_state_dict(p), stacked_convs=1,
        block_counts=cfg.block_counts)
    assert leftover == []

    def eq(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                eq(a[k], b[k], path + "/" + str(k))
            else:
                np.testing.assert_array_equal(
                    np.asarray(a[k]), np.asarray(b[k]), err_msg=path + str(k))

    eq(variables["params"], back["params"])
    eq(variables["batch_stats"], back["batch_stats"])
