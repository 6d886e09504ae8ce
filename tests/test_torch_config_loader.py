"""The port's reference-config loader (aod_meh_hua_torch/utils/config.py
load_reference_config, reference_data_roots: a copy of JAX
utils/config.py:2297-2510) held equal to the JAX package's, and the
AL CLIs' --config (tools/train_retinanet.py, tools/train_ssd.py) and the
print_config tool that read it, on the CPU.

Both loaders run on the same files: the repo's configs/retinanet_voc.py
and configs written here in a temporary directory (an SSD config, a
RetinaNet one with an unknown key, a warmup and several lr steps, and
configs each loader must refuse). The dataclasses they return are
compared field by field (dataclasses.asdict equal), the warnings by
their text, the refusals by their exception type.
"""

import dataclasses
import warnings

import pytest

from aod_meh_hua_tpu.utils import config as jcfg
from aod_meh_hua_torch.al import loop as tloop
from aod_meh_hua_torch.tools import print_config, train_retinanet, train_ssd
from aod_meh_hua_torch.utils import config as tcfg
from torch_parity import numerics_flags_kept

REPO_CONFIG = "configs/retinanet_voc.py"

SSD_CONFIG = """
uncertainty_pool = "Entropy_ALL"
uncertainty_type = "Aleatoric"
input_size = 300
model = dict(
    type="SSL_L_SSD",
    neck=dict(out_channels=(512, 1024, 512, 256, 256, 256), level_strides=(2, 2, 1, 1),
              level_paddings=(1, 1, 0, 0), l2_norm_scale=20),
    bbox_head=dict(num_classes=20,
                   anchor_generator=dict(input_size=300, basesize_ratio_range=(0.15, 0.9),
                                         strides=[8, 16, 32, 64, 100, 300],
                                         ratios=[[2], [2, 3], [2, 3], [2, 3], [2], [2]]),
                   bbox_coder=dict(target_means=[0.0] * 4, target_stds=[0.1, 0.1, 0.2, 0.2])),
    train_cfg=dict(assigner=dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.0,
                                 gt_max_assign_all=False),
                   smoothl1_beta=1.0, neg_pos_ratio=3),
    test_cfg=dict(nms_pre=1000, nms=dict(type="nms", iou_threshold=0.45), score_thr=0.02,
                  max_per_img=200),
)
optimizer = dict(type="SGD", lr=2e-3, momentum=0.9, weight_decay=5e-4)
optimizer_config = dict(grad_clip=None)
lr_config = dict(policy="step", warmup="linear", warmup_iters=500, warmup_ratio=0.001,
                 step=[1])
data_root = "/data/VOCdevkit/"
data = dict(samples_per_gpu=8, train=dict(type="RepeatDataset", times=16))
X_L_0_size = 1000
X_S_size = 1000
X_L_repeat = 16
X_U_repeat = 16
cycles = [0, 1, 2]
epoch_ratio = [5, 1]
outer_epoch = 2
evaluation = dict(interval=2)
"""

RETINA_EXTRA = """
model = dict(type="SSL_L_RetinaNet", backbone=dict(frozen_stages=2),
             bbox_head=dict(num_classes=20, loss_cls=dict(type="FocalLoss", gamma=1.5,
                                                          alpha=0.3)))
optimizer = dict(type="SGD", lr=0.01)
optimizer_config = dict(grad_clip=dict(max_norm=35, norm_type=2))
lr_config = dict(policy="step", warmup="linear", warmup_iters=100, step=[2, 3])
data = dict(train=dict(dataset=dict(img_prefix=["/d/VOC2007/", "/d/VOC2012/"])))
my_unknown_key = 3
"""

REFUSED = {
    "optimizer": 'model = dict(type="SSL_L_RetinaNet")\noptimizer = dict(type="Adam")\n',
    "loss": 'model = dict(type="SSL_L_RetinaNet", bbox_head=dict(loss_cls=dict(type="GHM")))\n',
    "family": 'model = dict(type="FasterRCNN")\n',
}


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _load(module, path):
    """(model, train, al as dicts, data roots, warnings' texts) of one loader."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model, train, al, ns = module.load_reference_config(path)
    return ([dataclasses.asdict(c) for c in (model, train, al)], type(model).__name__,
            module.reference_data_roots(ns), [str(w.message) for w in caught])


@pytest.mark.parametrize("which", ["repo_retinanet", "ssd", "retinanet_extra"])
def test_loaders_give_equal_dataclasses(which, tmp_path):
    path = {"repo_retinanet": REPO_CONFIG,
            "ssd": _write(tmp_path, "ssd_cfg.py", SSD_CONFIG),
            "retinanet_extra": _write(tmp_path, "retina_cfg.py", RETINA_EXTRA)}[which]
    got, want = _load(tcfg, path), _load(jcfg, path)
    assert got == want
    kind = {"repo_retinanet": "RetinaNetConfig", "ssd": "SSDConfig",
            "retinanet_extra": "RetinaNetConfig"}[which]
    assert got[1] == kind


def test_both_loaders_warn_on_an_unknown_key(tmp_path):
    path = _write(tmp_path, "retina_cfg.py", RETINA_EXTRA)
    for module in (tcfg, jcfg):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            module.load_reference_config(path)
        assert "load_reference_config: unrecognized top-level key 'my_unknown_key' is " \
            "ignored" in [str(w.message) for w in caught]
    texts = _load(tcfg, path)[3]
    assert any("only the first step epoch" in t for t in texts)


def test_loaded_values_reach_the_dataclasses(tmp_path):
    """A few of the mapped values, read back (the equality above holds
    whatever both packages do; this pins what they do)."""
    (model, train, al), _, roots, _ = _load(tcfg, _write(tmp_path, "ssd_cfg.py", SSD_CONFIG))
    assert (model["test"]["nms_iou_thr"], model["test"]["max_per_img"]) == (0.45, 200)
    assert model["hua"]["pool"] == "Entropy_ALL" and model["hua"]["unc_type"] == "aleatoric"
    assert (train["batch_size"], train["warmup_iters"], train["lr_step_epoch"]) == (8, 500, 1)
    assert (al["cycles"], al["x_l_repeat"], al["eval_interval"]) == ((0, 1, 2), 16, 2)
    assert roots == ("/data/VOCdevkit/VOC2007", "/data/VOCdevkit/VOC2012")
    (model, train, _), _, roots, _ = _load(tcfg, _write(tmp_path, "r.py", RETINA_EXTRA))
    assert (model["cls_loss"], model["frozen_stages"], train["grad_clip"]) == ("focal", 2, 35)
    assert roots == ("/d/VOC2007", "/d/VOC2012")


@pytest.mark.parametrize("case", list(REFUSED))
def test_both_loaders_refuse_the_same_configs(case, tmp_path):
    path = _write(tmp_path, f"{case}.py", REFUSED[case])
    for module in (tcfg, jcfg):
        with pytest.raises(ValueError):
            module.load_reference_config(path)


def _run_cli(cli, argv):
    """The CLI's main with the driver stubbed: the configs it would run."""
    with pytest.MonkeyPatch.context() as mp, numerics_flags_kept():
        mp.setattr(tloop.ALDriver, "run", lambda self, **kw: None)
        mp.setattr(tloop.ALDriver, "__init__", lambda self, m, t, a, p, **kw:
                   self.__dict__.update(cfg=m, tcfg=t, al=a, paths=p, kw=kw))
        return cli.main(argv)


def test_retinanet_cli_takes_the_config(tmp_path):
    """--config sets the model, schedule and AL settings and, without
    --voc07 or --voc12, both data roots; an explicit --voc07 keeps the
    config's VOC2012 root out; --mini still cuts the run."""
    with pytest.raises(SystemExit, match="no data_root in the config"):
        _run_cli(train_retinanet, ["--config", REPO_CONFIG, "--cpu", "--work-dir", "w"])
    d = _run_cli(train_retinanet, ["--config", REPO_CONFIG, "--voc07", "v", "--cpu",
                                   "--work-dir", "w"])
    model, train, al, _ = tcfg.load_reference_config(REPO_CONFIG)
    assert d.cfg == dataclasses.replace(model, hua=train_retinanet.hua_from_args(
        model.hua, train_retinanet.parse_args(["--voc07", "v", "--work-dir", "w"])))
    assert d.tcfg == dataclasses.replace(train, seed=d.tcfg.seed)
    assert d.al == dataclasses.replace(al, zero_rate=d.al.zero_rate)
    assert (d.paths.voc07, d.paths.voc12) == ("v", None)
    path = _write(tmp_path, "r.py", RETINA_EXTRA)
    d = _run_cli(train_retinanet, ["--config", path, "--cpu", "--work-dir", "w"])
    assert (d.paths.voc07, d.paths.voc12) == ("/d/VOC2007", "/d/VOC2012")
    d = _run_cli(train_retinanet, ["--config", path, "--voc07", "mine", "--cpu",
                                   "--work-dir", "w"])
    assert (d.paths.voc07, d.paths.voc12) == ("mine", None)
    assert d.cfg.cls_loss == "focal" and d.tcfg.grad_clip == 35
    d = _run_cli(train_retinanet, ["--config", path, "--mini", "--cpu", "--work-dir", "w"])
    assert d.cfg.canvas == tcfg.tiny_test_config().canvas and d.al.cycles == (0, 1)
    assert d.tcfg.grad_clip == 35 and d.paths.voc07 == "/d/VOC2007"


def test_ssd_cli_takes_the_config(tmp_path):
    path = _write(tmp_path, "ssd_cfg.py", SSD_CONFIG)
    d = _run_cli(train_ssd, ["--config", path, "--cpu", "--work-dir", "w", "--seed", "3"])
    model, train, al, _ = tcfg.load_reference_config(path)
    assert d.cfg.test == model.test and d.cfg.anchor == model.anchor
    assert d.tcfg == dataclasses.replace(train, seed=3, batch_size=d.tcfg.batch_size)
    assert d.al == dataclasses.replace(al, zero_rate=d.al.zero_rate)
    assert (d.paths.voc07, d.paths.voc12) == ("/data/VOCdevkit/VOC2007",
                                              "/data/VOCdevkit/VOC2012")
    with pytest.raises(SystemExit, match="not an SSD config"):
        _run_cli(train_ssd, ["--config", REPO_CONFIG, "--cpu", "--work-dir", "w"])
    with pytest.raises(SystemExit, match="--voc07 is required"):
        _run_cli(train_ssd, ["--config", _write(tmp_path, "bare.py", 'model = dict(type="SSD")\n'),
                             "--cpu", "--work-dir", "w"])


def test_print_config(capsys, tmp_path):
    print_config.main(["--config", REPO_CONFIG])
    out = capsys.readouterr().out
    assert out.count("== ") == 3 and "'x_l_0_size': 827" in out
    print_config.main(["--family", "ssd"])
    assert "'input_size': 300" in capsys.readouterr().out
    print_config.main([])
    assert "'stacked_convs': 4" in capsys.readouterr().out
