"""Checkpoint interchange, on the CPU: the port reads the JAX package's
flax-msgpack checkpoints (aod_meh_hua_torch/engine/flax_msgpack.py, its
own decoder; engine/checkpoint.py) and the reference's mmdet-named .pth
files (models/reference_convert.py), for both families, and hands its
SSD weights back to the JAX package.

Tolerances: weights and momentum carried over bit for bit; head outputs
to 1e-4 of their scale (f32 convolutions summed in another order); one
SGD step from a JAX train state to one f32 ulp of each parameter's
scale (torch's SGD and the JAX package's optax chain compute
buf = mu * buf + (g + wd * p), p -= lr * buf); the msgpack decoder
equal to msgpack.unpackb.
"""

import os

import flax.serialization as fser
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from aod_meh_hua_tpu.engine import checkpoint as jckpt
from aod_meh_hua_tpu.engine.train import create_train_state as jcreate_train_state
from aod_meh_hua_tpu.models import reference_convert as jref
from aod_meh_hua_tpu.utils import config as jcfg
from aod_meh_hua_torch.al import loop as tloop
from aod_meh_hua_torch.engine import checkpoint as tckpt
from aod_meh_hua_torch.engine.flax_msgpack import MsgpackError, msgpack_restore, unpackb
from aod_meh_hua_torch.models import reference_convert as tref
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.models.detector import build_retinanet
from aod_meh_hua_torch.models.ssd_detector import build_ssd
from aod_meh_hua_torch.utils import config as tcfg

from test_data import make_voc
from torch_parity import THIN_SSD, TINY, jax_retinanet, jax_ssd, tf32_off
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture(autouse=True, scope="module")
def _tf32_off():
    with tf32_off():
        yield


def _family(family):
    """(JAX model, variables, port config, an input batch) of a tiny
    model of `family`."""
    rng = np.random.RandomState(3)
    if family == "ssd":
        jm, v = jax_ssd(seed=2)
        x = (rng.randn(2, 300, 300, 3) * 60).astype(np.float32)
        return jm, v, tcfg.SSDConfig(**THIN_SSD), x
    jm, v = jax_retinanet(seed=2, **TINY)
    cfg = tcfg.tiny_test_config(**TINY)
    x = rng.randn(2, *cfg.canvas, 3).astype(np.float32)
    return jm, v, cfg, x


def _port_model(cfg, sd):
    model = (build_ssd if cfg.family == "ssd" else build_retinanet)(cfg, device="cpu")
    model.load_state_dict(sd)
    return model


def _assert_outputs_equal(jm, v, model, x):
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for w, g in zip(want, got):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("family", ["retinanet", "ssd"])
def test_jax_cycle_checkpoint_loads_into_the_port(family, tmp_path):
    """A JAX save_cycle_checkpoint file ({params, batch_stats} in
    flax-msgpack) read by the port: the weights bit for bit and the head
    outputs equal to the JAX model's."""
    jm, v, cfg, x = _family(family)
    path = jckpt.save_cycle_checkpoint(str(tmp_path), "m", 0, 1, v)
    assert tckpt.sniff_format(path) == "msgpack"
    sd = tckpt.load_model_state_dict(path, family)
    for k, t in from_jax_variables(v).items():
        assert torch.equal(sd[k], t), k
    _assert_outputs_equal(jm, v, _port_model(cfg, sd), x)


@pytest.mark.parametrize("family", ["retinanet", "ssd"])
def test_load_cycle_reads_a_jax_work_dir(family, tmp_path):
    """--load-cycle through the port's driver on a JAX model_save dir:
    the cycle's fresh model is replaced by the JAX checkpoint's weights
    (training stubbed, one cycle, no sweep)."""
    jm, v, cfg, _ = _family(family)
    base, _, _ = make_voc(str(tmp_path / "voc"), "VOC2007", n=4, seed=1)
    work = tmp_path / "work"
    name = "ssd_meh" if family == "ssd" else "retinanet_meh"
    jckpt.save_cycle_checkpoint(str(work / "model_save"), name, 3, 1, v)
    driver = tloop.ALDriver(cfg, tcfg.TrainConfig(outer_epoch=1, epoch_ratio=(1,)),
                            tcfg.ALConfig(cycles=(0,), x_l_0_size=2),
                            tloop.ALPaths(voc07=base, voc12=None, work_dir=str(work)),
                            validate=False, name=name, log=None, device="cpu",
                            cache_dir=None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tloop.ALDriver, "_train_run", lambda self, *a, **k: None)
        driver.run(load_cycle=3)
    want = from_jax_variables(v)
    got = driver.model.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _jax_train_state(seed=0):
    """A JAX TrainState of the tiny RetinaNet (stem and layer1 frozen)
    at step 7 with a random momentum trace."""
    jm, v = jax_retinanet(seed=seed, **TINY)
    state, tx = jcreate_train_state(jm, v, jcfg.TrainConfig(lr=0.01), frozen_stages=1)
    rng = np.random.RandomState(seed + 1)
    inner = state.opt_state[0]
    trace_state = inner.inner_state[1]
    trace = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32) * 0.01), state.params)
    inner = inner._replace(inner_state=(inner.inner_state[0], trace_state._replace(trace=trace))
                           + tuple(inner.inner_state[2:]))
    state = state._replace(step=jnp.asarray(7, jnp.int32),
                           opt_state=(inner,) + tuple(state.opt_state[1:]))
    return jm, v, state, tx


def test_jax_train_state_loads_bit_for_bit(tmp_path):
    """A JAX train_state.ckpt + train_state.json: the same step, params,
    BN statistics and momentum (the optax trace), bit for bit."""
    _, _, state, _ = _jax_train_state()
    jckpt.save_train_state(str(tmp_path), state, {"cycle": 1, "run": 0, "epoch": 2,
                                                  "run_iter": 9, "name": "m"})
    got, progress = tckpt.load_train_state(str(tmp_path))
    assert progress["epoch"] == 2 and got["step"] == 7
    want = from_jax_variables({"params": state.params, "batch_stats": state.batch_stats})
    assert set(got["model"]) == set(want)
    for k in want:
        assert torch.equal(got["model"][k], want[k]), k
    trace = from_jax_variables({"params": state.opt_state[0].inner_state[1].trace})
    assert set(got["momentum"]) == set(trace)
    for k in trace:
        assert torch.equal(got["momentum"][k], trace[k]), k


def test_resumed_sgd_step_equals_the_jax_step(tmp_path):
    """The driver's optimizer with the momentum of a JAX train state takes
    one torch SGD step that equals the JAX package's optax step from that
    state with the same gradients (frozen parameters unchanged in both)."""
    jm, v, state, tx = _jax_train_state(seed=4)
    jckpt.save_train_state(str(tmp_path), state, {"cycle": 0, "run": 0, "epoch": 0,
                                                  "run_iter": 1, "name": "m"})
    loaded, _ = tckpt.load_train_state(str(tmp_path))
    cfg = tcfg.tiny_test_config(**TINY)
    base, _, _ = make_voc(str(tmp_path / "voc"), "VOC2007", n=4, seed=1)
    driver = tloop.ALDriver(cfg, tcfg.TrainConfig(lr=0.01), tcfg.ALConfig(x_l_0_size=2),
                            tloop.ALPaths(voc07=base, voc12=None, work_dir=str(tmp_path / "w")),
                            validate=False, log=None, device="cpu", cache_dir=None)
    driver._fresh_model(0)
    driver.model.load_state_dict(loaded["model"])
    driver._set_momentum(loaded["momentum"])

    rng = np.random.RandomState(5)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32)), state.params)
    updates, _ = tx.update(grads, state.opt_state, state.params)
    want = from_jax_variables({"params": optax.apply_updates(state.params, updates)})
    tgrads = from_jax_variables({"params": grads})
    for name, p in driver.model.named_parameters():
        p.grad = tgrads[name].clone()
    driver.optimizer.step()
    got = dict(driver.model.named_parameters())
    for k, w in want.items():
        ulp = float(np.spacing(np.float32(w.abs().max())))
        np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(), rtol=0, atol=ulp,
                                   err_msg=k)
    assert torch.equal(got["backbone.conv1.weight"].detach(), loaded["model"]["backbone.conv1.weight"])


@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("wrapped", [False, True])
def test_reference_retinanet_pth_loads_into_the_port(tmp_path, legacy, wrapped):
    """The JAX package's export_reference_retinanet (mmdet's names) saved
    as torch does (zip or legacy format, raw or in mmcv's {"state_dict",
    "meta"} wrapper) gives the JAX model's outputs in the port; the
    port's own export reads back as what it exported."""
    jm, v, cfg, x = _family("retinanet")
    sd = {k: torch.from_numpy(np.array(a)) for k, a in jref.export_reference_retinanet(
        jax.tree_util.tree_map(np.asarray, v), stacked_convs=cfg.stacked_convs).items()}
    sd["backbone.bn1.num_batches_tracked"] = torch.tensor(0)
    path = str(tmp_path / "ref.pth")
    obj = {"state_dict": sd, "meta": {"epoch": 12}} if wrapped else sd
    torch.save(obj, path, _use_new_zipfile_serialization=not legacy)
    assert tckpt.sniff_format(path) == ("torch_legacy" if legacy else "torch_zip")
    model = _port_model(cfg, tckpt.load_model_state_dict(path, "retinanet"))
    _assert_outputs_equal(jm, v, model, x)

    exported = tref.export_reference_retinanet(model.state_dict())
    assert set(exported) == set(sd) - {"backbone.bn1.num_batches_tracked"}
    back, rest = tref.convert_reference_retinanet(exported)
    assert rest == []
    for k, t in model.state_dict().items():
        assert torch.equal(back[k], t), k


def test_reference_retinanet_unknown_keys_are_reported():
    _, v, _, _ = _family("retinanet")
    sd = {k: torch.from_numpy(np.array(a)) for k, a in jref.export_reference_retinanet(
        jax.tree_util.tree_map(np.asarray, v), stacked_convs=1).items()}
    sd["bbox_head.extra.weight"] = torch.zeros(1)
    _, rest = tref.convert_reference_retinanet(sd)
    assert rest == ["bbox_head.extra.weight"]
    with pytest.raises(KeyError, match="bbox_head.extra.weight"):
        tckpt.to_model_state_dict(sd, "retinanet")


def test_port_ssd_state_dict_is_the_reference_layout(tmp_path):
    """The port's SSD state_dict, fed to the JAX package's
    convert_reference_ssd, gives a JAX model with the port's outputs;
    saved as an mmdet .pth, it loads back with no renaming."""
    jm, v, cfg, x = _family("ssd")
    port = _port_model(cfg, from_jax_variables(v))
    sd = {k: t.numpy() for k, t in port.state_dict().items()}
    jv, rest = jref.convert_reference_ssd(sd)
    assert rest == []
    _assert_outputs_equal(jm, jv, port, x)
    path = str(tmp_path / "ssd.pth")
    torch.save({"state_dict": port.state_dict(), "meta": {}}, path)
    back = tckpt.load_model_state_dict(path, "ssd")
    for k, t in port.state_dict().items():
        assert torch.equal(back[k], t), k


def test_pretrained_vgg_loads_mmcv_names(tmp_path):
    """--pretrained of the SSD CLI: an mmcv VGG16 state_dict (features.N)
    loads into the backbone; a missing conv raises."""
    from aod_meh_hua_torch.tools.train_ssd import attach_pretrained_vgg

    cfg = tcfg.SSDConfig(**THIN_SSD)
    src = build_ssd(cfg, device="cpu", seed=1)
    sd = dict(src.backbone.state_dict())
    path = str(tmp_path / "vgg.pth")
    torch.save(sd, path)
    model = build_ssd(cfg, device="cpu", seed=2)
    attach_pretrained_vgg(model, path)
    for k, t in src.backbone.state_dict().items():
        assert torch.equal(model.backbone.state_dict()[k], t), k
    del sd["features.31.weight"]
    torch.save({"state_dict": sd}, path)
    with pytest.raises(KeyError, match="features.31.weight"):
        attach_pretrained_vgg(model, path)


# --- the msgpack decoder ---------------------------------------------------------

_leaves = (st.none() | st.booleans() | st.integers(-2 ** 63, 2 ** 64 - 1)
           | st.floats(allow_nan=False) | st.text(max_size=40) | st.binary(max_size=70000))
_trees = st.recursive(_leaves, lambda c: st.lists(c, max_size=5)
                      | st.dictionaries(st.text(max_size=8), c, max_size=5), max_leaves=30)


@settings(max_examples=60, deadline=None)
@given(tree=_trees, single=st.booleans())
def test_unpackb_equals_msgpack(tree, single):
    """Maps, arrays, str, bin, ints over the whole int64/uint64 range,
    floats (single and double), nil and bool, at every length class
    (fix, 8, 16, 32 bits)."""
    data = msgpack.packb(tree, use_bin_type=True, use_single_float=single)
    assert unpackb(data) == msgpack.unpackb(data, raw=False, strict_map_key=False)


def test_unpackb_length_classes():
    for n in (15, 16, 255, 256, 65535, 65536):
        for obj in ("x" * n, b"x" * n, list(range(n % 300 + 16)), {str(i): i for i in range(17)},
                    {str(i): i for i in range(70000)} if n == 65536 else [0] * 70000):
            data = msgpack.packb(obj, use_bin_type=True)
            assert unpackb(data) == msgpack.unpackb(data, raw=False)


def test_flax_trees_decode():
    """flax's ndarray (ext 1, every dtype the package writes, bfloat16
    widened exactly), numpy scalar (ext 3) and namedtuple encodings."""
    rng = np.random.RandomState(0)
    tree = {"f32": rng.randn(3, 4).astype(np.float32), "i32": np.arange(6, dtype=np.int32),
            "scalar0d": np.asarray(2.5, np.float32), "u8": np.arange(5, dtype=np.uint8),
            "npscalar": np.float64(1.25), "bool": np.array([True, False]),
            "bf16": jnp.asarray(rng.randn(5), jnp.bfloat16),
            "nt": optax.TraceState(trace={"w": np.ones(2, np.float32)}), "empty": {}}
    got = msgpack_restore(fser.to_bytes(tree))
    want = fser.msgpack_restore(fser.to_bytes(tree))
    for k in ("f32", "i32", "scalar0d", "u8", "bool"):
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert got["npscalar"] == 1.25 and isinstance(got["npscalar"], np.float64)
    np.testing.assert_array_equal(got["bf16"], np.asarray(want["bf16"]).astype(np.float32))
    np.testing.assert_array_equal(got["nt"]["trace"]["w"], np.ones(2, np.float32))
    assert got["empty"] == {}


def test_chunked_arrays_are_joined(monkeypatch):
    """flax splits an array over MAX_CHUNK_SIZE bytes into a chunked map
    (2**30 bytes in practice; lowered here)."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    arr = np.arange(100, dtype=np.float32).reshape(10, 10)
    data = fser.msgpack_serialize({"big": arr, "small": np.ones(3, np.float32)})
    raw = msgpack.unpackb(data, raw=False, strict_map_key=False, ext_hook=lambda c, d: None)
    assert raw["big"]["__msgpack_chunked_array__"] is True
    got = msgpack_restore(data)
    np.testing.assert_array_equal(got["big"], arr)


@pytest.mark.parametrize("data", [
    msgpack.packb(msgpack.ExtType(2, msgpack.packb((1.0, 2.0)))),  # flax's complex
    msgpack.packb(msgpack.ExtType(7, b"abc")),
    b"\xc1", msgpack.packb({"a": 1}) + b"\x00", msgpack.packb("abc")[:-1]])
def test_unpackb_refuses(data):
    with pytest.raises(MsgpackError):
        unpackb(data)


@pytest.mark.parametrize("head,want", [
    (b"PK\x03\x04rest", "torch_zip"), (b"\x80\x02\x8a\x0a", "torch_legacy"),
    (b"\x80", "msgpack"), (b"\x85\xa1a", "msgpack"), (b"\xde\x00\x10", "msgpack"),
    (b"\xdf\x00\x00\x00\x10", "msgpack"), (b"\x93\x01\x02\x03", None), (b"", None),
    (b"\x80\x04\x95", "torch_legacy")])
def test_sniff_format(tmp_path, head, want):
    path = str(tmp_path / "f")
    with open(path, "wb") as f:
        f.write(head)
    if want is None:
        with pytest.raises(ValueError):
            tckpt.sniff_format(path)
    else:
        assert tckpt.sniff_format(path) == want


def test_port_checkpoints_still_load(tmp_path):
    """The port's own torch.save checkpoints load as before."""
    cfg = tcfg.tiny_test_config()
    model = build_retinanet(cfg, device="cpu", seed=3)
    path = tckpt.save_cycle_checkpoint(str(tmp_path), "m", 0, 1, model.state_dict())
    sd = tckpt.load_model_state_dict(path, "retinanet")
    for k, t in model.state_dict().items():
        assert torch.equal(sd[k], t), k
    assert os.path.exists(tckpt.latest_path(str(tmp_path)))
