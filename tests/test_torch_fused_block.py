"""The port's fused bottleneck (aod_meh_hua_torch/ops/fused_block.py) on
the CPU against the JAX package's Pallas kernel in interpret mode, at
the shapes of tests/test_fused_block.py.

On the CPU the wrapper runs the plain PyTorch version, so these tests
hold that version (and the BN folding) to the TPU kernel's arithmetic:
f32 to 2e-5, bf16 to 0.06 of the output's scale (bf16 rounding of the
intermediates, as in tests/test_fused_block.py). The CUDA kernel itself
is held to the plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu.models.resnet import Bottleneck as JBottleneck
from aod_meh_hua_tpu.ops import fused_block as jfb
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.models.resnet import Bottleneck as TBottleneck
from aod_meh_hua_torch.ops import fused_block as tfb
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")


def _random_variables(model, x, seed):
    """The JAX block's variables with randomised params and BN stats."""
    variables = model.init(jax.random.PRNGKey(seed), x)
    rng = np.random.RandomState(seed + 3)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.2, 1.5, a.shape).astype(np.float32), variables["batch_stats"])
    params = jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 0.1).astype(np.float32), variables["params"])
    return {"params": params, "batch_stats": stats}


def _to_torch(fb: jfb.FoldedBlock) -> tfb.FoldedBlock:
    return tfb.FoldedBlock(*(None if a is None else torch.from_numpy(np.array(a, np.float32))
                             for a in fb))


def _case(shape, downsample, seed=0, dtype=jnp.float32):
    b, h, w, cin = shape
    planes = cin // 2 if downsample else cin // 4
    model = JBottleneck(planes=planes, stride=1, downsample=downsample, dtype=dtype)
    x32 = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    variables = _random_variables(model, jnp.asarray(x32), seed)
    return model, x32, variables


@pytest.mark.parametrize("downsample", [False, True])
@pytest.mark.parametrize("shape", [(2, 16, 24, 32), (1, 19, 8, 16)])
def test_reference_matches_pallas_f32(downsample, shape):
    _, x, variables = _case(shape, downsample)
    fb = jfb.fold_bottleneck(variables["params"], variables["batch_stats"])
    want = np.asarray(jfb.fused_bottleneck(jnp.asarray(x), fb, interpret=True))
    got = tfb.fused_bottleneck_reference(torch.from_numpy(x), _to_torch(fb))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("tile_h", [12, 4])
def test_reference_matches_single_and_multi_tile(tile_h):
    """nt=1 (both halo rows zeroed in one program) and nt>1 tiling."""
    _, x, variables = _case((1, 12, 8, 16), False, seed=1)
    fb = jfb.fold_bottleneck(variables["params"], variables["batch_stats"])
    want = np.asarray(jfb.fused_bottleneck(jnp.asarray(x), fb, tile_h=tile_h, interpret=True))
    got = tfb.fused_bottleneck_reference(torch.from_numpy(x), _to_torch(fb))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_reference_matches_pallas_bf16():
    shape = (1, 16, 16, 32)
    _, x32, variables = _case(shape, False, seed=2, dtype=jnp.bfloat16)
    x32 = x32 * 0.5
    fb = jfb.fold_bottleneck(variables["params"], variables["batch_stats"])
    want = np.asarray(jfb.fused_bottleneck(jnp.asarray(x32, jnp.bfloat16), fb,
                                           interpret=True)).astype(np.float32)
    got = tfb.fused_bottleneck_reference(torch.from_numpy(x32).to(torch.bfloat16),
                                         _to_torch(fb))
    assert got.dtype == torch.bfloat16
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got.float().numpy() - want).max() / scale < 0.06


def _port_block(variables, cin, planes, downsample, fused):
    block = TBottleneck(cin, planes, 1, downsample=downsample, fused=fused)
    block.load_state_dict(from_jax_variables(variables))
    return block.eval()


@pytest.mark.parametrize("downsample", [False, True])
def test_fold_bottleneck_matches_jax(downsample):
    shape = (1, 8, 8, 32)
    _, _, variables = _case(shape, downsample)
    planes = 16 if downsample else 8
    want = jfb.fold_bottleneck(variables["params"], variables["batch_stats"])
    got = tfb.fold_bottleneck(_port_block(variables, 32, planes, downsample, fused=True))
    for name, a, b in zip(tfb.FoldedBlock._fields, want, got):
        if a is None:
            assert b is None, name
            continue
        assert tuple(b.shape) == a.shape, name
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("downsample", [False, True])
def test_fused_port_block_matches_unfused_jax_block(downsample):
    """The port's Bottleneck on its fused path (Cin=128 passes the gate)
    against the JAX package's unfused block, NCHW in channels_last."""
    shape = (2, 10, 12, 128)
    model, x, variables = _case(shape, downsample, seed=4)
    want = np.asarray(model.apply(variables, jnp.asarray(x)))
    planes = 64 if downsample else 32
    block = _port_block(variables, 128, planes, downsample, fused=True)
    assert block.fused_eligible(128)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    before = tfb.fused_bottleneck.launches
    with torch.no_grad():
        got = block(xt).permute(0, 2, 3, 1).numpy()
    assert tfb.fused_bottleneck.launches == before  # the CPU runs the plain version
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def _folded_equal(a: tfb.FoldedBlock, b: tfb.FoldedBlock) -> bool:
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


def test_block_folds_once_per_weight_version():
    """Bottleneck.folded caches the kernel-layout FoldedBlock: reused across
    forwards, refolded after load_state_dict, an in-place edit or a new
    dtype; the output is the same as folding on every forward."""
    _, x, variables = _case((1, 6, 7, 128), True, seed=6)
    block = _port_block(variables, 128, 64, True, fused=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        first = block(xt)
        fb = block._folded
        assert block(xt).equal(first) and block._folded is fb
        want = tfb.fused_bottleneck(xt.permute(0, 2, 3, 1).contiguous(), tfb.fold_bottleneck(block))
    assert first.permute(0, 2, 3, 1).equal(want)
    assert _folded_equal(fb, tfb.fold_bottleneck(block))
    for name, t in zip(tfb.FoldedBlock._fields, fb):
        assert t.is_contiguous() and t.dtype == torch.float32 and not t.requires_grad, name

    state = {k: v * 1.5 if k.endswith("weight") else v for k, v in block.state_dict().items()}
    block.load_state_dict(state)
    assert block.folded(torch.float32) is not fb
    assert _folded_equal(block._folded, tfb.fold_bottleneck(block))
    fb2 = block._folded
    with torch.no_grad():
        block.bn2.running_var.mul_(2.0)
    assert block.folded(torch.float32) is not fb2
    assert _folded_equal(block._folded, tfb.fold_bottleneck(block))
    bf = block.folded(torch.bfloat16)
    assert bf.w2.dtype == torch.bfloat16 and bf.b2.dtype == torch.float32
    assert block.folded(torch.bfloat16) is bf


@pytest.mark.parametrize("cin,stride,fused,expect", [
    (128, 1, True, True), (256, 1, True, True), (64, 1, True, False),
    (256, 2, True, False), (256, 1, False, False)])
def test_fused_gate(cin, stride, fused, expect):
    """The same gate as models/resnet.py:145-156: stride 1, Cin % 128 == 0."""
    block = TBottleneck(cin, 16, stride, downsample=True, fused=fused)
    assert block.fused_eligible(cin) is expect


def test_wrapper_on_cpu_is_reference():
    _, x, variables = _case((1, 9, 10, 32), True, seed=5)
    fb = _to_torch(jfb.fold_bottleneck(variables["params"], variables["batch_stats"]))
    xt = torch.from_numpy(x)
    torch.testing.assert_close(tfb.fused_bottleneck(xt, fb),
                               tfb.fused_bottleneck_reference(xt, fb), rtol=0, atol=0)
