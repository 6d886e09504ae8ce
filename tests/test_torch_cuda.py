"""The port's CUDA kernels on the card: the hand-written fused bottleneck
and transposed matmul against their plain PyTorch versions, and the tiny
model's fused path against its unfused one; the train step on the card
against the CPU, a backward through a fused block on the card, and the
sampled Dirichlet MI with a CUDA generator at small concentrations; the
data-parallel step over NCCL at world size 1 against the plain step; the
AL CLI's --mini run and a mid-cycle resume on the card; the ensemble and
MC-dropout steps on the card against the CPU, a fused Detector's
launches and results, the fused eval step exported, saved and loaded,
the tiny Faster R-CNN's eval step and two train steps (under the same
uniforms) on the card against the CPU, the tiny Cascade, Dynamic and
Double-Head R-CNN's train steps (Dynamic R-CNN's five, across its
refresh) and the two-stage TTA on the card against the CPU, the five
Faster R-CNN variants' tiny train steps and eval steps (every attention
block's gamma and biases non-zero) on the card against the CPU, each
two-stage family's tiny exported program against the card's eager step,
and the model-zoo trainer on two gloo ranks sharing the card against one
process. Skips, with the reason, where there is no card.

Run on a machine with an NVIDIA Hopper card (the JAX package need not be
installed there, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

TF32 is turned off for every comparison, so the plain version's cuDNN
convolutions run in full f32. Tolerances: f32 1e-4 of max|ref| (sums in
another order), bf16 0.06 of max|ref| (tests/test_fused_block.py); the
transposed matmul 2^-7 of max|ref|, one bf16 ulp, since kernel and plain
version each round one f32 sum. Two train steps: losses to rtol 1e-4,
parameters to 1e-4 of each tensor's max|p|. The f32 kernel (3xTF32 on the tensor
cores) is also held to a float64 evaluation of the same block within
1e-5 of the output's scale, which a single TF32 pass (about 1e-3) fails.
"""

import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from aod_meh_hua_torch.ops import fused_block as fb_mod
from aod_meh_hua_torch.ops.fused_block import (FoldedBlock, fused_bottleneck,
                                               fused_bottleneck_reference)
from aod_meh_hua_torch.ops.transposed_matmul import (transposed_matmul,
                                                     transposed_matmul_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def random_block(cin, p, cout, downsample, device, seed=0):
    """Folded weights with unit-scale activations (std 1/sqrt(fan_in))."""
    g = torch.Generator().manual_seed(seed)

    def w(*shape, fan_in):
        return (torch.randn(shape, generator=g) * fan_in ** -0.5).to(device)

    def b(n):
        return (torch.randn((1, n), generator=g) * 0.1).to(device)

    return FoldedBlock(w(cin, p, fan_in=cin), b(p), w(9, p, p, fan_in=9 * p), b(p),
                       w(p, cout, fan_in=p), b(cout),
                       w(cin, cout, fan_in=cin) if downsample else None,
                       b(cout) if downsample else None)


CASES = [  # (B, H, W, Cin, P, Cout, downsample); output tiles are 8x16 (8x8 for f32 at P=128)
    (2, 16, 16, 256, 64, 256, False),
    (1, 19, 13, 256, 64, 256, False),     # H and W not multiples of the tile
    (1, 13, 27, 256, 64, 256, False),     # H and W end inside the tile in both directions
    (2, 20, 12, 128, 64, 256, True),      # 1x1 downsample residual
    (1, 12, 17, 512, 128, 512, False),
    (1, 9, 76, 512, 128, 512, False),     # the portrait C3 width
    (1, 9, 8, 256, 128, 512, True),
    (2, 11, 21, 128, 32, 128, False),     # the half-width test model's C2
    (1, 10, 19, 64, 32, 128, True),       # P=32 with a downsample
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain(cuda, case, dtype):
    b, h, w, cin, p, cout, down = case
    fb = random_block(cin, p, cout, down, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((b, h, w, cin), generator=g, device=cuda).to(dtype)
    before = fb_mod.fused_bottleneck.launches
    got = fused_bottleneck(x, fb)
    torch.cuda.synchronize()
    assert fb_mod.fused_bottleneck.launches == before + 1
    want = fused_bottleneck_reference(x, fb)
    assert got.dtype == dtype and got.shape == want.shape
    tol = 1e-4 if dtype == torch.float32 else 0.06
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


def reference_f64(x, fb):
    """fused_bottleneck_reference's arithmetic in float64 (for f32 x, whose
    intermediates the kernel does not round)."""
    p = fb.w1.shape[1]

    def k1(t):
        return t.double().t()[:, :, None, None]

    def bias(t):
        return t.double().reshape(1, -1, 1, 1)

    xd = x.double().permute(0, 3, 1, 2)
    y = torch.relu(F.conv2d(xd, k1(fb.w1)) + bias(fb.b1))
    w2 = fb.w2.double().reshape(3, 3, p, p).permute(3, 2, 0, 1)
    y = torch.relu(F.conv2d(y, w2, padding=1) + bias(fb.b2))
    y = F.conv2d(y, k1(fb.w3)) + bias(fb.b3)
    res = xd if fb.wd is None else F.conv2d(xd, k1(fb.wd)) + bias(fb.bd)
    return torch.relu(y + res).permute(0, 2, 3, 1)


@pytest.mark.parametrize("case", [CASES[0], CASES[3], CASES[4], CASES[7]])
def test_kernel_f32_matches_float64(cuda, case):
    """3xTF32 keeps the f32 kernel at f32 accuracy: within 1e-5 of the
    output's scale of the float64 block."""
    b, h, w, cin, p, cout, down = case
    fb = random_block(cin, p, cout, down, cuda, seed=4)
    x = torch.randn((b, h, w, cin), generator=torch.Generator(device=cuda).manual_seed(5),
                    device=cuda)
    got = fused_bottleneck(x, fb)
    want = reference_f64(x, fb)
    torch.cuda.synchronize()
    err = (got.double() - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


def test_kernel_rejects_what_it_does_not_take(cuda):
    fb = random_block(256, 64, 256, False, cuda)
    x = torch.randn((1, 8, 8, 256), device=cuda)
    with pytest.raises(ValueError):
        fused_bottleneck(x.permute(0, 2, 1, 3), fb)  # not contiguous
    with pytest.raises(TypeError):
        fused_bottleneck(x.half(), fb)
    with pytest.raises(ValueError):
        fused_bottleneck(x, random_block(256, 16, 256, False, cuda))  # P not instantiated


def test_tiny_model_fused_matches_unfused(cuda):
    from aod_meh_hua_torch.models.detector import build_retinanet
    from aod_meh_hua_torch.utils.config import tiny_test_config

    cfg = dict(block_counts=(2, 2, 1, 1), stem_width=32)
    fused = build_retinanet(tiny_test_config(fused_blocks=True, **cfg), device=cuda)
    plain = build_retinanet(tiny_test_config(**cfg), device=cuda)
    plain.load_state_dict(fused.state_dict())
    x = torch.randn((2, 128, 256, 3), generator=torch.Generator(device=cuda).manual_seed(2),
                    device=cuda)
    before = fb_mod.fused_bottleneck.launches
    with torch.no_grad():
        got, want = fused(x), plain(x)
    torch.cuda.synchronize()
    assert fb_mod.fused_bottleneck.launches == before + 2  # layer1.1 and layer2.1
    for g, w in zip(got, want):  # 1e-4 of the output's scale; random heads are tiny
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + 1e-7


@pytest.mark.parametrize("n, k, m", [
    (64, 256, 4096), (64, 256, 1000), (32, 128, 4096),
    (64, 256, 1001),      # element-wise accesses (M % 8 != 0)
    (64, 256, 4168),      # M ends inside a 128-column tile
    (64, 256, 40),        # M smaller than one tile
    (32, 64, 7),          # ... and element-wise
    (64, 256, 50_000),    # more tiles than SMs: each block walks several
    (32, 96, 40_001),     # ... element-wise, K shorter than the ring
])
def test_transposed_matmul_matches_plain(cuda, n, k, m):
    g = torch.Generator(device=cuda).manual_seed(3)
    wt = (torch.randn((n, k), generator=g, device=cuda) * 0.02).to(torch.bfloat16)
    xt = (torch.randn((k, m), generator=g, device=cuda) * 0.1).to(torch.bfloat16)
    before = transposed_matmul.launches
    got = transposed_matmul(wt, xt)
    torch.cuda.synchronize()
    assert transposed_matmul.launches == before + 1
    want = transposed_matmul_reference(wt, xt)
    assert got.dtype == torch.bfloat16 and got.shape == (n, m)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -7 * want.float().abs().max().item(), err


def test_transposed_matmul_counts_each_launch(cuda):
    wt = torch.zeros((64, 256), dtype=torch.bfloat16, device=cuda)
    xt = torch.ones((256, 512), dtype=torch.bfloat16, device=cuda)
    before = transposed_matmul.launches
    for i in range(3):
        transposed_matmul(wt, xt)
        assert transposed_matmul.launches == before + i + 1


def test_transposed_matmul_rejects_what_it_does_not_take(cuda):
    wt = torch.randn((64, 256), device=cuda).to(torch.bfloat16)
    xt = torch.randn((256, 1024), device=cuda).to(torch.bfloat16)
    before = transposed_matmul.launches
    with pytest.raises(ValueError):
        transposed_matmul(wt, xt[:, ::2])           # not contiguous
    with pytest.raises(TypeError):
        transposed_matmul(wt.float(), xt.float())   # not bf16
    with pytest.raises(ValueError):
        transposed_matmul(wt, xt[:128].contiguous())  # K does not match
    with pytest.raises(ValueError):
        transposed_matmul(wt[:48].contiguous(), xt)   # N not instantiated
    assert transposed_matmul.launches == before


def _tiny_train_run(device, steps=2, place=None):
    from aod_meh_hua_torch.engine.batch import Batch
    from aod_meh_hua_torch.engine.train import create_train_state, make_train_step
    from aod_meh_hua_torch.models.detector import build_retinanet
    from aod_meh_hua_torch.ops.anchors import anchor_valid_flags
    from aod_meh_hua_torch.utils.config import TrainConfig, tiny_test_config

    cfg = tiny_test_config(block_counts=(2, 2, 1, 1), stem_width=32)
    g = torch.Generator().manual_seed(8)
    h, w = cfg.canvas
    boxes = torch.zeros((2, cfg.max_gt, 4))
    boxes[:, :2] = torch.tensor([[10.0, 12.0, 70.0, 90.0], [120.0, 30.0, 200.0, 110.0]])
    valid = torch.zeros((2, cfg.max_gt), dtype=torch.bool)
    valid[:, :2] = True
    shapes = torch.tensor([[h, w], [h - 20, w - 36]], dtype=torch.int32)
    av = anchor_valid_flags(cfg.build_anchor_generator(), cfg.featmap_sizes(), shapes.numpy())
    batch = Batch(torch.randn((2, h, w, 3), generator=g), boxes,
                  torch.tensor([[1, 4] + [0] * (cfg.max_gt - 2)] * 2), valid,
                  torch.from_numpy(av), shapes)
    model = build_retinanet(cfg, device=device, seed=3)
    initial = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    mesh = place(model) if place is not None else None
    step = make_train_step(model, cfg, create_train_state(model, TrainConfig()), device=device,
                           mesh=mesh)
    losses = [{k: float(v) for k, v in step(batch).items()} for _ in range(steps)]
    return losses, {n: (initial[n], p.detach().cpu()) for n, p in model.named_parameters()}


def test_train_steps_on_the_card_match_the_cpu(cuda):
    """Losses to rtol 1e-4, parameters to 1e-4 of each tensor's max-abs,
    and the updates (new - old) to 1e-3 of their own max-abs plus two f32
    ulps of the tensor's max-abs, so a wrong or missing update on the
    card fails even where it is small beside the parameter."""
    cpu_losses, cpu_params = _tiny_train_run("cpu")
    gpu_losses, gpu_params = _tiny_train_run(cuda)
    for c, g in zip(cpu_losses, gpu_losses):
        for k in c:
            assert g[k] == pytest.approx(c[k], rel=1e-4), k
    for name, (c0, c) in cpu_params.items():
        g0, g = gpu_params[name]
        scale = c.abs().max().item()
        assert (g - c).abs().max().item() <= 1e-4 * scale + 1e-12, name
        dc, dg = c - c0, g - g0
        ulp = torch.finfo(torch.float32).eps * scale
        assert (dg - dc).abs().max().item() <= 1e-3 * dc.abs().max().item() + 2 * ulp, name


def test_nccl_world1_dp_step_is_the_plain_step(cuda):
    """NCCL at world size 1: the data-parallel step (replicated weights,
    the loss normaliser, the aux and the gradients all-reduced over the
    group) is the plain step bit for bit, under deterministic cuDNN."""
    import torch.distributed as dist

    from aod_meh_hua_torch.parallel import init_distributed, make_mesh, replicate
    from aod_meh_hua_torch.parallel.launch import free_port

    def data_parallel(model):
        mesh = make_mesh(1, device_type="cuda")
        replicate(model, mesh)
        return mesh

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain = _tiny_train_run(cuda)
        init_distributed(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl", device=cuda,
                         timeout=60)
        try:
            assert dist.get_backend() == "nccl"
            dp = _tiny_train_run(cuda, place=data_parallel)
        finally:
            dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert dp[0] == plain[0]
    for name, (_, p) in plain[1].items():
        assert torch.equal(dp[1][name][1], p), name


def test_backward_through_the_fused_kernel_raises(cuda):
    from aod_meh_hua_torch.models.detector import build_retinanet
    from aod_meh_hua_torch.utils.config import tiny_test_config

    model = build_retinanet(tiny_test_config(fused_blocks=True, block_counts=(2, 2, 1, 1),
                                             stem_width=32), device=cuda)
    x = torch.randn((1, 128, 256, 3), device=cuda)
    before = fb_mod.fused_bottleneck.launches
    out = model(x)
    assert fb_mod.fused_bottleneck.launches == before + 2
    with pytest.raises(RuntimeError, match="fused_bottleneck has no backward"):
        out[0].sum().backward()


def test_sampled_mi_on_cuda_at_small_alpha(cuda):
    """With a CUDA generator: at alpha = 1e-8 the draws sit at the
    vertices (aleatoric about 0, where torch's own Dirichlet sampler
    returns the uniform point); at moderate alpha the estimate is near
    the closed form; one seed gives one result."""
    from aod_meh_hua_torch.ops.dirichlet import (dirichlet_mi_sampled,
                                                 dirichlet_mutual_information)

    alpha = torch.tensor([[1e-8, 1e-8, 1e-8], [5e-4, 1e-9, 2e-9], [0.05, 0.05, 0.05],
                          [2.0, 5.0, 0.7]], device=cuda)

    def run(seed):
        return dirichlet_mi_sampled(alpha, torch.Generator(device=cuda).manual_seed(seed),
                                    num_samples=4000, chunk=500)

    got, exact = run(0), dirichlet_mutual_information(alpha)
    assert got.aleatoric.device.type == "cuda"
    assert got.aleatoric[:2].abs().max().item() < 1e-3
    assert (got.aleatoric - exact.aleatoric).abs().max().item() < 0.02
    assert (got.total - exact.total).abs().max().item() < 0.02
    assert torch.equal(run(1).epistemic, run(1).epistemic)


# --- the AL driver and its CLI on the card -------------------------------------------

def _fixture_voc(root: Path) -> str:
    """chip_smoke.py's VOC tree of the committed fixture JPEGs, 14
    trainval and 4 test ids."""
    from chip_smoke import synthetic_voc

    return str(synthetic_voc(root, n_trainval=14, n_test=4, seed=3))


def test_mini_cli_on_the_card(cuda, tmp_path):
    """The port's CLI, --mini, on the card: two cycles, the artifacts of
    tests/test_al_loop.py::test_al_two_cycles."""
    from aod_meh_hua_torch.tools import train_retinanet

    voc = _fixture_voc(tmp_path)
    work = tmp_path / "work"
    driver = train_retinanet.main(["--mini", "--voc07", voc, "--work-dir", str(work)])
    assert driver.device.type == "cuda"
    assert [m["cycle"] for m in driver.metrics] == [0, 1]
    assert all(np.isfinite(m["mAP"]) for m in driver.metrics)
    x_l0, x_l1 = np.load(work / "X_L_0.npy"), np.load(work / "X_L_1.npy")
    assert len(x_l0) == 4 and len(x_l0) < len(x_l1) <= 6 and set(x_l0) <= set(x_l1)
    unc = np.load(work / "Unc_1.npy")
    assert unc.shape == (14,) and np.isfinite(unc).all()
    assert len([f for f in (work / "model_save").iterdir() if "_mycode" in f.name]) == 2


def test_mid_cycle_resume_on_the_card(cuda, tmp_path, monkeypatch):
    """A mid-cycle resume_from on the card at the tiny config gives the
    uninterrupted run's final parameters: bit-identical where every op
    has a deterministic CUDA implementation (torch.use_deterministic_
    algorithms, CUBLAS_WORKSPACE_CONFIG=:4096:8, cudnn.benchmark off);
    where one has none (torch warns, naming it), to 1e-6 of each tensor's
    max-abs."""
    from aod_meh_hua_torch.al.loop import ALDriver, ALPaths
    from aod_meh_hua_torch.data.pipeline import PipelineConfig
    from aod_meh_hua_torch.engine import checkpoint
    from aod_meh_hua_torch.utils.config import ALConfig, TrainConfig, tiny_test_config

    voc = _fixture_voc(tmp_path)
    cfg = tiny_test_config()
    tcfg = TrainConfig(batch_size=2, outer_epoch=1, epoch_ratio=(2,), lr=0.01, ckpt_interval=1)
    al = ALConfig(cycles=(0,), x_l_0_size=4, x_s_size=2, x_l_repeat=1, score_batch_size=4)
    pipe = PipelineConfig(img_scale=(250, 120), canvas=cfg.canvas)

    def driver(work):
        return ALDriver(cfg, tcfg, al, ALPaths(voc07=voc, voc12=None, work_dir=str(work)),
                        pipeline=pipe, validate=False, log=None, device=cuda)

    real_save = checkpoint.save_train_state
    calls = {"n": 0}

    def killer(save_dir, state, progress):
        out = real_save(save_dir, state, progress)
        calls["n"] += 1
        if calls["n"] == 3:
            raise KeyboardInterrupt("simulated preemption")
        return out

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            driver(tmp_path / "a").run()
            with monkeypatch.context() as mp:
                mp.setattr(checkpoint, "save_train_state", killer)
                with pytest.raises(KeyboardInterrupt):
                    driver(tmp_path / "b").run()
            d = driver(tmp_path / "b")
            d.run(resume_from=d.paths.save_dir)
    finally:
        torch.use_deterministic_algorithms(False)
    nondeterministic = sorted({str(w.message).split(" does not have")[0] for w in caught
                               if "deterministic" in str(w.message)})
    print("ops without a deterministic CUDA implementation:", nondeterministic)
    pa, pb = (checkpoint.load_checkpoint(checkpoint.cycle_ckpt_path(
        str(tmp_path / w / "model_save"), "retinanet_meh", 0, 2)) for w in ("a", "b"))
    assert pa.keys() == pb.keys()
    for k in pa:
        if nondeterministic:
            tol = 1e-6 * pa[k].abs().max().item()
            assert (pa[k] - pb[k]).abs().max().item() <= tol, (k, nondeterministic)
        else:
            assert torch.equal(pa[k], pb[k]), k


# --- the baselines and the inference API on the card ----------------------------------

def _sharpened_members(device, seeds=(1, 2, 3)):
    """tiny_test_config() members with the cls head's weight x150 (logits
    of std ~1.5), on `device`."""
    from aod_meh_hua_torch.models.detector import build_retinanet
    from aod_meh_hua_torch.utils.config import tiny_test_config

    members = []
    for s in seeds:
        m = build_retinanet(tiny_test_config(), device=device, seed=s)
        with torch.no_grad():
            m.head.retina_cls.weight.mul_(150.0)
        members.append(m)
    return members


def test_baseline_steps_on_the_card_match_the_cpu(cuda):
    """The ensemble step to rtol 1e-4 of the CPU's; the MC step at rate 0
    (0 up to rounding) to 1e-6; at rate 0.1 the same CUDA generator seed
    gives the same scores, and no block fuses."""
    import dataclasses

    from aod_meh_hua_torch.al.baselines import make_ensemble_score_step, make_mc_dropout_score_step
    from aod_meh_hua_torch.engine.batch import EvalBatch
    from aod_meh_hua_torch.models.detector import build_retinanet
    from aod_meh_hua_torch.utils.config import tiny_test_config

    cfg = tiny_test_config()
    h, w = cfg.canvas
    g = torch.Generator().manual_seed(4)
    batch = EvalBatch(torch.randn((2, h, w, 3), generator=g) * 0.5,
                      torch.tensor([[h, w], [h - 16, w - 40]], dtype=torch.int32),
                      torch.ones((2, 4)), np.ones(2, bool))
    out = {}
    for dev in ("cpu", cuda):
        members = _sharpened_members(dev)
        ens = make_ensemble_score_step(members, cfg, device=dev)(batch)
        mc0 = make_mc_dropout_score_step(members[0], cfg, 3, device=dev)(
            batch, torch.Generator(device=dev).manual_seed(0))
        out[str(dev)] = (ens.cpu(), mc0.cpu())
    (e_cpu, m_cpu), (e_gpu, m_gpu) = out["cpu"], out[str(cuda)]
    assert (e_cpu > 0).all()
    torch.testing.assert_close(e_gpu, e_cpu, rtol=1e-4, atol=0)
    torch.testing.assert_close(m_gpu, m_cpu, rtol=0, atol=1e-6)

    mc_cfg = dataclasses.replace(cfg, mc_dropout=0.1, fused_blocks=True)
    mc = build_retinanet(mc_cfg, device=cuda)
    mc.load_state_dict(_sharpened_members(cuda, seeds=(1,))[0].state_dict())
    step = make_mc_dropout_score_step(mc, mc_cfg, 4, device=cuda)
    before = fb_mod.fused_bottleneck.launches
    u = [step(batch, torch.Generator(device=cuda).manual_seed(7)) for _ in range(2)]
    assert fb_mod.fused_bottleneck.launches == before
    assert torch.isfinite(u[0]).all() and (u[0] > 0).all()
    assert torch.equal(u[0], u[1])


def test_detector_launches_the_fused_kernel(cuda):
    """A fused Detector on the card: the fused kernel launches twice per
    forward at this config (layer1.1 and layer2.1) in __call__,
    predict_batch and with_uncertainty, and its results are the CPU
    Detector's (same weights) to rtol 1e-4."""
    from aod_meh_hua_torch.api import Detector, init_detector
    from aod_meh_hua_torch.data.pipeline import PipelineConfig
    from aod_meh_hua_torch.utils.config import tiny_test_config

    cfg = tiny_test_config(block_counts=(2, 2, 1, 1), stem_width=32, fused_blocks=True)
    h, w = cfg.canvas
    pipe = PipelineConfig(img_scale=(w, h), canvas=cfg.canvas, device_normalize=True)
    cpu_model = init_detector(cfg, seed=2, device="cpu")
    with torch.no_grad():
        cpu_model.head.retina_cls.weight.mul_(150.0)
    model = init_detector(cfg, device=cuda)
    model.load_state_dict(cpu_model.state_dict())
    r = np.random.RandomState(7)
    imgs = [(r.rand(hh, ww, 3) * 255).astype(np.uint8) for hh, ww in ((40, 80), (80, 40),
                                                                       (50, 90))]
    det, ref = Detector(cfg, model, pipeline=pipe), Detector(cfg, cpu_model, pipeline=pipe)
    before = fb_mod.fused_bottleneck.launches
    single = [det(i) for i in imgs]
    assert fb_mod.fused_bottleneck.launches == before + 2 * len(imgs)
    batched = det.predict_batch(imgs, max_batch=2)  # landscape 2 in one chunk, portrait 1
    assert fb_mod.fused_bottleneck.launches == before + 2 * len(imgs) + 2 * 2
    udet = Detector(cfg, model, pipeline=pipe, with_uncertainty=True)
    unc = [udet(i) for i in imgs]
    assert fb_mod.fused_bottleneck.launches == before + 4 * len(imgs) + 2 * 2
    for img, s, b, u in zip(imgs, single, batched, unc):
        want = ref(img)
        assert sum(len(a) for a in s) > 0
        for x, y, z, v in zip(s, b, u, want):
            assert x.shape == y.shape == v.shape and z.shape == (len(x), 6)
            np.testing.assert_allclose(x, v, rtol=1e-4, atol=1e-3)
            np.testing.assert_allclose(y, x, rtol=1e-4, atol=1e-3)
            np.testing.assert_allclose(z[:, :5], x, rtol=1e-5, atol=1e-5)


def test_exported_fused_program_launches_the_kernel(cuda, tmp_path):
    """The fused tiny model's eval step exported on the card, saved and
    loaded: two operator nodes, two kernel launches per call of the
    loaded program, the eager step's detections bit for bit, and a
    backward through the operator raises."""
    from aod_meh_hua_torch.api import init_detector
    from aod_meh_hua_torch.engine.batch import EvalBatch
    from aod_meh_hua_torch.engine.eval import make_eval_step
    from aod_meh_hua_torch.tools.deployment import export_model
    from aod_meh_hua_torch.utils.config import tiny_test_config

    cfg = tiny_test_config(block_counts=(2, 2, 1, 1), stem_width=32, fused_blocks=True)
    model = init_detector(cfg, seed=2, device=cuda)
    with torch.no_grad():
        model.head.retina_cls.weight.mul_(150.0)
    program = export_model.export_eval_step(cfg, model, 2)
    assert export_model.fused_nodes(program) == 2
    path = tmp_path / "det.pt2"
    export_model.save_program(program, path)
    loaded = export_model.load_program(path)
    h, w = cfg.canvas
    r = np.random.RandomState(0)
    # the program takes the traced dtypes: int32 shapes
    batch = EvalBatch(r.randn(2, h, w, 3).astype(np.float32),
                      np.array([[h, w], [h - 8, w]], np.int32), np.ones((2, 4), np.float32),
                      np.ones(2, bool))
    before = fb_mod.fused_bottleneck.launches
    got = export_model.run_program(loaded, batch)
    torch.cuda.synchronize()
    assert fb_mod.fused_bottleneck.launches == before + 2
    want = make_eval_step(model, cfg, device=cuda)(batch)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    assert int(want.valid.sum()) > 0
    x = torch.randn(1, 8, 8, 128, device=cuda, requires_grad=True)
    blk = random_block(128, 32, 128, False, cuda)
    with pytest.raises(RuntimeError, match="fused_bottleneck has no backward"):
        fused_bottleneck(x, blk).sum().backward()


def _tiny_frcnn(device=None):
    """tiny_faster_rcnn_config(), a seeded model with its RPN and class
    heads sharpened on the CPU (logit std 1.5; random heads leave every
    objectness near 0.5 and every class score near 1 / 7, where the card
    and the CPU order near-ties differently), a batch with two boxes per
    image that anchors match, and the state_dict to load on the card."""
    from aod_meh_hua_torch.engine.batch import Batch
    from aod_meh_hua_torch.engine.two_stage import (anchor_table, extract_rois,
                                                    make_proposal_fn)
    from aod_meh_hua_torch.models.two_stage import build_two_stage
    from aod_meh_hua_torch.ops.anchors import anchor_valid_flags
    from aod_meh_hua_torch.utils.config import tiny_faster_rcnn_config

    cfg = tiny_faster_rcnn_config()
    g = torch.Generator().manual_seed(9)
    h, w = cfg.canvas
    boxes = torch.zeros((2, cfg.max_gt, 4))
    boxes[:, :2] = torch.tensor([[10.0, 8.0, 50.0, 48.0], [60.0, 10.0, 112.0, 58.0]])
    valid = torch.zeros((2, cfg.max_gt), dtype=torch.bool)
    valid[:, :2] = True
    shapes = torch.tensor([[h, w], [h - 4, w - 12]], dtype=torch.int32)
    av = anchor_valid_flags(cfg.build_anchor_generator(), cfg.featmap_sizes(), shapes.numpy())
    batch = Batch(torch.randn((2, h, w, 3), generator=g), boxes,
                  torch.tensor([[1, 4] + [0] * (cfg.max_gt - 2)] * 2), valid,
                  torch.from_numpy(av), shapes)
    model = build_two_stage(cfg, device="cpu", seed=5)
    with torch.no_grad():
        feats, rpn_cls, rpn_reg = model(batch.images)
        model.rpn_head.rpn_cls.weight.mul_(1.5 / rpn_cls.std().item())
        feats, rpn_cls, rpn_reg = model(batch.images)
        props = make_proposal_fn(cfg)(rpn_cls, rpn_reg, torch.from_numpy(anchor_table(cfg)),
                                      shapes, cfg.rpn.test_nms_pre, cfg.rpn.test_max_per_img)[0]
        cls = model.roi_forward(extract_rois(cfg, feats, props))[0]
        model.bbox_head.fc_cls.weight.mul_(1.5 / cls.std().item())
    return cfg, batch, model.state_dict()


def test_faster_rcnn_eval_on_the_card_matches_the_cpu(cuda):
    """The two-stage eval step on the card against the CPU's: the same
    valid slots, labels and proposals behind them, scores and boxes to
    rtol 1e-4."""
    from aod_meh_hua_torch.engine.batch import EvalBatch
    from aod_meh_hua_torch.engine.two_stage import make_faster_rcnn_eval_step
    from aod_meh_hua_torch.models.two_stage import build_two_stage

    cfg, batch, sd = _tiny_frcnn()
    ebatch = EvalBatch(batch.images, batch.img_shapes,
                       torch.tensor([[1.0] * 4, [1.3] * 4]), torch.ones(2, dtype=torch.bool))
    out = {}
    for dev in ("cpu", cuda):
        model = build_two_stage(cfg, device=dev)
        model.load_state_dict(sd)
        out[str(dev)] = [t.cpu() for t in make_faster_rcnn_eval_step(model, cfg, dev)(ebatch)]
    c, g = out["cpu"], out[str(cuda)]
    assert c[3].sum() > 10
    for i in (2, 3, 4):  # labels, valid, the proposal behind each detection
        assert torch.equal(g[i], c[i])
    torch.testing.assert_close(g[1], c[1], rtol=1e-4, atol=0)
    torch.testing.assert_close(g[0], c[0], rtol=1e-4, atol=1e-3)


def test_faster_rcnn_train_steps_on_the_card_match_the_cpu(cuda):
    """Two steps from the same weights, batch and uniforms (drawn once on
    the CPU): losses and num_pos to rtol 1e-4, parameters to 1e-4 of each
    tensor's max-abs, updates as test_train_steps_on_the_card_match_the_cpu."""
    from aod_meh_hua_torch.engine.train import create_train_state
    from aod_meh_hua_torch.engine.two_stage import make_faster_rcnn_train_step
    from aod_meh_hua_torch.models.two_stage import build_two_stage
    from aod_meh_hua_torch.utils.config import TrainConfig

    cfg, batch, sd = _tiny_frcnn()
    gen = torch.Generator().manual_seed(4)
    n = {"rpn": cfg.level_bounds()[-1][1], "roi": cfg.max_gt + cfg.rpn.train_max_per_img}
    draws = [{k: tuple(torch.rand((2, m), generator=gen) for _ in range(2)) for k, m in n.items()}
             for _ in range(2)]
    runs = {}
    for dev in ("cpu", cuda):
        model = build_two_stage(cfg, device=dev)
        model.load_state_dict(sd)
        initial = {k: p.detach().cpu().clone() for k, p in model.named_parameters()}
        step = make_faster_rcnn_train_step(model, cfg, create_train_state(model, TrainConfig()),
                                           device=dev)
        losses = [{k: float(v) for k, v in step(
            batch, uniforms=lambda stage, m, k, d=d, dev=dev: tuple(u.to(dev) for u in d[stage])
        ).items()} for d in draws]
        runs[str(dev)] = losses, {k: (initial[k], p.detach().cpu())
                                  for k, p in model.named_parameters()}
    (cpu_losses, cpu_params), (gpu_losses, gpu_params) = runs["cpu"], runs[str(cuda)]
    assert cpu_losses[0]["num_pos"] > 0 and cpu_losses[0]["loss_rpn_bbox"] > 0
    for c, g in zip(cpu_losses, gpu_losses):
        for k in c:
            assert g[k] == pytest.approx(c[k], rel=1e-4), k
    for name, (c0, c) in cpu_params.items():
        g0, g = gpu_params[name]
        scale = c.abs().max().item()
        assert (g - c).abs().max().item() <= 1e-4 * scale + 1e-12, name
        dc, dg = c - c0, g - g0
        ulp = torch.finfo(torch.float32).eps * scale
        assert (dg - dc).abs().max().item() <= 1e-3 * dc.abs().max().item() + 2 * ulp, name


def test_train_detector_mini_on_the_card(cuda, tmp_path):
    """The model-zoo trainer's --mini run without --cpu, on the card: one
    epoch with its eval, the JAX tool's files, the model on cuda, and its
    checkpoint back through init_detector."""
    import json

    from aod_meh_hua_torch.api import init_detector
    from aod_meh_hua_torch.tools import train_detector

    voc = _fixture_voc(tmp_path)
    work = tmp_path / "work"
    model, cfg, metrics = train_detector.main(
        ["--family", "faster_rcnn", "--mini", "--voc07", voc, "--work-dir", str(work),
         "--epochs", "1"])
    assert next(model.parameters()).device.type == "cuda"
    rows = [json.loads(line) for line in (work / "train_log.jsonl").read_text().splitlines()]
    assert rows == metrics and set(rows[0]) == {"epoch", "loss", "lr", "mAP"}
    assert np.isfinite(rows[0]["loss"])
    loaded = init_detector(cfg, checkpoint=str(work / "faster_rcnn_final.ckpt"), device=cuda)
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def _tiny_family(family):
    """_tiny_frcnn's weights and batch for the tiny config of a two-stage
    family (its RPN head sharpened to logit std 1.5, and each RoI head's
    class logits, the cascade's three alike)."""
    import chip_smoke
    from aod_meh_hua_torch.models.two_stage import build_two_stage
    from aod_meh_hua_torch.utils.config import ZOO_FAMILIES

    _, batch, _ = _tiny_frcnn()
    cfg = ZOO_FAMILIES[family][1]()
    model = build_two_stage(cfg, device="cpu", seed=5)
    chip_smoke.sharpen_frcnn(model, cfg, batch.images, batch.img_shapes)
    return cfg, batch, model.state_dict()


@pytest.mark.parametrize("family", ["cascade_rcnn", "dynamic_rcnn", "double_head_rcnn"])
def test_rcnn_family_train_steps_on_the_card_match_the_cpu(cuda, family):
    """The family's train steps (two; Dynamic R-CNN's five, across its
    refresh at interval 4) from the same weights, batch and uniforms on
    the card and on the CPU: losses to rtol 1e-4, the parameters and the
    double head's BN running statistics to 1e-4 of each tensor's max-abs,
    Dynamic R-CNN's threshold and beta to 1e-6."""
    from aod_meh_hua_torch.engine.train import create_train_state
    from aod_meh_hua_torch.engine.two_stage import make_two_stage_train_step
    from aod_meh_hua_torch.models.two_stage import build_two_stage
    from aod_meh_hua_torch.utils.config import TrainConfig

    cfg, batch, sd = _tiny_family(family)
    gen = torch.Generator().manual_seed(4)
    n = {"rpn": cfg.level_bounds()[-1][1], "roi": cfg.max_gt + cfg.rpn.train_max_per_img}
    if family == "cascade_rcnn":
        n.update({f"roi{i}": cfg.max_gt + (cfg.rpn.train_max_per_img if i == 0
                                           else cfg.rcnn.sampler_num) for i in range(3)})
    draws = [{k: tuple(torch.rand((2, m), generator=gen) for _ in range(2)) for k, m in n.items()}
             for _ in range(5 if family == "dynamic_rcnn" else 2)]
    runs = {}
    for dev in ("cpu", cuda):
        model = build_two_stage(cfg, device=dev)
        model.load_state_dict(sd)
        step = make_two_stage_train_step(model, cfg, create_train_state(model, TrainConfig()),
                                         device=dev)
        losses = [{k: float(v) for k, v in step(
            batch, uniforms=lambda stage, m, k, d=d, dev=dev: tuple(u.to(dev) for u in d[stage])
        ).items()} for d in draws]
        runs[str(dev)] = losses, {k: v.detach().cpu() for k, v in model.state_dict().items()}
    (cpu_losses, cpu_sd), (gpu_losses, gpu_sd) = runs["cpu"], runs[str(cuda)]
    assert cpu_losses[0]["num_pos"] > 0
    for c, g in zip(cpu_losses, gpu_losses):
        for k in c:
            assert g[k] == pytest.approx(c[k], rel=1e-4), k
    for name, c in cpu_sd.items():
        g = gpu_sd[name]
        if name.startswith("dynamic."):
            assert torch.allclose(g.double(), c.double(), rtol=0, atol=1e-6), name
            continue
        assert (g - c).abs().max().item() <= 1e-4 * c.abs().max().item() + 1e-12, name
    if family == "double_head_rcnn":
        assert not torch.equal(cpu_sd["bbox_head.res_block.bn1.running_var"],
                               sd["bbox_head.res_block.bn1.running_var"])
    if family == "dynamic_rcnn":
        assert int(gpu_sd["dynamic.step"]) == 5
        assert float(cpu_sd["dynamic.iou_thr"]) != cfg.rcnn.pos_iou_thr  # refreshed


VARIANTS = ("libra_rcnn", "pafpn", "carafe", "groie", "empirical_attention")


def _tiny_variant(family):
    """_tiny_family's model of a Faster R-CNN variant with its zero-start
    parameters drawn first (chip_smoke.seed_zero_starts: at init every
    attention block is the identity, and the BFP's phi bias has no
    gradient)."""
    import chip_smoke
    from aod_meh_hua_torch.models.two_stage import build_two_stage
    from aod_meh_hua_torch.utils.config import ZOO_FAMILIES

    _, batch, _ = _tiny_frcnn()
    cfg = ZOO_FAMILIES[family][1]()
    model = build_two_stage(cfg, device="cpu", seed=5)
    blocks = chip_smoke.seed_zero_starts(model, seed=6)
    assert blocks == {"groie": 1, "empirical_attention": 2}.get(family, 0)
    chip_smoke.sharpen_frcnn(model, cfg, batch.images, batch.img_shapes)
    return cfg, batch, model.state_dict()


@pytest.mark.parametrize("family", VARIANTS)
def test_rcnn_variant_train_steps_on_the_card_match_the_cpu(cuda, family):
    """Two steps of the variant's tiny config (Libra's RoI sampler on its
    seven draws) from the same weights, batch and uniforms on the card and
    on the CPU: losses to rtol 1e-4, every tensor to 1e-4 of its max-abs."""
    from aod_meh_hua_torch.engine.train import create_train_state
    from aod_meh_hua_torch.engine.two_stage import make_two_stage_train_step, roi_draws
    from aod_meh_hua_torch.models.two_stage import build_two_stage
    from aod_meh_hua_torch.utils.config import TrainConfig

    cfg, batch, sd = _tiny_variant(family)
    gen = torch.Generator().manual_seed(4)
    n = {"rpn": (cfg.level_bounds()[-1][1], 2),
         "roi": (cfg.max_gt + cfg.rpn.train_max_per_img, roi_draws(cfg))}
    draws = [{k: tuple(torch.rand((2, m), generator=gen) for _ in range(j))
              for k, (m, j) in n.items()} for _ in range(2)]
    runs = {}
    for dev in ("cpu", cuda):
        model = build_two_stage(cfg, device=dev)
        model.load_state_dict(sd)
        step = make_two_stage_train_step(model, cfg, create_train_state(model, TrainConfig()),
                                         device=dev)
        losses = [{k: float(v) for k, v in step(
            batch, uniforms=lambda stage, m, k, d=d, dev=dev: tuple(u.to(dev) for u in d[stage])
        ).items()} for d in draws]
        runs[str(dev)] = losses, {k: v.detach().cpu() for k, v in model.state_dict().items()}
    (cpu_losses, cpu_sd), (gpu_losses, gpu_sd) = runs["cpu"], runs[str(cuda)]
    assert cpu_losses[0]["num_pos"] > 0
    for c, g in zip(cpu_losses, gpu_losses):
        for k in c:
            assert g[k] == pytest.approx(c[k], rel=1e-4), k
    for name, c in cpu_sd.items():
        assert (gpu_sd[name] - c).abs().max().item() <= 1e-4 * c.abs().max().item() + 1e-12, name


@pytest.mark.parametrize("family", VARIANTS)
def test_rcnn_variant_eval_on_the_card_matches_the_cpu(cuda, family):
    """The variant's tiny eval step on the card against the CPU's: the same
    valid slots, labels and proposals behind them, scores and boxes to
    rtol 1e-4."""
    from aod_meh_hua_torch.engine.batch import EvalBatch
    from aod_meh_hua_torch.engine.two_stage import make_two_stage_eval_step
    from aod_meh_hua_torch.models.two_stage import build_two_stage

    cfg, batch, sd = _tiny_variant(family)
    ebatch = EvalBatch(batch.images, batch.img_shapes,
                       torch.tensor([[1.0] * 4, [1.3] * 4]), torch.ones(2, dtype=torch.bool))
    out = {}
    for dev in ("cpu", cuda):
        model = build_two_stage(cfg, device=dev)
        model.load_state_dict(sd)
        out[str(dev)] = [t.cpu() for t in make_two_stage_eval_step(model, cfg, dev)(ebatch)]
    c, g = out["cpu"], out[str(cuda)]
    assert c[3].sum() > 10
    for i in (2, 3, 4):  # labels, valid, the proposal behind each detection
        assert torch.equal(g[i], c[i])
    torch.testing.assert_close(g[1], c[1], rtol=1e-4, atol=0)
    torch.testing.assert_close(g[0], c[0], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("family", ["faster_rcnn", "cascade_rcnn"])
def test_two_stage_tta_on_the_card_matches_the_cpu(cuda, family):
    """Detector.tta of the tiny config, two scales with the flip, on the
    card against the CPU: the same rows per class, boxes and scores to
    rtol 1e-4."""
    from aod_meh_hua_torch.api import Detector
    from aod_meh_hua_torch.data.pipeline import PipelineConfig
    from aod_meh_hua_torch.models.two_stage import build_two_stage

    cfg, _, sd = _tiny_family(family)
    img = (np.random.RandomState(2).rand(70, 110, 3) * 255).astype(np.uint8)
    pipe = PipelineConfig(img_scale=(128, 64), canvas=cfg.canvas, device_normalize=True)
    out = {}
    for dev in ("cpu", cuda):
        model = build_two_stage(cfg, device=dev)
        model.load_state_dict(sd)
        out[str(dev)] = Detector(cfg, model, pipeline=pipe).tta(
            img, scales=[(128, 64), (96, 48)], flip=True)
    assert sum(len(a) for a in out["cpu"]) > 0
    for c, g in zip(out["cpu"], out[str(cuda)]):
        assert c.shape == g.shape
        np.testing.assert_allclose(g, c, rtol=1e-4, atol=1e-3)


def _tiny_eval_batch(cfg, seed=0):
    from aod_meh_hua_torch.engine.batch import EvalBatch

    rng = np.random.RandomState(seed)
    h, w = cfg.canvas
    shapes = np.array([[h, w], [h - 8, w - 16]], np.int32)
    return EvalBatch(rng.randn(2, h, w, 3).astype(np.float32), shapes,
                     np.array([[1.0] * 4, [0.8, 0.9, 0.8, 0.9]], np.float32), np.ones(2, bool))


@pytest.mark.parametrize("family", ["faster_rcnn", "cascade_rcnn", "dynamic_rcnn",
                                    "double_head_rcnn"])
def test_two_stage_export_on_the_card_matches_the_eager_step(cuda, family, tmp_path):
    """The tiny family's eval step exported on the card at batch 2 (every
    NMS a device while_loop), saved and loaded, against the card's eager
    step on the same batch: the same valid slots, labels and sources,
    boxes and scores to rtol 1e-6."""
    import chip_smoke
    from aod_meh_hua_torch.engine.two_stage import make_two_stage_eval_step
    from aod_meh_hua_torch.models.two_stage import build_two_stage
    from aod_meh_hua_torch.tools.deployment import export_model
    from aod_meh_hua_torch.utils.config import ZOO_FAMILIES

    cfg = ZOO_FAMILIES[family][1]()
    batch = _tiny_eval_batch(cfg)
    model = build_two_stage(cfg, device=cuda, seed=5)
    chip_smoke.sharpen_frcnn(model, cfg, torch.from_numpy(batch.images).to(cuda),
                             torch.from_numpy(batch.img_shapes).to(cuda))
    path = str(tmp_path / f"{family}.pt2")
    export_model.save_program(export_model.export_eval_step(cfg, model, 2), path)
    got = export_model.run_program(export_model.load_program(path), batch)
    want = make_two_stage_eval_step(model, cfg, device=cuda)(batch)
    assert got.boxes.device.type == "cuda" and int(want.valid.sum()) > 0
    for f in ("valid", "labels", "anchor_idx"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("boxes", "scores"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=1e-6, atol=0)


def test_train_detector_two_ranks_on_the_card(cuda, tmp_path):
    """The model-zoo trainer's --mini run on two ranks sharing the card
    (gloo, torchrun's variables) leaves the checkpoint of the --mini run in
    one process: every tensor within 1e-4 of its max-abs, the same mAP,
    only rank 0 writing."""
    import json

    import torch_dist_workers as w
    from aod_meh_hua_torch.engine.checkpoint import load_checkpoint
    from aod_meh_hua_torch.tools import train_detector

    voc = _fixture_voc(tmp_path)
    argv = ["--family", "double_head_rcnn", "--mini", "--voc07", voc, "--epochs", "1"]
    train_detector.main(argv + ["--work-dir", str(tmp_path / "one")])
    ranks = w.run_ranks(w.trainer_on_one_card, 2, str(tmp_path / "out"),
                        argv + ["--work-dir", str(tmp_path / "two"), "--num-devices", "2"],
                        launcher_env=True, timeout=600)
    one = load_checkpoint(str(tmp_path / "one" / "double_head_rcnn_final.ckpt"))
    two = load_checkpoint(str(tmp_path / "two" / "double_head_rcnn_final.ckpt"))
    assert one.keys() == two.keys()
    for k, v in one.items():
        if v.is_floating_point():
            scale = max(v.abs().max().item(), 1e-30)
            assert (two[k] - v).abs().max().item() <= 1e-4 * scale, k
        else:
            assert torch.equal(two[k], v), k
    metrics = json.loads((tmp_path / "one" / "metrics.json").read_text())
    assert ranks[0] == ranks[1] and ranks[0][0]["mAP"] == metrics[0]["mAP"]
    assert len((tmp_path / "two" / "train_log.jsonl").read_text().splitlines()) == 1
