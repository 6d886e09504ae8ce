"""The active-learning cycle orchestrator.

Port of aod_meh_hua_tpu/al/loop.py:48-703 (`ALPaths`, `ALDriver`),
single-device, which mirrors the reference's tools/train_RetinaNet.py:
76-253: per cycle, write the split -> build a fresh detector -> train in
three runs (outer epoch 0 twice, then the final outer epoch once; each
run is epoch_ratio[0] inner epochs over X_L repeated x_l_repeat times;
the lr resets to base per run and steps x0.1 at lr_step_epoch of the
final run only) -> eval mAP -> per-cycle checkpoint -> score the pool ->
update_X_L with zeroRate -> persist the X_L/X_U/Unc .npy files; with the
cycle resume of ResumeCycle (mmdet/utils/functions.py:478), load_cycle,
and the mid-cycle resume of cfg.resume_from.

The device work is the port's steps (engine/train.py, engine/eval.py,
al/uncertainty.py score_pool); this loop is host Python and numpy. It
drives both families of the JAX driver's live path, MEH-RetinaNet and
MEH-SSD (the family branch of JAX al/loop.py:141-152,282-285: SSD warps
to its square canvas with std 1, augments its training images with
data/ssd_augment.py and freezes nothing). --load-cycle and --resume-from
read the port's checkpoints, the JAX package's flax-msgpack ones and the
reference's mmdet .pth (engine/checkpoint.py). baseline="ensemble" is
the deep-ensemble experiment (JAX al/loop.py:126-138, :387-436,
:646-661): each cycle also trains ensemble_size - 1 more members and
scores the pool with the ensemble MI (al/baselines.py) in place of HUA.

Across processes (JAX al/loop.py:80-276, :311-384, :410-500, on
parallel/): num_devices > 1 trains data parallel over a ("data",) mesh
of ranks, one device each, and fsdp > 1 ZeRO-3 over ("data", "fsdp");
each rank trains on its rows of the global batch, sweeps its
rank_indices slice of the pool and the test split, and the scores meet
in allgather_sum, the detections in collect_objects. Only rank 0 writes
artifacts. The family's other modes raise NotImplementedError with their
ROADMAP item.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

import aod_meh_hua_torch

from ..data.canvas_cache import open_canvas_cache
from ..data.loader import EvalLoader, TrainLoader
from ..data.pipeline import PipelineConfig
from ..data.ssd_augment import ssd_train_augment
from ..data.splits import init_split, load_cycle_state, save_cycle_state, update_labeled_set
from ..data.voc import VOC_CLASSES, ConcatVOC, VOCDataset
from ..engine import checkpoint
from ..engine.batch import EvalBatch
from ..engine.eval import detections_to_per_class, make_eval_step
from ..engine.train import create_train_state, make_train_step, set_learning_rate
from ..models.detector import build_retinanet
from ..models.ssd_detector import build_ssd
from ..parallel import (allgather_sum, barrier, collect_objects, gather_to_host,
                        init_distributed, make_mesh, make_mesh_2d, rank_indices, replicate,
                        shard_params_fsdp)
from ..parallel.launch import rank_device
from ..parallel.mesh import data_sharding, place_like
from ..utils.config import ALConfig, RetinaNetConfig, TrainConfig
from ..utils.device import resolve_device
from ..utils.env import collect_env, save_code
from ..utils.voc_eval import eval_map
from .baselines import score_pool_ensemble
from .uncertainty import _upload, score_pool


@dataclass
class ALPaths:
    voc07: str                 # .../VOC2007
    voc12: Optional[str]       # .../VOC2012 (None for voc07-only runs)
    work_dir: str
    trainval07: Optional[str] = None  # default: ImageSets/Main/trainval.txt
    trainval12: Optional[str] = None
    test07: Optional[str] = None      # default: ImageSets/Main/test.txt

    def __post_init__(self):
        j = os.path.join
        self.trainval07 = self.trainval07 or j(self.voc07, "ImageSets/Main/trainval.txt")
        if self.voc12:
            self.trainval12 = self.trainval12 or j(self.voc12, "ImageSets/Main/trainval.txt")
        self.test07 = self.test07 or j(self.voc07, "ImageSets/Main/test.txt")
        self.save_dir = j(self.work_dir, "model_save")


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


class ALDriver:
    """Runs the full AL experiment on one device per process (the card
    unless device="cpu")."""

    def __init__(
        self,
        model_cfg: RetinaNetConfig,
        train_cfg: TrainConfig,
        al_cfg: ALConfig,
        paths: ALPaths,
        pipeline: Optional[PipelineConfig] = None,
        validate: bool = True,
        name: str = "retinanet_meh",
        log: Optional[callable] = print,
        num_devices: Optional[int] = None,
        cache_dir: Optional[str] = "auto",
        distributed: bool = False,
        coordinator: Optional[str] = None,
        num_processes: Optional[int] = None,
        process_id: Optional[int] = None,
        fsdp: int = 1,
        baseline: Optional[str] = None,
        ensemble_size: int = 3,
        device="cuda",
    ):
        """cache_dir: decoded-canvas cache root ("auto" = <work_dir>/
        canvas_cache, None = off): eval/score sweeps decode each JPEG once
        per experiment and read the prepared canvas back on every later
        sweep.

        baseline="ensemble": the reference's deep-ensemble experiment
        (apis/CalEnsembleUnc.py:86-181) as a driver mode. Each cycle
        trains ensemble_size - 1 more independently seeded members on the
        same X_L with the same run schedule (the cycle's model is member
        0) and scores the pool with their sigmoid MI. The members are
        cycle-local and never snapshotted; they live on the driver's
        device and are freed once the pool is scored.

        distributed=True joins the process group (parallel/launch.py
        init_distributed: coordinator, num_processes and process_id, or
        the launcher's environment; NCCL on a card, gloo on the CPU);
        rank r runs on its local rank's card, or on the CPU.
        num_devices counts global devices, one per process (default
        under distributed: the world size); above 1 the train steps run
        data parallel over the ranks (the reference's DDP, apis/train.py:
        75-85) and the pool and eval sweeps rank-sliced (apis/test.py:
        197-315). batch_size and score_batch_size are GLOBAL and must
        divide by the data axis. The loaders give every rank the
        single-process batch stream, so a run on several ranks selects
        the images the single-process run selects.

        fsdp > 1 folds the ranks into a (num_devices/fsdp, fsdp) = (data,
        fsdp) mesh and shards parameters and momentum over fsdp (FSDP2,
        parallel/mesh.py shard_params_fsdp); batches split on data only.
        Beyond the reference, which is DDP only."""
        if baseline not in (None, "ensemble"):
            raise ValueError(f"unknown baseline {baseline!r}")
        if baseline == "ensemble" and al_cfg.use_max_conf != "False":
            raise ValueError("ensemble baseline emits no maxconf; "
                             "use_max_conf must stay 'False'")
        self.baseline = baseline
        self.ensemble_size = int(ensemble_size)
        family = getattr(model_cfg, "family", "retinanet")
        if family not in ("retinanet", "ssd"):
            _not_ported(f"the {family} family", "15")
        self.log = log or (lambda *a, **k: None)
        self.proc_id, self.proc_count = 0, 1
        if distributed:
            info = init_distributed(coordinator, num_processes, process_id, device=device)
            self.proc_id, self.proc_count = info["process_index"], info["process_count"]
            if num_devices is None:
                num_devices = info["global_devices"]
            device = rank_device(device)
            self.log(f"distributed: process {self.proc_id}/{self.proc_count}, "
                     f"{info['local_devices']} local / {info['global_devices']} global devices")
        self.is_main = self.proc_id == 0
        self.device = resolve_device(device)
        self.mesh = None
        self.fsdp = max(1, int(fsdp))
        if self.fsdp > 1 and (num_devices is None or num_devices <= 1):
            raise ValueError("fsdp > 1 requires num_devices > 1")
        if num_devices is not None and num_devices > 1:
            if num_devices != self.proc_count:
                raise ValueError(
                    f"num_devices {num_devices}: the port runs one device per process and "
                    f"{self.proc_count} are running; launch {num_devices} (torchrun, slurm, "
                    "mpi, or a CLI's --num-devices)")
            if num_devices % self.fsdp:
                raise ValueError(f"num_devices {num_devices} not divisible "
                                 f"by fsdp {self.fsdp}")
            n_data = num_devices // self.fsdp
            if train_cfg.batch_size % n_data:
                raise ValueError(
                    f"global batch_size {train_cfg.batch_size} not divisible "
                    f"by the data axis ({n_data} = num_devices/fsdp)")
            if al_cfg.score_batch_size % n_data:
                raise ValueError(
                    f"score_batch_size {al_cfg.score_batch_size} not divisible "
                    f"by the data axis ({n_data} = num_devices/fsdp)")
            kind = self.device.type
            self.mesh = (make_mesh_2d(n_data, self.fsdp, device_type=kind) if self.fsdp > 1
                         else make_mesh(num_devices, device_type=kind))
        self.cfg = model_cfg
        self.tcfg = train_cfg
        self.al = al_cfg
        self.paths = paths
        self.augment_fn = None
        if family == "ssd":
            # exact warp, caffe-style std 1 (Config_SSD.py:87,106); the
            # augment chain hands over float images, which prepare_sample
            # normalises on the host, so uint8 transport is eval/score only
            self.augment_fn = ssd_train_augment
            if pipeline is None:
                pipeline = PipelineConfig(img_scale=model_cfg.canvas, canvas=model_cfg.canvas,
                                          std=(1.0, 1.0, 1.0), keep_ratio=False,
                                          device_normalize=True)
        elif pipeline is None:
            pipeline = PipelineConfig(canvas=model_cfg.canvas, device_normalize=True)
        self.pipeline = pipeline
        self.validate = validate
        self.name = name
        self.rng = np.random.RandomState(train_cfg.seed)

        datasets = [VOCDataset(paths.trainval07, paths.voc07)]
        if paths.voc12:
            datasets.append(VOCDataset(paths.trainval12, paths.voc12))
        self.pool = ConcatVOC(datasets)
        self.val = VOCDataset(paths.test07, paths.voc07, test_mode=True) if validate else None

        if cache_dir == "auto":
            cache_dir = os.path.join(paths.work_dir, "canvas_cache")
        self.cache_dir = cache_dir
        self._caches: Dict[str, object] = {}
        if self.proc_count > 1:
            barrier("driver_ready")  # absorb import and dataset-build skew

        self._train_steps: Dict[str, callable] = {}
        self.model: Optional[torch.nn.Module] = None
        self.optimizer: Optional[torch.optim.SGD] = None
        self.step = 0  # train steps of the current cycle's model
        self.metrics: List[dict] = []
        # wall time of each phase: {"cycle", "phase", "seconds", "images"}
        self.timings: List[dict] = []
        # optional hook: model -> None, in place (e.g. a pretrained backbone)
        self.pretrained_loader = None

    # ----- step cache -----

    def _train_step(self, orientation: str):
        if orientation not in self._train_steps:
            self._train_steps[orientation] = make_train_step(
                self.model, self.cfg.for_orientation(orientation), self.optimizer,
                device=self.device, mesh=self.mesh)
        return self._train_steps[orientation]

    def _replicate(self, model: torch.nn.Module) -> torch.nn.Module:
        """Place a model on the mesh: replicated from rank 0 (data
        parallel), or ZeRO-3 sharded over fsdp when the mesh has it."""
        if self.mesh is None:
            return model
        if self.fsdp > 1:
            return shard_params_fsdp(model, self.mesh)
        return replicate(model, self.mesh)

    def _host_state(self, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
        """The full state dict, for checkpoints and the per-rank sweeps:
        gather-on-save under fsdp. COLLECTIVE under fsdp: every rank must
        call it, so keep the call OUTSIDE any is_main guard."""
        return gather_to_host(model) if self.fsdp > 1 else model.state_dict()

    def _sweep_model(self, model: Optional[torch.nn.Module] = None) -> torch.nn.Module:
        """The model a rank sweeps with: `model` (default the cycle's)
        itself, or under fsdp a plain copy of its gathered weights (the
        ranks' slices differ in batch count, so a sharded forward, whose
        all-gathers every rank must join, cannot run them). Collective
        under fsdp."""
        model = self.model if model is None else model
        if self.fsdp == 1:
            return model
        plain = self._init_model(0)
        plain.load_state_dict(self._host_state(model))
        return plain

    def _rank_slice(self, n: int) -> np.ndarray:
        """This rank's strided slice of a sweep (all of it alone)."""
        return rank_indices(n, self.proc_id, self.proc_count)

    # ----- phases -----

    def _init_model(self, seed: int) -> torch.nn.Module:
        build = build_ssd if self.cfg.family == "ssd" else build_retinanet
        return build(self.cfg, device=self.device, seed=seed)

    def _fresh_model(self, cycle: int, seed: Optional[int] = None,
                     weights: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """A fresh model (seed tcfg.seed + cycle, driver :156-162, unless
        `seed` is given; then `weights`, where given, loaded), placed on
        the mesh, and a fresh optimizer; the steps are rebuilt around
        them. Loading before the placement re-shards restored weights."""
        self.model = self._init_model(self.tcfg.seed + cycle if seed is None else seed)
        if self.pretrained_loader is not None:
            self.pretrained_loader(self.model)
        if weights is not None:
            self.model.load_state_dict(weights)
        self.model = self._replicate(self.model)
        self.optimizer = create_train_state(
            self.model, self.tcfg, frozen_stages=getattr(self.cfg, "frozen_stages", 0))
        self.step = 0
        self._train_steps.clear()

    def _param_names(self) -> List[str]:
        """The optimizer's parameters' names, in its order."""
        names = {id(p): n for n, p in self.model.named_parameters()}
        return [names[id(p)] for group in self.optimizer.param_groups for p in group["params"]]

    def _set_momentum(self, momentum: Dict[str, torch.Tensor]) -> None:
        """SGD momentum buffers by parameter name (the port's snapshot, or
        a JAX train state's optax trace), each placed as its parameter
        lies, replicated or sharded; frozen parameters, outside the
        optimizer, have none."""
        params = [p for group in self.optimizer.param_groups for p in group["params"]]
        for name, p in zip(self._param_names(), params):
            self.optimizer.state[p]["momentum_buffer"] = place_like(momentum[name], p)

    def _load_optimizer(self, state: dict) -> None:
        """A train-state snapshot's momentum into the optimizer. An older
        snapshot of the port holds torch's SGD state_dict instead, whose
        state is keyed by position in the optimizer's parameters."""
        momentum = state.get("momentum")
        if momentum is None:
            names = self._param_names()
            momentum = {names[i]: st["momentum_buffer"]
                        for i, st in state["optimizer"]["state"].items()}
        self._set_momentum(momentum)

    def _train_state(self) -> dict:
        """The snapshot of the train state: the full weights and the
        momentum by parameter name, gathered under fsdp (collective: every
        rank calls it)."""
        params = [p for group in self.optimizer.param_groups for p in group["params"]]
        momentum = {n: self.optimizer.state[p]["momentum_buffer"]
                    for n, p in zip(self._param_names(), params)
                    if "momentum_buffer" in self.optimizer.state[p]}
        return {"model": self._host_state(self.model), "momentum": gather_to_host(momentum),
                "step": self.step}

    def _train_run(self, x_l, run_seed: int, is_final_run: bool,
                   cycle: int = 0, run_idx: int = 0, start_epoch: int = 0,
                   snapshot: bool = True) -> None:
        loader = TrainLoader(
            self.pool, x_l, self.cfg, self.pipeline,
            batch_size=self.tcfg.batch_size, repeat=self.al.x_l_repeat,
            seed=run_seed, augment_fn=self.augment_fn,
            rows=data_sharding(self.mesh) if self.mesh is not None else (0, 1),
        )
        n_inner = self.tcfg.epoch_ratio[0]
        if self.proc_count > 1:
            barrier("train_run")  # align the ranks before the first step
        run_iter = 0  # warmup restarts per run (each run is a new runner)
        if start_epoch:
            # mid-cycle resume: replay the consumed RNG + warmup counter
            loader.burn_epochs(start_epoch)
            run_iter = start_epoch * len(loader)
        for inner in range(start_epoch, n_inner):
            lr = self.tcfg.lr * (0.1 if (is_final_run and inner >= self.tcfg.lr_step_epoch) else 1.0)
            set_learning_rate(self.optimizer, lr)
            t0, n_iter = time.time(), 0
            auxes = []  # device scalars; read once at the epoch's end
            for orientation, batch in loader:
                if run_iter < self.tcfg.warmup_iters:
                    # mmcv linear warmup: lr * (1 - (1 - k/N)(1 - ratio))
                    f = 1 - (1 - run_iter / self.tcfg.warmup_iters) * (1 - self.tcfg.warmup_ratio)
                    set_learning_rate(self.optimizer, lr * f)
                elif run_iter == self.tcfg.warmup_iters and self.tcfg.warmup_iters:
                    set_learning_rate(self.optimizer, lr)
                auxes.append(self._train_step(orientation)(batch))
                self.step += 1
                n_iter += 1
                run_iter += 1
            parts = ("loss", "loss_cls", "loss_bbox", "loss_meh")
            host = (torch.stack([torch.stack([a[k] for k in parts]) for a in auxes]).cpu().numpy()
                    if auxes else np.zeros((0, 4), np.float32))
            losses = host[:, 0].astype(np.float64)
            dt = time.time() - t0
            bad = np.nonzero(~np.isfinite(losses))[0]
            if bad.size:
                # the reference's NaN/Inf asserts (My_L_ssd_head.py:281),
                # epoch-granular (per-iter would wait on the device)
                i = int(bad[0])
                raise FloatingPointError(
                    f"non-finite loss {losses[i]} at epoch iter {i + 1} "
                    f"(cls {float(host[i, 1])}, bbox {float(host[i, 2])}, "
                    f"meh {float(host[i, 3])})"
                )
            loss_sum = float(losses.sum())
            self.log(
                f"    epoch done: {n_iter} iters, mean loss "
                f"{loss_sum / max(n_iter, 1):.4f}, lr {lr:g}, {dt:.1f}s"
            )
            self._log_train_entry({
                "mean_loss": loss_sum / max(n_iter, 1), "iters": n_iter,
                "lr": lr, "seconds": round(dt, 2),
                "img_per_s": round(n_iter * self.tcfg.batch_size / max(dt, 1e-9), 2),
            })
            self.timings.append({"cycle": cycle, "phase": "train_epoch", "seconds": dt,
                                 "images": n_iter * self.tcfg.batch_size})
            ival = self.tcfg.ckpt_interval if snapshot else 0
            if ival and ((inner + 1) % ival == 0 or inner + 1 == n_inner):
                # gather BEFORE the rank guard: under fsdp the host view
                # is assembled by a collective every rank runs (JAX :374-384)
                state = self._train_state()
                if self.is_main:
                    checkpoint.save_train_state(
                        self.paths.save_dir, state,
                        {"cycle": cycle, "run": run_idx, "epoch": inner,
                         "run_iter": run_iter, "name": self.name},
                    )

    def _train_ensemble_members(self, x_l, cycle: int, runs) -> List[torch.nn.Module]:
        """Train ensemble_size - 1 more members (the cycle's model is
        member 0): a fresh init per member from its own seed stream
        (seed + cycle + 10_000 m), the cycle's run schedule on the same
        X_L with run seeds seed + cycle * 100 + ri + 10_000 m, no
        snapshots. The cycle's model, optimizer and step count are put
        back afterwards."""
        primary = (self.model, self.optimizer, self.step, dict(self._train_steps))
        members = []
        try:
            for m in range(1, self.ensemble_size):
                t0 = time.time()
                self._fresh_model(cycle, seed=self.tcfg.seed + cycle + 10_000 * m)
                for ri in range(len(runs)):
                    self.log(f"  ensemble member {m + 1}/{self.ensemble_size}: "
                             f"train run {ri + 1}/{len(runs)}")
                    self._train_run(x_l, self.tcfg.seed + cycle * 100 + ri + 10_000 * m,
                                    ri == len(runs) - 1, cycle=cycle, run_idx=ri,
                                    snapshot=False)
                members.append(self.model)
                self.timings.append({"cycle": cycle, "phase": "ensemble_member", "member": m,
                                     "seconds": time.time() - t0, "images": 0})
        finally:
            self.model, self.optimizer, self.step, steps = primary
            self._train_steps.clear()
            self._train_steps.update(steps)
        return members

    def _score_pool_ensemble(self, x_l, cycle: int, runs):
        """The deep-ensemble sweep (CalEnsembleUnc.py:137-180): the members
        trained on the ranks like the cycle's model, the sweep rank-sliced
        like the production one (JAX :419-436). Returns (this rank's
        scores, zeros as maxconf); the driver merges the ranks'."""
        members = [self.model] + self._train_ensemble_members(x_l, cycle, runs)
        members = [self._sweep_model(m) for m in members]
        loader = EvalLoader(self.pool, self._rank_slice(len(self.pool)), self.pipeline,
                            batch_size=self.al.score_batch_size,
                            cache=self._canvas_cache("pool", self.pool))
        unc = score_pool_ensemble(members, self.cfg, loader, len(self.pool),
                                  device=self.device)
        return unc, np.zeros_like(unc)

    def _log_train_entry(self, entry: dict):
        """Append a jsonl train-log record (the TextLoggerHook analog);
        rank 0 only."""
        if not self.is_main:
            return
        os.makedirs(self.paths.work_dir, exist_ok=True)
        with open(os.path.join(self.paths.work_dir, "train_log.jsonl"), "a") as f:
            f.write(json.dumps(entry) + "\n")

    def _canvas_cache(self, name: str, dataset):
        """Per-dataset decoded-canvas cache (pool + val differ), built
        lazily and kept open across cycles. Across processes each rank has
        its own subdirectory (it only ever sweeps its slice; no create
        races), as in JAX :455-468."""
        if self.proc_count > 1:
            name = f"{name}_r{self.proc_id}"
        if name not in self._caches:
            cd = os.path.join(self.cache_dir, name) if self.cache_dir else None
            self._caches[name] = open_canvas_cache(cd, dataset, self.pipeline, log=self.log)
        return self._caches[name]

    def evaluate(self) -> float:
        """VOC07 11-point mAP of the current model on the test split; each
        rank detects on its slice, and every rank scores the gathered
        detections (JAX :469-520)."""
        assert self.val is not None
        model = self._sweep_model()  # collective under fsdp: before the rank's own loop
        steps = {}
        loader = EvalLoader(self.val, self._rank_slice(len(self.val)), self.pipeline,
                            batch_size=self.al.score_batch_size,
                            cache=self._canvas_cache("val", self.val))

        def stage(item):
            if item is None:
                return None
            o, b, bidx = item
            return o, EvalBatch(_upload(b.images, self.device), b.img_shapes,
                                b.scale_factors, np.asarray(b.valid)), bidx

        results, order = [], []
        # one-batch lookahead: upload k+1 while k's detections come back
        it = iter(loader)
        cur = stage(next(it, None))
        while cur is not None:
            orientation, batch, bidx = cur
            if orientation not in steps:
                steps[orientation] = make_eval_step(model, self.cfg.for_orientation(orientation),
                                                    device=self.device)
            dets = steps[orientation](batch)
            cur = stage(next(it, None))
            results.extend(detections_to_per_class(dets, self.cfg.num_classes, batch.valid))
            order.extend(bidx.tolist())
        if self.proc_count > 1:
            parts = collect_objects(self.paths.work_dir, "eval", (results, order))
            results = [r for res, _ in parts for r in res]
            order = [i for _, o in parts for i in o]
        annotations = [self.val.get_ann_info(i) for i in order]
        out = eval_map(results, annotations, iou_thr=0.5, mode="11points")
        return out["mAP"]

    # ----- the main loop -----

    def run(self, resume_cycle: int = -1, load_cycle: int = -1,
            resume_from: Optional[str] = None):
        """resume_from: a save_dir (or train_state.ckpt) written by the
        epoch snapshots — resumes training inside the interrupted cycle at
        the next epoch, bit-identical to the uninterrupted run.
        resume_cycle is the cycle-granular restart (ResumeCycle)."""
        os.makedirs(self.paths.work_dir, exist_ok=True)
        if self.is_main:
            try:
                save_code(self.paths.work_dir)  # SaveCode (functions.py:103-116)
            except OSError as e:
                self.log(f"code snapshot skipped: {e}")  # it must never block training
        mid = None  # progress dict for a mid-cycle resume
        if resume_from:
            d = resume_from if os.path.isdir(resume_from) else os.path.dirname(resume_from)
            with open(os.path.join(d, "train_state.json")) as f:
                mid = json.load(f)
            mid["dir"] = d
            resume_cycle = mid["cycle"]
        x_l, x_u, x_all = init_split(len(self.pool), self.al.x_l_0_size, self.rng)
        if self.is_main:
            save_cycle_state(self.paths.work_dir, 0, x_l, x_u)
        resumed = resume_cycle < 0

        for cycle in self.al.cycles:
            if not resumed:
                if cycle < resume_cycle:
                    continue
                loaded = load_cycle_state(self.paths.work_dir, resume_cycle)
                if loaded is None:
                    raise FileNotFoundError(f"no saved state for cycle {resume_cycle}")
                x_l, x_u = loaded
                resumed = True

            t_cycle = time.time()
            self.log(f"== cycle {cycle}: |X_L|={len(x_l)} |X_U|={len(x_u)} ==")
            weights, state = None, None
            if load_cycle >= 0:
                path = checkpoint.cycle_ckpt_path(self.paths.save_dir, self.name, load_cycle,
                                                  self.tcfg.epoch_ratio[0])
                weights = checkpoint.load_model_state_dict(path, self.cfg.family)
                self.log(f"  loaded params from {path}")
            if mid is not None and cycle == mid["cycle"]:
                # every rank loads the snapshot; _fresh_model re-places it
                state, _ = checkpoint.load_train_state(mid["dir"])
                weights = state["model"]
            self._fresh_model(cycle, weights=weights)

            # three training runs: outer 0 twice, final outer once
            runs = []
            for outer in range(self.tcfg.outer_epoch):
                n_runs = 2 if outer == 0 else 1
                for r in range(n_runs):
                    runs.append((outer, r))

            start_run, start_epoch = 0, 0
            if state is not None:
                self._load_optimizer(state)
                self.step = int(state["step"])
                start_run, start_epoch = mid["run"], mid["epoch"] + 1
                if start_epoch >= self.tcfg.epoch_ratio[0]:
                    start_run, start_epoch = start_run + 1, 0
                self.log(f"  resumed mid-cycle at run {start_run + 1}, "
                         f"epoch {start_epoch + 1}")
                mid = None

            for ri, (outer, r) in enumerate(runs):
                if ri < start_run:
                    continue
                is_final = ri == len(runs) - 1
                self.log(f"  train run {ri + 1}/{len(runs)} (outer {outer})")
                self._train_run(
                    x_l, self.tcfg.seed + cycle * 100 + ri, is_final,
                    cycle=cycle, run_idx=ri,
                    start_epoch=start_epoch if ri == start_run else 0,
                )

            if self.validate:
                t0 = time.time()
                mAP = self.evaluate()
                self.timings.append({"cycle": cycle, "phase": "eval",
                                     "seconds": time.time() - t0, "images": len(self.val)})
                self.log(f"  cycle {cycle} VOC mAP: {mAP:.4f}")
                self.metrics.append({"cycle": cycle, "mAP": mAP, "n_labeled": int(len(x_l))})
                if self.is_main:
                    with open(os.path.join(self.paths.work_dir, "metrics.json"), "w") as f:
                        json.dump(self.metrics, f, indent=2)

            host = self._host_state(self.model)  # gather-on-save, before the guard
            if self.is_main:
                checkpoint.save_cycle_checkpoint(
                    self.paths.save_dir, self.name, cycle, self.tcfg.epoch_ratio[0], host,
                    meta={"version": aod_meh_hua_torch.__version__,
                          "CLASSES": list(VOC_CLASSES), "cycle": cycle,
                          "n_labeled": int(len(x_l)), "family": self.cfg.family,
                          "env": collect_env()},
                )

            if cycle != self.al.cycles[-1]:
                self.log("  scoring pool ...")
                t0 = time.time()
                if self.baseline == "ensemble":
                    unc, mconf = self._score_pool_ensemble(x_l, cycle, runs)
                else:
                    loader = EvalLoader(
                        self.pool, self._rank_slice(len(self.pool)), self.pipeline,
                        batch_size=self.al.score_batch_size,
                        cache=self._canvas_cache("pool", self.pool))
                    unc, mconf = score_pool(self._sweep_model(), self.cfg, loader,
                                            len(self.pool), rng=self.rng, device=self.device)
                if self.proc_count > 1 and (self.baseline == "ensemble"
                                            or self.cfg.hua.pool != "Random"):
                    # each rank filled its slice: the sum is the whole pool
                    unc, mconf = allgather_sum(unc), allgather_sum(mconf)
                dt = time.time() - t0
                self.timings.append({"cycle": cycle, "phase": "score",
                                     "seconds": dt, "images": len(self.pool)})
                self.log(f"  pool scored: {len(self.pool)} imgs in {dt:.1f}s "
                         f"({len(self.pool) / dt:.1f} img/s)")
                x_l, x_u = update_labeled_set(
                    unc, x_all, x_l, self.al.x_s_size, self.rng,
                    zero_rate=self.al.zero_rate, max_conf=mconf,
                    use_max_conf=self.al.use_max_conf,
                )
                if self.is_main:
                    save_cycle_state(self.paths.work_dir, cycle + 1, x_l, x_u, unc)
            self.timings.append({"cycle": cycle, "phase": "cycle",
                                 "seconds": time.time() - t_cycle, "images": 0})
        return self.metrics
