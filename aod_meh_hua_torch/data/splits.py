"""Active-learning split bookkeeping (host numpy).

A copy of aod_meh_hua_tpu/data/splits.py, every function, which mirrors
the reference's active_datasets.py:37-48 (get_X_L_0_prev), :102-135
(update_X_L with the zeroRate injection drawn with replacement and the
max-confidence tie-break) and the per-cycle X_L/X_U/Unc .npy files with
their cycle resume (tools/train_RetinaNet.py:144-145, 249-251). As in the
JAX package, complements are np.setdiff1d (sorted) where the reference
iterates a python set(): the same sets in a fixed order.
tests/test_torch_data.py holds the copy equal, RNG state included.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def init_split(
    num_images: int, x_l_0_size: int, rng: np.random.RandomState
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """get_X_L_0_prev: returns (X_L, X_U, X_all) with X_L/X_U sorted."""
    x_all = np.arange(num_images)
    rng.shuffle(x_all)
    x_l = np.sort(x_all[:x_l_0_size].copy())
    x_u = np.sort(x_all[x_l_0_size:x_l_0_size * 2].copy())
    return x_l, x_u, x_all


def update_labeled_set(
    uncertainty: np.ndarray,
    x_all: np.ndarray,
    x_l: np.ndarray,
    x_s_size: int,
    rng: np.random.RandomState,
    zero_rate: float = 0.0,
    max_conf: Optional[np.ndarray] = None,
    use_max_conf: str = "False",
) -> Tuple[np.ndarray, np.ndarray]:
    """update_X_L: acquire the top-x_s_size most-uncertain unlabeled images.

    With zero_rate > 0, a zero_rate fraction of the acquisition batch is
    drawn from images whose uncertainty is exactly 0 (HUA emits exact
    zeros for images with no confident objects) — picked at random
    (with replacement, as the reference does) or by min/max confidence.
    """
    uncertainty = np.asarray(uncertainty)
    all_x_u = np.setdiff1d(x_all, x_l)
    unc_u = uncertainty[all_x_u]
    order = unc_u.argsort()

    if zero_rate:
        zeros = (unc_u == 0).nonzero()[0]
        zero_size = int(x_s_size * zero_rate)
        if len(zeros) < zero_size:
            zero_size = len(zeros)
        nonzero_size = x_s_size - int(x_s_size * zero_rate)
        if use_max_conf != "False":
            assert max_conf is not None
            mc = np.asarray(max_conf)[all_x_u]
            mc_order = mc.argsort()
            zero_idx = mc_order[:zero_size] if use_max_conf == "min" else mc_order[-zero_size:]
        else:
            zero_idx = rng.choice(zeros, zero_size) if zero_size > 0 else zeros[:0]
        nonzero_idx = order[-nonzero_size:]
        x_s = np.concatenate((all_x_u[zero_idx], all_x_u[nonzero_idx]))
    else:
        x_s = all_x_u[order[-x_s_size:]]

    x_l_next = np.sort(np.concatenate((x_l, x_s)))
    all_x_u_next = np.setdiff1d(x_all, x_l_next)
    rng.shuffle(all_x_u_next)
    x_u_next = np.sort(all_x_u_next[:x_l_next.shape[0]])
    return x_l_next, x_u_next


def init_split_disjoint(
    num_images: int, x_l_0_size: int, rng: np.random.RandomState
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """get_X_L_0: X_U = everything not in X_L (the full-complement
    variant; get_X_L_0_prev scores only a same-sized slice)."""
    x_all = np.arange(num_images)
    rng.shuffle(x_all)
    x_l = np.sort(x_all[:x_l_0_size].copy())
    x_u = np.sort(x_all[x_l_0_size:].copy())
    return x_l, x_u, x_all


def update_labeled_set_reselect(
    uncertainty: np.ndarray, x_all: np.ndarray, x_l: np.ndarray, x_s_size: int,
    rng: np.random.RandomState,
) -> Tuple[np.ndarray, np.ndarray]:
    """update_X_L2: re-select the ENTIRE labeled set each cycle as the
    top (|X_L| + x_s_size) most-uncertain images over the whole pool
    (no monotone growth guarantee)."""
    uncertainty = np.asarray(uncertainty)
    x_l_next = np.sort(uncertainty.argsort()[-(x_s_size + len(x_l)):])
    x_u_next = np.setdiff1d(x_all, x_l_next)
    rng.shuffle(x_u_next)
    return x_l_next, np.sort(x_u_next)


def init_split_all(
    num_images: int, rng: np.random.RandomState
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """get_X_L_ALL (active_datasets.py:7-13): the fully-supervised
    control — X_L is the entire (shuffled-then-sorted) pool; X_U is the
    single trailing element of the shuffle."""
    x_all = np.arange(num_images)
    rng.shuffle(x_all)
    x_l = np.sort(x_all.copy())
    x_u = x_all[len(x_all) - 1:]
    return x_l, x_u, x_all


def init_split_double(
    num_images: int, x_l_0_size: int, rng: np.random.RandomState
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """get_X_L_0_Double (active_datasets.py:15-24): seed labeled set of
    2x X_L_0_size; X_U = the full complement."""
    x_all = np.arange(num_images)
    rng.shuffle(x_all)
    x_l = np.sort(x_all[: 2 * x_l_0_size].copy())
    x_u = np.sort(x_all[2 * x_l_0_size:].copy())
    return x_l, x_u, x_all


def update_labeled_set_plain(
    uncertainty: np.ndarray, x_all: np.ndarray, x_l: np.ndarray, x_s_size: int,
    rng: np.random.RandomState,
) -> Tuple[np.ndarray, np.ndarray]:
    """update_X_L_filter (active_datasets.py:151-163): plain top-K
    acquisition with no zeroRate injection (its `ratio` argument is
    unused in the reference too) — equivalent to update_X_L's else
    branch."""
    return update_labeled_set(uncertainty, x_all, x_l, x_s_size, rng, zero_rate=0.0)


def save_cycle_state(work_dir: str, cycle: int, x_l, x_u, uncertainty=None):
    """Persist the reference's per-cycle filenames (X_L_<c>.npy etc.)."""
    os.makedirs(work_dir, exist_ok=True)
    np.save(os.path.join(work_dir, f"X_L_{cycle}.npy"), x_l)
    np.save(os.path.join(work_dir, f"X_U_{cycle}.npy"), x_u)
    if uncertainty is not None:
        np.save(os.path.join(work_dir, f"Unc_{cycle}.npy"), uncertainty)


def load_cycle_state(work_dir: str, cycle: int):
    """ResumeCycle: load (X_L, X_U) saved at `cycle`; None if absent."""
    try:
        x_l = np.load(os.path.join(work_dir, f"X_L_{cycle}.npy"))
        x_u = np.load(os.path.join(work_dir, f"X_U_{cycle}.npy"))
    except FileNotFoundError:
        return None
    return x_l, x_u
