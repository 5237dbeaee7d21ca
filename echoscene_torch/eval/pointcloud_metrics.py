"""Object-level point-cloud metrics: chamfer, EMD, MMD / COV / 1-NN, JSD.

Port of echoscene_tpu/eval/pointcloud_metrics.py (reference
scripts/compute_mmd_cov_1nn.py:12-350).  Conventions kept:
  * chamfer per pair = mean of squared nearest distances, both directions
    summed (:88);
  * EMD = mean matched Euclidean distance (:48), exact on the host
    (`emd_exact`, Hungarian) or by a fixed-iteration auction on the device
    (`emd_auction`, JAX's fixed-iteration auction, which is not a bound:
    it can fall below the exact EMD, see `_auction_emd_batch`);
  * MMD / COV from the (ref x sample) matrix transposed (:204-214);
  * 1-NN two-sample accuracy with +inf diagonal (:154-183).

Chamfer on CUDA tensors runs kernel K4 (`kernels/chamfer.py`) in both
directions; on CPU tensors it takes the plain Gram-matrix form.  Inputs are
numpy arrays or tensors: numpy inputs go to `device` (the card by default),
tensors are used where they lie.  Results come back as numpy, as in JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..kernels import chamfer as k4


def _tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.float().contiguous()
    return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)


# --- chamfer ---------------------------------------------------------------
def chamfer_parts(a: torch.Tensor, b: torch.Tensor):
    """a: (B, N, 3), b: (B, M, 3) -> per-point squared NN distances (B, N),
    (B, M).  CUDA: K4 both ways; CPU: its plain version, the Gram matrix
    |a|^2 + |b|^2 - 2 a b^T clamped at 0 (distChamfer :12-22), min over
    targets, once each way."""
    return k4.nn_distance_oneway(a, b), k4.nn_distance_oneway(b, a)


def chamfer_distance(a, b, device="cuda") -> np.ndarray:
    """(B,) chamfer = mean_n d(a_n -> b) + mean_m d(b_m -> a), squared."""
    dl, dr = chamfer_parts(_tensor(a, device), _tensor(b, device))
    return (dl.mean(dim=1) + dr.mean(dim=1)).cpu().numpy()


# --- EMD -------------------------------------------------------------------
def emd_exact(a, b) -> np.ndarray:
    """Hungarian EMD per pair (emd_approx :35-52); host-side scipy."""
    from scipy.optimize import linear_sum_assignment
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    out = np.zeros(a.shape[0], np.float64)
    for i in range(a.shape[0]):
        d = np.linalg.norm(a[i][:, None, :] - b[i][None, :, :], axis=-1)
        r, c = linear_sum_assignment(d)
        out[i] = d[r, c].mean()
    return out


@torch.no_grad()
def _auction_emd_batch(a: torch.Tensor, b: torch.Tensor, iters: int = 50,
                       eps_scale: float = 0.02) -> torch.Tensor:
    """JAX's `_auction_emd_single` over a batch of pairs (B, n, 3): a fixed
    number of auction rounds in which every row bids for its cheapest column
    and each column goes to its lowest-cost bidder (ties to the lower row),
    then unassigned columns take their nearest row.  As in JAX, a row keeps
    every column it has won, so the final matching need not be a
    permutation and the result can fall below the exact EMD (83-93% of it
    on random 64-point clouds), although JAX's docstring calls it an upper
    bound.  The column-wise winner is found by scatter-min over the bids
    instead of JAX's (n, n) masked matrix: the same argmin, O(n) memory.

    The auction is chaotic: a last-bit change in a distance or in eps can
    flip a near-tied bid and move the result by a few percent (JAX's own
    jitted and eager runs of `_auction_emd_single` differ so on random
    clouds).  So every step here is elementwise or exact (min, argmin,
    top-2, scatter-min), and eps is f32(eps_scale) times a float64 mean
    rounded to f32: the result is the same on the CPU and on the card up to
    the final mean's summation order, and equals JAX's wherever the
    distances and their mean are exact in f32."""
    bsz, n = a.shape[:2]
    # the three squares summed in a fixed order, one op at a time, and the
    # square root taken in float64: f32 sqrt on the card is not correctly
    # rounded (1-ulp differences from the CPU), its float64 sqrt rounded to
    # f32 is
    diff = [a[:, :, None, k] - b[:, None, :, k] for k in range(3)]
    s = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
    del diff
    d = torch.sqrt(s.double()).float()
    del s
    eps = eps_scale * d.double().mean(dim=(1, 2)).float()
    prices = torch.zeros((bsz, n), dtype=d.dtype, device=d.device)
    owner = torch.full((bsz, n), -1, dtype=torch.long, device=d.device)
    rows = torch.arange(n, device=d.device).expand(bsz, n)
    inf = torch.full((bsz, n), float("inf"), dtype=d.dtype, device=d.device)
    for _ in range(iters):
        cost = d + prices[:, None, :]
        best_j = cost.argmin(dim=2)
        two = cost.topk(2, dim=2, largest=False).values
        bid = two[..., 0]
        bid_inc = two[..., 1] - bid + eps[:, None]
        col_min = inf.scatter_reduce(1, best_j, bid, "amin")
        has_bid = torch.isfinite(col_min)
        is_low = bid == col_min.gather(1, best_j)
        win_row = torch.full_like(owner, n).scatter_reduce(
            1, best_j, torch.where(is_low, rows, n), "amin")
        win_row = torch.where(has_bid, win_row, 0)
        owner = torch.where(has_bid, win_row, owner)
        prices = torch.where(has_bid, prices + bid_inc.gather(1, win_row),
                             prices)
    owner = torch.where(owner < 0, d.argmin(dim=1), owner)
    return d.gather(1, owner[:, None, :])[:, 0, :].mean(dim=1)


def emd_auction(a, b, device="cuda") -> np.ndarray:
    """(B,) approximate EMD by the auction, computed on the device."""
    return _auction_emd_batch(_tensor(a, device),
                              _tensor(b, device)).cpu().numpy()


# --- pairwise matrices + MMD/COV/1-NN -------------------------------------
def pairwise_cd_emd(sample_pcs, ref_pcs, batch_size: int = 32,
                    emd_fn=emd_exact, device="cuda"):
    """(N_sample, N_ref) chamfer + EMD matrices (_pairwise_EMD_CD_
    :110-150), in JAX's loop order: one chamfer and one EMD call per sample
    cloud and batch of references.  The clouds move to the device once."""
    sample = _tensor(sample_pcs, device)
    ref = _tensor(ref_pcs, device)
    ns, nr = sample.shape[0], ref.shape[0]
    all_cd = np.zeros((ns, nr), np.float64)
    all_emd = np.zeros((ns, nr), np.float64)
    for i in range(ns):
        for rb in range(0, nr, batch_size):
            re = min(nr, rb + batch_size)
            ref_b = ref[rb:re]
            s_exp = sample[i].expand((re - rb,) + sample[i].shape).contiguous()
            all_cd[i, rb:re] = chamfer_distance(s_exp, ref_b)
            all_emd[i, rb:re] = emd_fn(s_exp, ref_b)
    return all_cd, all_emd


def lgan_mmd_cov(all_dist: np.ndarray) -> Dict[str, float]:
    """all_dist: (N_sample, N_ref) (:186-198)."""
    min_from_smp = all_dist.min(axis=1)
    min_idx = all_dist.argmin(axis=1)
    min_val = all_dist.min(axis=0)
    return {
        "lgan_mmd": float(min_val.mean()),
        "lgan_cov": float(len(np.unique(min_idx)) / all_dist.shape[1]),
        "lgan_mmd_smp": float(min_from_smp.mean()),
    }


def knn_two_sample(Mxx, Mxy, Myy, k: int = 1) -> Dict[str, float]:
    """1-NN two-sample test accuracy (:154-183)."""
    n0, n1 = Mxx.shape[0], Myy.shape[0]
    label = np.concatenate([np.ones(n0), np.zeros(n1)])
    M = np.block([[Mxx, Mxy], [Mxy.T, Myy]]).astype(np.float64)
    np.fill_diagonal(M, np.inf)
    idx = np.argsort(M, axis=0)[:k]      # smallest k per column
    count = label[idx].sum(axis=0)
    pred = (count >= k / 2.0).astype(np.float64)
    tp = float((pred * label).sum())
    fp = float((pred * (1 - label)).sum())
    fn = float(((1 - pred) * label).sum())
    tn = float(((1 - pred) * (1 - label)).sum())
    return {
        "tp": tp, "fp": fp, "fn": fn, "tn": tn,
        "precision": tp / (tp + fp + 1e-10),
        "recall": tp / (tp + fn + 1e-10),
        "acc_t": tp / (tp + fn + 1e-10),
        "acc_f": tn / (tn + fp + 1e-10),
        "acc": float((pred == label).mean()),
    }


def compute_all_metrics(sample_pcs, ref_pcs, batch_size: int = 32,
                        emd_fn=emd_exact, device="cuda") -> Dict[str, float]:
    """MMD/COV/1-NN over CD and EMD (:201-229)."""
    sample = _tensor(sample_pcs, device)
    ref = _tensor(ref_pcs, device)
    results: Dict[str, float] = {}
    M_rs_cd, M_rs_emd = pairwise_cd_emd(ref, sample, batch_size, emd_fn)
    for name, M in (("CD", M_rs_cd), ("EMD", M_rs_emd)):
        for k, v in lgan_mmd_cov(M.T).items():
            results[f"{k}-{name}"] = v
    M_rr_cd, M_rr_emd = pairwise_cd_emd(ref, ref, batch_size, emd_fn)
    M_ss_cd, M_ss_emd = pairwise_cd_emd(sample, sample, batch_size, emd_fn)
    for name, (Mrr, Mrs, Mss) in (("CD", (M_rr_cd, M_rs_cd, M_ss_cd)),
                                  ("EMD", (M_rr_emd, M_rs_emd, M_ss_emd))):
        for k, v in knn_two_sample(Mrr, Mrs, Mss, 1).items():
            if "acc" in k:
                results[f"1-NN-{name}-{k}"] = v
    return results


# --- JSD (host numpy) ------------------------------------------------------
def unit_cube_grid(resolution: int, clip_sphere: bool = False):
    """(:235-253)."""
    spacing = 1.0 / float(resolution - 1)
    ax = np.arange(resolution) * spacing - 0.5
    grid = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1)
    grid = grid.reshape(-1, 3).astype(np.float32)
    if clip_sphere:
        grid = grid[np.linalg.norm(grid, axis=1) <= 0.5]
    return grid, spacing


def entropy_of_occupancy_grid(pclouds, resolution: int,
                              in_sphere: bool = False):
    """(:270-308) using a vectorised nearest-cell assignment."""
    from scipy.stats import entropy
    grid, _ = unit_cube_grid(resolution, in_sphere)
    counters = np.zeros(len(grid))
    bernoulli = np.zeros(len(grid))
    for pc in pclouds:
        d = (-2 * pc @ grid.T + np.sum(pc ** 2, -1)[:, None]
             + np.sum(grid ** 2, -1)[None, :])
        idx = np.argmin(d, axis=1)
        np.add.at(counters, idx, 1)
        bernoulli[np.unique(idx)] += 1
    n = float(len(pclouds))
    acc = sum(entropy([g / n, 1.0 - g / n]) for g in bernoulli if g > 0)
    return acc / len(counters), counters


def jsd_between_point_cloud_sets(sample_pcs, ref_pcs,
                                 resolution: int = 28) -> float:
    """(:256-268, 314-331)."""
    from scipy.stats import entropy
    p = entropy_of_occupancy_grid(np.asarray(sample_pcs), resolution, True)[1]
    q = entropy_of_occupancy_grid(np.asarray(ref_pcs), resolution, True)[1]
    p = p / p.sum()
    q = q / q.sum()
    m = (p + q) / 2.0
    return float(entropy(m, base=2)
                 - (entropy(p, base=2) + entropy(q, base=2)) / 2.0)
