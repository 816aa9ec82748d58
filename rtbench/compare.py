"""The numbers that decide ``correct``: the program's answers against the
reference's, each number a share or an error that does not grow with the
tile, so that a limit set at one size reads the same at another.

Tiles (labels, boxes and features of one tile):
  * ``mask_px_share``: pixels whose foreground status differs, over all pixels;
  * ``objects_off_share``: objects (of either side) with a pixel whose label
    differs, over the reference's objects;
  * ``boxes_off_share``: ROI rows whose box differs, over the rows of the
    longer list;
  * ``feat_err_max`` and ``feat_err_median``: over the rows whose boxes agree,
    each row's largest feature error relative to max(|reference|,
    FEATURE_FLOOR): the largest, and the median.
A number with nothing to compare reads 0.
"""
from __future__ import annotations

import numpy as np

FEATURE_FLOOR = 1e-3


def labels_numbers(got: np.ndarray, want: np.ndarray) -> dict:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return {"mask_px_share": 1.0, "objects_off_share": 1.0}
    px = float(np.count_nonzero((got >= 0) != (want >= 0))) / want.size
    off = got != want
    ids = np.union1d(np.unique(got[off]), np.unique(want[off]))
    n_ref = max(np.unique(want[want >= 0]).size, 1)
    return {"mask_px_share": px, "objects_off_share": float(np.count_nonzero(ids >= 0)) / n_ref}


def feature_errors(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Each row's largest relative feature error."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return np.array([np.inf])
    err = np.abs(got - want) / np.maximum(np.abs(want), FEATURE_FLOOR)
    err = np.where(np.isnan(err), np.inf, err)
    return err.max(axis=-1, initial=0.0).reshape(-1)


def tile_numbers(got: dict, want: dict) -> dict:
    out = labels_numbers(got["labels"], want["labels"])
    gb, wb = np.asarray(got["boxes"]), np.asarray(want["boxes"])
    k = min(len(gb), len(wb))
    same = np.all(gb[:k] == wb[:k], axis=1) if k else np.zeros(0, bool)
    out["boxes_off_share"] = float(max(len(gb), len(wb)) - np.count_nonzero(same)) / max(
        len(gb), len(wb), 1)
    rows = feature_errors(np.asarray(got["features"])[:k][same],
                          np.asarray(want["features"])[:k][same])
    out["feat_err_max"] = float(rows.max()) if rows.size else 0.0
    out["feat_err_median"] = float(np.median(rows)) if rows.size else 0.0
    return out


def worst(readings: list[dict]) -> dict:
    """The largest reading of each number over a run's comparisons (NaN
    reads as infinite)."""
    out: dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), float("inf") if np.isnan(v) else v)
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every limit named, every number
    at or under its limit; a number the run did not read reads 0."""
    checks = {name: {"value": float(numbers.get(name, 0.0)), "limit": float(lim)}
              for name, lim in sorted(limits.items())}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
