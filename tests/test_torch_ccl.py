"""The port's block-based CCL decomposition on the CPU.

``ref.ccl_blocked`` is the plain mirror of ``csrc/ccl.cu``'s three phases
(tiles labelled alone with their global root indices, unions across tile
borders, compression to the roots), with the unions of each phase run
interleaved as the card's threads race on the forest. The kernel runs only
on the card, so the decomposition itself is checked here: against the
union-find oracle ``ccl_unionfind_host`` of both packages and the JAX
package's Pallas kernel in interpret mode, on tile sizes that do not divide
the mask, 1xN and Nx1 masks, empty and full masks, the snake, random masks
at densities 0.2 to 0.6, and several union orders. Labels are integers, so
every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ref as jref
from repro.kernels.ccl import ccl_pallas
from repro_torch.kernels import ref


def _snake(h, w):
    m = np.zeros((h, w), bool)
    m[::2, :] = True
    for r in range(1, h, 2):
        m[r, -1 if (r // 2) % 2 == 0 else 0] = True
    return m


def _mask(case, h, w, seed=0):
    if case == "snake":
        return _snake(h, w)
    if case == "empty":
        return np.zeros((h, w), bool)
    if case == "full":
        return np.ones((h, w), bool)
    if case == "checker":
        return np.indices((h, w)).sum(0) % 2 == 0
    return np.random.default_rng(seed + h * w).random((h, w)) < float(case)


def _oracles(m):
    want = jref.ccl_unionfind_host(m)
    np.testing.assert_array_equal(ref.ccl_unionfind_host(m), want)
    return want


CASES = [
    (case, h, w)
    for case in ("0.2", "0.4", "0.5", "0.6", "snake")
    for h, w in ((37, 53), (32, 64), (48, 20))
] + [
    ("full", 40, 45), ("empty", 33, 31), ("checker", 35, 34), ("full", 1, 97),
    ("0.6", 1, 97), ("0.6", 97, 1), ("full", 97, 1), ("snake", 2, 70),
]


@pytest.mark.parametrize("tile", [(32, 32), (5, 7), (8, 12)])
@pytest.mark.parametrize("case,h,w", CASES)
def test_blocked_matches_union_find_oracles(case, h, w, tile):
    """Tiles of 32x32 (the kernel's), and 5x7 and 8x12, which divide none of
    the shapes; 32 unions in flight."""
    m = _mask(case, h, w)
    np.testing.assert_array_equal(ref.ccl_blocked(m, tile=tile), _oracles(m))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("case", ["0.5", "0.6", "snake", "full"])
def test_blocked_is_the_same_in_every_union_order(case, seed):
    """The unions' order and their interleaving change the forest, never the
    roots: the labels equal the oracle's whichever thread wins each race."""
    m = _mask(case, 41, 46, seed=seed)
    want = _oracles(m)
    for lanes in (1, 4, 64):
        got = ref.ccl_blocked(m, tile=(6, 8), seed=seed, lanes=lanes)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case,h,w", [("0.5", 37, 53), ("snake", 21, 30), ("0.6", 1, 70),
                                      ("0.6", 70, 1), ("full", 40, 40)])
def test_blocked_matches_pallas_interpret(case, h, w):
    m = _mask(case, h, w)
    want = np.asarray(ccl_pallas(jnp.asarray(m), max_iters=10_000, block_h=16, block_w=16,
                                 interpret=True))
    np.testing.assert_array_equal(ref.ccl_blocked(m, tile=(16, 16)), want)
    np.testing.assert_array_equal(ref.ccl_blocked(m), want)


@pytest.mark.parametrize("case", ["0.4", "snake", "full", "checker"])
def test_local_phase_labels_each_tile_by_its_global_minimum(case):
    """After phase 1 each pixel holds the global flat index of its component's
    minimum inside its own tile, which is what the oracle gives the tile
    alone, moved to global indices."""
    h, w, th, tw = 45, 50, 16, 12
    m = _mask(case, h, w)
    got = ref.ccl_blocked_local(m, tile=(th, tw))
    for ty0 in range(0, h, th):
        for tx0 in range(0, w, tw):
            sub = m[ty0:ty0 + th, tx0:tx0 + tw]
            lab = jref.ccl_unionfind_host(sub).astype(np.int64)
            sw = sub.shape[1]
            want = np.where(lab >= 0, (ty0 + lab // sw) * w + tx0 + lab % sw, -1)
            np.testing.assert_array_equal(got[ty0:ty0 + th, tx0:tx0 + tw], want)


@pytest.mark.parametrize("h,w", [(64, 64), (70, 45), (1, 100)])
def test_border_pairs_on_a_full_mask_are_one_per_tile_edge(h, w):
    """The skip rule leaves one union per shared tile edge on a full mask
    (the first pixel of each edge), where every pixel of the edge would
    otherwise race on the same two roots."""
    th = tw = 16
    nty, ntx = -(-h // th), -(-w // tw)
    pairs = ref.ccl_blocked_border_pairs(np.ones((h, w), bool), tile=(th, tw))
    assert len(pairs) == (nty - 1) * ntx + (ntx - 1) * nty
    assert all(a > b >= 0 for a, b in pairs)
