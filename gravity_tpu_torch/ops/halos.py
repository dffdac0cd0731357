"""Friends-of-friends (FoF) halo finding and the two-point correlation
function: the structure diagnostics of cosmological N-body outputs.

A copy of ``gravity_tpu/ops/halos.py`` (numpy and scipy, no JAX), kept in
this package so that it imports nothing of the JAX package. Host-side
analysis (scipy cKDTree pair enumeration and connected components): it
runs once on a snapshot, not in the hot loop, on plain arrays. Periodic
boxes use cKDTree's torus topology, so halos spanning the wrap seam are
linked correctly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class FofResult(NamedTuple):
    labels: np.ndarray  # (N,) halo id per particle, -1 = unbound/field
    n_halos: int
    halo_masses: np.ndarray  # (n_halos,) total mass, descending
    halo_sizes: np.ndarray  # (n_halos,) member counts, same order
    halo_centers: np.ndarray  # (n_halos, 3) mass-weighted centers


def _component_labels(n, pairs):
    """Connected-component label per node from an (E, 2) edge array —
    scipy's C implementation (a clustered snapshot yields millions of
    pairs; Python union-find loops would take minutes)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    if len(pairs) == 0:
        return np.arange(n, dtype=np.int64)
    data = np.ones(len(pairs), np.int8)
    graph = coo_matrix(
        (data, (pairs[:, 0], pairs[:, 1])), shape=(n, n)
    )
    _, labels = connected_components(graph, directed=False)
    return labels.astype(np.int64)


def friends_of_friends(
    positions,
    masses=None,
    *,
    linking_length: float,
    box: float = 0.0,
    min_members: int = 20,
) -> FofResult:
    """FoF halos: particles closer than ``linking_length`` are friends;
    halos are the connected components with >= ``min_members`` members
    (smaller groups and singletons are labelled -1, the field).

    ``linking_length`` is an absolute length — for the cosmological
    convention (b times the mean interparticle spacing, b ~ 0.2) pass
    ``b * box / n**(1/3)``. ``box > 0`` enables periodic (minimum-image)
    linking. Zero-mass particles (padding/merge donors) are excluded.
    Halos are ordered by descending mass; centers are mass-weighted
    means (computed in the frame of each halo's first member under
    periodicity, then wrapped back into the box).
    """
    from scipy.spatial import cKDTree

    pos = np.asarray(positions, np.float64)
    n_all = pos.shape[0]
    m = (
        np.ones(n_all) if masses is None
        else np.asarray(masses, np.float64)
    )
    live = m > 0
    idx_live = np.nonzero(live)[0]
    pos_l = pos[live]
    if box > 0.0:
        pos_l = np.mod(pos_l, box)
        # np.mod(-1e-17, box) returns exactly box; cKDTree rejects
        # coordinates == boxsize.
        pos_l[pos_l >= box] -= box
        tree = cKDTree(pos_l, boxsize=box)
    else:
        tree = cKDTree(pos_l)
    pairs = tree.query_pairs(linking_length, output_type="ndarray")
    roots = _component_labels(pos_l.shape[0], pairs)

    labels_all = np.full(n_all, -1, np.int64)
    uniq, inv, counts = np.unique(
        roots, return_inverse=True, return_counts=True
    )
    keep = counts >= min_members
    # Compact ids for kept groups only.
    group_of = np.full(uniq.size, -1, np.int64)
    group_of[keep] = np.arange(int(keep.sum()))
    glab = group_of[inv]  # (n_live,) group id or -1

    n_groups = int(keep.sum())
    m_l = m[live]
    masses_g = np.zeros(n_groups)
    sizes_g = np.zeros(n_groups, np.int64)
    centers_g = np.zeros((n_groups, 3))
    if n_groups:
        sel = glab >= 0
        np.add.at(masses_g, glab[sel], m_l[sel])
        np.add.at(sizes_g, glab[sel], 1)
        # Reference frame per group = its first member's position.
        sel_idx = np.nonzero(sel)[0]
        groups_sorted, first_pos = np.unique(
            glab[sel_idx], return_index=True
        )
        ref = np.zeros((n_groups, 3))
        ref[groups_sorted] = pos_l[sel_idx[first_pos]]
        d = pos_l[sel] - ref[glab[sel]]
        if box > 0.0:
            d = (d + box / 2) % box - box / 2  # minimum image
        np.add.at(
            centers_g, glab[sel], m_l[sel, None] * d
        )
        centers_g = ref + centers_g / masses_g[:, None]
        if box > 0.0:
            centers_g = np.mod(centers_g, box)

    order = np.argsort(-masses_g, kind="stable")
    if n_groups:
        rank = np.empty_like(order)
        rank[order] = np.arange(n_groups)
        labels_all[idx_live] = np.where(
            glab >= 0, rank[np.maximum(glab, 0)], -1
        )
    return FofResult(
        labels=labels_all,
        n_halos=n_groups,
        halo_masses=masses_g[order],
        halo_sizes=sizes_g[order],
        halo_centers=centers_g[order],
    )


def correlation_function(
    positions,
    *,
    box: float,
    r_bins=None,
    n_bins: int = 16,
    r_max: float = 0.0,
):
    """Two-point correlation function xi(r) in a periodic box (natural
    estimator) — the configuration-space twin of the P(k) estimator
    (`ops/spectra.py`).

    DD pair counts come from cKDTree.count_neighbors on the torus; the
    random-random term is analytic for a periodic uniform field:
    RR(r) = N(N-1)/2 * V_shell(r)/box^3, so xi = DD/RR - 1 with no
    random catalog. Returns (r_centers, xi, dd_counts) as numpy arrays.
    Bins with zero pairs report the estimator floor xi = -1 (a real,
    noise-dominated measurement); degenerate zero-volume bins hold NaN.
    ``r_max`` defaults to box/4 (shells must stay inside the
    minimum-image regime).
    """
    import numpy as np
    from scipy.spatial import cKDTree

    if box <= 0.0:
        raise ValueError(
            "correlation_function needs a periodic box (box > 0); for "
            "isolated snapshots use a random catalog estimator"
        )
    pos = np.mod(np.asarray(positions, np.float64), box)
    pos[pos >= box] -= box  # np.mod(-eps, box) == box; cKDTree rejects
    n = pos.shape[0]
    if r_bins is None:
        r_max = r_max or box / 4.0
        # Log bins from a quarter mean interparticle spacing.
        r_min = 0.25 * box / n ** (1.0 / 3.0)
        r_bins = np.geomspace(r_min, r_max, n_bins + 1)
    else:
        r_bins = np.asarray(r_bins, np.float64)
    if np.max(r_bins) > box / 2.0:
        raise ValueError("r_bins must stay below box/2 (minimum image)")

    tree = cKDTree(pos, boxsize=box)
    cum = tree.count_neighbors(tree, r_bins)  # ordered pairs + self
    dd = (cum[1:] - cum[:-1]) / 2.0  # unordered pairs per shell
    v_shell = 4.0 / 3.0 * np.pi * (r_bins[1:] ** 3 - r_bins[:-1] ** 3)
    rr = 0.5 * n * (n - 1) * v_shell / box**3
    with np.errstate(invalid="ignore", divide="ignore"):
        xi = np.where(rr > 0, dd / rr - 1.0, np.nan)
    r_centers = np.sqrt(r_bins[:-1] * r_bins[1:])
    return r_centers, xi, dd
