"""Neighbor-list construction on fixed-shape padded arrays.

A fixed-shape redesign of the reference's linked-cell + neighbor-list machinery
(ref: main.F90:277-477).  Instead of ragged linked lists we build:

  * an *extended* atom set: the N owned atoms followed by ghost periodic
    images, described by (owner, shift) tables.  Ghost positions are always
    recomputed as ``pos[owner] + shift @ H.T`` *inside* the differentiated
    energy function, so `jax.grad` automatically performs the ghost-force
    copy-back reduction that the reference implements by hand as
    COPYATOMS(MODE_CPBK) (ref: comm.F90:74-78, pot.F90:74).

  * fixed-capacity neighbor index arrays:
      - bonded list   (N, kb)  within the per-pair sigma-bond cutoff rc
        (ref: NEIGHBORLIST main.F90:321-417, cap MAXNEIGHBS module.F90:81)
      - nonbonded list (N, knb) within the taper cutoff rctap
        (ref: GetNonbondingPairList main.F90:420-477, cap MAXNEIGHBS10)

Padding uses index -1 with a validity mask derived from per-row counts.
Overflow is detected (count > capacity) like the reference's error traps
(ref: main.F90:402-407, qeq.F90:248-252) but surfaced as data so the host
driver can recompile with a larger capacity instead of aborting.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class ImageTable(NamedTuple):
    """Mapping from extended index -> (owning atom, periodic shift)."""
    owner: jax.Array   # (M,) int32, m % N
    shift: jax.Array   # (M, 3) shift in lattice-vector units
    nimg: tuple        # images per axis (static)

    @property
    def n_own(self) -> int:
        """Number of owned atoms (ext rows are S repeats of them)."""
        s = 1
        for k in self.nimg:
            s *= 2 * k + 1
        return self.owner.shape[0] // s

    @property
    def n_images(self) -> int:
        s = 1
        for k in self.nimg:
            s *= 2 * k + 1
        return s

    def owner_of(self, idx):
        """Owner of extended index, computed arithmetically (owner[m] = m % N
        by construction): `idx % N` needs no gather."""
        if self.n_images == 1:
            return idx
        return idx % jnp.int32(self.n_own)


def make_image_table(n: int, nimg=(1, 1, 1), dtype=jnp.float64) -> ImageTable:
    """All periodic images with |s_k| <= nimg_k; the zero shift comes first so
    ext index m < n is the owned atom m itself."""
    rng = [np.arange(-k, k + 1) for k in nimg]
    shifts = np.stack(np.meshgrid(*rng, indexing="ij"), axis=-1).reshape(-1, 3)
    # put the zero shift first
    order = np.argsort((shifts != 0).any(axis=1), kind="stable")
    shifts = shifts[order]
    S = shifts.shape[0]
    owner = np.tile(np.arange(n, dtype=np.int32), S)
    shift = np.repeat(shifts, n, axis=0)
    return ImageTable(jnp.asarray(owner), jnp.asarray(shift, dtype), tuple(nimg))


def nimg_for_cutoff(H: np.ndarray, rcut: float) -> tuple:
    """Images per axis needed so every neighbor within rcut has a ghost.

    Uses the perpendicular distances between opposite box faces.
    """
    H = np.asarray(H)
    inv = np.linalg.inv(H)
    # row k of inv has norm 1/d_k where d_k is the face spacing
    d = 1.0 / np.linalg.norm(inv, axis=0)
    return tuple(int(np.ceil(rcut / dk)) for dk in d)


def ext_positions(pos, H, img: ImageTable):
    """Positions of the extended set; differentiable in pos (ghost forces
    flow back to owners through this gather)."""
    return pos[img.owner] + img.shift.astype(pos.dtype) @ H.T


class Neighbors(NamedTuple):
    idxb: jax.Array    # (N, kb) int32 ext indices, -1 padded
    cntb: jax.Array    # (N,) int32
    idxnb: jax.Array   # (N, knb) int32 ext indices, -1 padded
    cntnb: jax.Array   # (N,) int32

    @property
    def maskb(self):
        return self.idxb >= 0

    @property
    def masknb(self):
        return self.idxnb >= 0


def _select_k(mask, k):
    """Indices of up to k True entries per row (lowest index first).
    A capacity beyond the candidate width pads with -1.

    Row-wise cumsum + scatter compaction: O(C) per row with per-row-sorted
    scatter indices, where a top_k over the full candidate width would
    sort."""
    keff = min(k, mask.shape[-1])
    n, C = mask.shape
    pos = jnp.cumsum(mask, axis=1, dtype=jnp.int32) - 1
    # flat 1-D scatter with strictly increasing destinations (row-major,
    # rank-ordered): XLA's sorted-scatter path
    sel = mask & (pos < keff)
    dst = jnp.where(sel, jnp.arange(n, dtype=jnp.int32)[:, None] * keff
                    + pos, n * keff)                    # OOB -> dropped
    col = jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32), (n, C))
    idx = jnp.full((n * keff,), -1, jnp.int32).at[dst.reshape(-1)].set(
        col.reshape(-1), mode="drop").reshape(n, keff)
    if keff < k:
        idx = jnp.pad(idx, ((0, 0), (0, k - keff)), constant_values=-1)
    return idx


@functools.partial(jax.jit, static_argnames=("kb", "knb"))
def build_neighbors_brute(pos, H, types, img: ImageTable, rc2_by_type,
                          rctap2, kb: int, knb: int) -> Neighbors:
    """O(N*M) all-pairs neighbor search over the extended set.

    Exact and simple; suitable up to ~10k atoms.  rc2_by_type is an
    (nso, nso) table of squared sigma-bond cutoffs (0 where no bond type).
    """
    n = pos.shape[0]
    pose = ext_positions(pos, H, img)
    d = pos[:, None, :] - pose[None, :, :]
    dr2 = jnp.sum(d * d, axis=-1)                      # (N, M)
    not_self = jnp.arange(n)[:, None] != jnp.arange(pose.shape[0])[None, :]

    tj = types[img.owner]
    rc2_pair = rc2_by_type[types[:, None], tj[None, :]]
    maskb = (dr2 < rc2_pair) & not_self                # strict <, main.F90:366
    masknb = (dr2 <= rctap2) & not_self                # <=, main.F90:458

    idxb = _select_k(maskb, kb)
    idxnb = _select_k(masknb, knb)
    return Neighbors(idxb=idxb, cntb=maskb.sum(axis=1, dtype=jnp.int32),
                     idxnb=idxnb, cntnb=masknb.sum(axis=1, dtype=jnp.int32))


def sphere_stencil(cellsize, rcut):
    """Pruned cell-offset stencil covering a sphere of radius rcut
    (ref: GetNonbondingMesh init.F90:525-607): keep offset (i,j,k) if the
    nearest corner distance between cells is within rcut."""
    cellsize = np.asarray(cellsize, dtype=float)
    reach = (np.ceil(rcut / cellsize)).astype(int) + 1
    offs = []
    for i in range(-reach[0], reach[0] + 1):
        for j in range(-reach[1], reach[1] + 1):
            for k in range(-reach[2], reach[2] + 1):
                v = np.array([i, j, k], dtype=float)
                v = np.where(v > 0, v - 1, np.where(v < 0, v + 1, 0.0))
                if np.sum((v * cellsize) ** 2) <= rcut * rcut:
                    offs.append((i, j, k))
    return tuple(offs)


class CellGrid(NamedTuple):
    """Static geometry of the binning grid (host-side setup)."""
    lo: tuple            # region lower corner (3,)
    cellsize: tuple      # (3,)
    ncells: tuple        # (3,) ints
    ccap: int            # max atoms per cell
    stencil_b: tuple     # bonded stencil offsets
    stencil_nb: tuple    # nonbonded (taper) stencil offsets


def make_cell_grid(lo, hi, maxrc, rctap, density_per_A3=0.15,
                   ccap=None) -> CellGrid:
    """Size a grid over [lo, hi): cells at least maxrc wide so the bonded
    stencil is 27 cells; the nonbonded stencil is sphere-pruned."""
    lo = np.asarray(lo, float)
    hi = np.asarray(hi, float)
    ext = hi - lo
    ncells = np.maximum(np.floor(ext / max(maxrc, 2.0)).astype(int), 1)
    cellsize = ext / ncells
    if ccap is None:
        # candidate width (and every downstream gather/select) scales with
        # ccap: size for measured-density cells + fluctuation margin, and
        # let the overflow check trigger a regrid instead of padding 2x
        ccap = max(6, int(np.ceil(np.prod(cellsize) * density_per_A3 * 1.4))
                   + 2)
    st_b = tuple((i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                 for k in (-1, 0, 1))
    st_nb = sphere_stencil(cellsize, rctap)
    return CellGrid(lo=tuple(lo), cellsize=tuple(cellsize),
                    ncells=tuple(int(x) for x in ncells), ccap=int(ccap),
                    stencil_b=st_b, stencil_nb=st_nb)


def _cell_table(pos, valid, grid: CellGrid):
    """Bin atoms into cells; returns (table (C+1, ccap) of atom indices with
    -1 padding, cid3 (M,3), counts-per-cell overflow indicator).

    Fixed-shape replacement of the reference's linked-cell lists
    (ref: LINKEDLIST main.F90:277-318): sort by cell id + fixed-capacity
    scatter instead of linked pointers."""
    m = pos.shape[0]
    nc = np.array(grid.ncells)
    ctot = int(np.prod(nc))
    rel = (pos - jnp.asarray(grid.lo, pos.dtype)) / jnp.asarray(
        grid.cellsize, pos.dtype)
    cid3 = jnp.clip(jnp.floor(rel).astype(jnp.int32), 0,
                    jnp.asarray(nc - 1, jnp.int32))
    cid = (cid3[:, 0] * nc[1] + cid3[:, 1]) * nc[2] + cid3[:, 2]
    cid = jnp.where(valid, cid, ctot)          # invalid atoms -> overflow bin
    order = jnp.argsort(cid)
    scid = cid[order]
    start = jnp.searchsorted(scid, jnp.arange(ctot + 1, dtype=scid.dtype))
    rank = jnp.arange(m, dtype=jnp.int32) - start[scid].astype(jnp.int32)
    table = jnp.full((ctot + 1, grid.ccap), -1, jnp.int32)
    inb = rank < grid.ccap
    table = table.at[jnp.where(inb, scid, ctot),
                     jnp.clip(rank, 0, grid.ccap - 1)].set(
        jnp.where(inb, order.astype(jnp.int32), -1))
    # per-cell max occupancy for overflow detection
    occ_overflow = jnp.max(jnp.where(scid < ctot, rank + 1, 0))
    return table, cid3, occ_overflow


def _stencil_candidates(table, cid3, stencil, grid: CellGrid):
    """Candidate neighbor indices (M, S*ccap) from stencil cells, -1 pad."""
    nc = np.array(grid.ncells)
    offs = jnp.asarray(np.array(stencil, np.int32))        # (S, 3)
    nb3 = cid3[:, None, :] + offs[None, :, :]              # (M, S, 3)
    oob = ((nb3 < 0) | (nb3 >= jnp.asarray(nc))).any(axis=-1)
    nbc = (nb3[..., 0] * nc[1] + nb3[..., 1]) * nc[2] + nb3[..., 2]
    nbc = jnp.where(oob, np.prod(nc), nbc)                 # empty bin
    cand = table[nbc]                                      # (M, S, ccap)
    return cand.reshape(cand.shape[0], -1)


_FAR = 1.0e4      # padded-slot coordinate: dr2 ~ 1e8 fails every cutoff


def _cell_table_packed(pos, valid, types, grid: CellGrid):
    """Cell binning with PACKED per-slot payloads: positions + type in a
    (ncell+1, ccap, 4) array (FAR sentinel in empty slots) and the ext-row
    index table.  Stencil consumers then gather whole ccap-row blocks —
    coarse-grained transfers instead of 12-byte scattered picks."""
    m = pos.shape[0]
    nc = np.array(grid.ncells)
    ctot = int(np.prod(nc))
    ccap = grid.ccap
    rel = (pos - jnp.asarray(grid.lo, pos.dtype)) / jnp.asarray(
        grid.cellsize, pos.dtype)
    cid3 = jnp.clip(jnp.floor(rel).astype(jnp.int32), 0,
                    jnp.asarray(nc - 1, jnp.int32))
    cid = (cid3[:, 0] * nc[1] + cid3[:, 1]) * nc[2] + cid3[:, 2]
    cid = jnp.where(valid, cid, ctot)
    order = jnp.argsort(cid)
    scid = cid[order]
    start = jnp.searchsorted(scid, jnp.arange(ctot + 1, dtype=scid.dtype))
    rank = jnp.arange(m, dtype=jnp.int32) - start[scid].astype(jnp.int32)
    inb = (rank < ccap) & (scid < ctot)
    dst = jnp.where(inb, scid * ccap + rank, ctot * ccap)   # sorted; OOB drop
    payload = jnp.concatenate(
        [pos, types.astype(pos.dtype)[:, None]], axis=1)[order]
    slot_pay = jnp.full((ctot * ccap + 1, 4), _FAR, pos.dtype)
    slot_pay = slot_pay.at[dst].set(payload, mode="drop")
    slot_idx = jnp.full((ctot * ccap + 1,), -1, jnp.int32)
    slot_idx = slot_idx.at[dst].set(order.astype(jnp.int32), mode="drop")
    occ_overflow = jnp.max(jnp.where(scid < ctot, rank + 1, 0))
    return (slot_pay[:-1].reshape(ctot, ccap, 4),
            slot_idx[:-1].reshape(ctot, ccap), cid3, occ_overflow)


@functools.partial(jax.jit, static_argnames=("grid", "kb", "knb", "nrows",
                                             "row_chunk"))
def build_neighbors_cells(pos, valid, types, grid: CellGrid, rc2_by_type,
                          rctap2, kb: int, knb: int, nrows: int = None,
                          row_chunk: int = 0):
    """O(M) cell-list neighbor build over an extended atom set.

    `pos` are real coordinates inside [grid.lo, grid.lo+extent); `valid`
    masks live entries.  Returns Neighbors with rows for the first `nrows`
    entries (all by default) — the single-device image mode only needs rows
    for the owned atoms, the sharded mode needs rows for ghosts too.

    `row_chunk` > 0 computes the candidate sweep in target-row blocks of
    that size (lax.map): the one-shot sweep materializes the stencil
    payload gather for ALL rows at once; chunking bounds it to the block.
    Output is identical."""
    m = pos.shape[0]
    nrows = nrows or m
    slot_pay, slot_idx, cid3, overflow = _cell_table_packed(
        pos, jnp.where(valid, jnp.ones(m, bool), False), types, grid)
    nc = np.array(grid.ncells)
    ctot = int(np.prod(nc))
    ccap = grid.ccap
    # one empty cell appended as the out-of-bounds target
    slot_pay = jnp.concatenate(
        [slot_pay, jnp.full((1, ccap, 4), _FAR, pos.dtype)])
    slot_idx = jnp.concatenate(
        [slot_idx, jnp.full((1, ccap), -1, jnp.int32)])
    nso = rc2_by_type.shape[0]

    def lists(rows, stencil, bonded, cap):
        B = rows.shape[0]
        offs = jnp.asarray(np.array(stencil, np.int32))
        nb3 = cid3[rows][:, None, :] + offs[None, :, :]   # (B, S, 3)
        oob = ((nb3 < 0) | (nb3 >= jnp.asarray(nc))).any(axis=-1)
        nbc = (nb3[..., 0] * nc[1] + nb3[..., 1]) * nc[2] + nb3[..., 2]
        nbc = jnp.where(oob, ctot, nbc)
        S = offs.shape[0]
        pay = slot_pay[nbc].reshape(B, S * ccap, 4)       # coarse gather
        cand = slot_idx[nbc].reshape(B, S * ccap)
        d = pos[rows][:, None, :] - pay[..., :3]
        dr2 = jnp.sum(d * d, axis=-1)
        if bonded:
            # per-pair sigma-bond cutoff via a one-hot contraction on the
            # packed neighbor type (no (B, C) small-table gather)
            tjoh = (pay[..., 3, None]
                    == jnp.arange(nso, dtype=pos.dtype)).astype(pos.dtype)
            rc2p = jnp.einsum("nck,nk->nc", tjoh, rc2_by_type[types[rows]],
                              preferred_element_type=pos.dtype)
            inr = dr2 < rc2p
        else:
            inr = dr2 <= rctap2
        mask = inr & (cand != rows[:, None])
        slot = _select_k(mask, cap)                    # positions in cand row
        idx = jnp.where(slot >= 0,
                        jnp.take_along_axis(cand, jnp.maximum(slot, 0),
                                            axis=1), -1)
        return idx.astype(jnp.int32), mask.sum(axis=1, dtype=jnp.int32)

    if 0 < row_chunk < nrows:
        nblk = -(-nrows // int(row_chunk))
        B = -(-nrows // nblk)        # balanced blocks: waste < nblk rows
        blocks = jnp.arange(nblk * B, dtype=jnp.int32).reshape(nblk, B)

        def body(rows):
            rc = jnp.minimum(rows, nrows - 1)      # pad rows recompute n-1;
            ib, cb = lists(rc, grid.stencil_b, True, kb)       # sliced off
            inb_, cnb = lists(rc, grid.stencil_nb, False, knb)
            return ib, cb, inb_, cnb

        ib, cb, inb_, cnb = jax.lax.map(body, blocks)
        idxb = ib.reshape(nblk * B, kb)[:nrows]
        cntb = cb.reshape(nblk * B)[:nrows]
        idxnb = inb_.reshape(nblk * B, knb)[:nrows]
        cntnb = cnb.reshape(nblk * B)[:nrows]
    else:
        rows = jnp.arange(nrows, dtype=jnp.int32)
        idxb, cntb = lists(rows, grid.stencil_b, True, kb)
        idxnb, cntnb = lists(rows, grid.stencil_nb, False, knb)
    return Neighbors(idxb=idxb, cntb=cntb, idxnb=idxnb, cntnb=cntnb), overflow


@functools.partial(jax.jit, static_argnames=("kb", "knb"))
def tighten(pos, H, types, img: ImageTable, nbrs: Neighbors, rc2_by_type,
            rctap2, kb: int, knb: int) -> Neighbors:
    """Filter Verlet-skinned lists down to the true cutoffs and compact to
    smaller capacities — run once per step so the energy kernels work at
    actual occupancy instead of the skinned capacity."""
    pose = ext_positions(pos, H, img)

    def shrink(idx_full, cap, rc2_fn):
        mask = idx_full >= 0
        idx = jnp.where(mask, idx_full, 0)
        d = pos[:, None, :] - pose[idx]
        dr2 = jnp.sum(d * d, axis=-1)
        keep = mask & rc2_fn(dr2, idx)
        slot = _select_k(keep, cap)
        out = jnp.where(slot >= 0,
                        jnp.take_along_axis(idx, jnp.maximum(slot, 0),
                                            axis=1), -1)
        return out.astype(jnp.int32), keep.sum(axis=1, dtype=jnp.int32)

    tj = types[img.owner]
    idxb, cntb = shrink(
        nbrs.idxb, kb,
        lambda dr2, ix: dr2 < rc2_by_type[types[:, None], tj[ix]])
    idxnb, cntnb = shrink(nbrs.idxnb, knb, lambda dr2, ix: dr2 <= rctap2)
    return Neighbors(idxb=idxb, cntb=cntb, idxnb=idxnb, cntnb=cntnb)


def check_overflow(nbrs: Neighbors):
    """Host-side overflow check; returns (max_bonded, max_nonbonded).

    Raises if either exceeds its capacity — the caller should rebuild jitted
    functions with larger kb/knb (ref: error traps main.F90:402-407)."""
    mb = int(nbrs.cntb.max())
    mnb = int(nbrs.cntnb.max())
    if mb > nbrs.idxb.shape[1]:
        raise RuntimeError(
            f"bonded neighbor overflow: {mb} > capacity {nbrs.idxb.shape[1]}")
    if mnb > nbrs.idxnb.shape[1]:
        raise RuntimeError(
            f"nonbonded neighbor overflow: {mnb} > capacity {nbrs.idxnb.shape[1]}")
    return mb, mnb
