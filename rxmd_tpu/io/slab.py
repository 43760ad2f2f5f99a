"""Scalable parallel output: per-process slab writes without gathering.

The reference writes trajectory/checkpoint files as MPI-IO shared files
with per-rank offsets computed by MPI_Scan (ref: fileio.F90:81-95,587-643).
The analog here: every process writes ONLY its own residents into a
shared (filesystem) file at precomputed byte offsets — O(N/nprocs) traffic
per process instead of the O(N*nprocs) full-state allgather of
`ShardedEngine.to_state`.

Two writers:

  * `write_xyz_slab` — fixed-width xyz records indexed by GLOBAL ATOM ID:
    atom g's record lives at `header + g*REC`.  No offset scan is needed at
    all, and the result is byte-identical to the serial gid-ordered writer.
  * `write_bin_slab` — the reference rxff.bin layout (per-rank slabs,
    x-fastest rank order, local-normalized coordinates); the only
    cross-process traffic is the (ndev,) per-device atom counts (the
    MPI_Scan analog, fileio.F90:81-95).
"""
from __future__ import annotations

import numpy as np
import jax

from .traj import cell_params
from .refbin import encode_atype

XYZ_REC = 57        # bytes: name(3) + 3*12 coords + 8 q + 9 gid + newline


def _barrier(tag):
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(tag)


def _xyz_records(names, types, pos, q, gid):
    out = bytearray()
    for k in range(len(gid)):
        out += (f"{names[types[k]]:<3s}"
                f"{pos[k, 0]:12.5f}{pos[k, 1]:12.5f}{pos[k, 2]:12.5f}"
                f"{q[k]:8.3f}{gid[k]:9d}\n").encode()
    return bytes(out)


def write_xyz_slab(path, engine):
    """Write the sharded state as .xyz: each process writes its residents'
    fixed-width records at `header + gid*REC` (gid-indexed addressing needs
    no offset exchange at all)."""
    H = np.asarray(engine.Hg)
    n = engine.state0.n
    la, lb, lc, al, be, ga = cell_params(H)
    header = (f"{n:9d}\n"
              f"{la:12.5f}{lb:12.5f}{lc:12.5f}"
              f"{al:8.3f}{be:8.3f}{ga:8.3f}\n").encode()
    if jax.process_index() == 0:
        with open(path, "wb") as fh:
            fh.write(header)
            fh.truncate(len(header) + n * XYZ_REC)
    _barrier("xyz_slab_header:" + path)

    names = engine.ff.atom_names
    with open(path, "r+b") as fh:
        for frac_sh, q_sh, t_sh, g_sh, v_sh in zip(
                engine.sstate.frac.addressable_shards,
                engine.sstate.q.addressable_shards,
                engine.sstate.types.addressable_shards,
                engine.sstate.gid.addressable_shards,
                engine.sstate.valid.addressable_shards):
            valid = np.asarray(v_sh.data)
            if not valid.any():
                continue
            frac = np.asarray(frac_sh.data)[valid] % 1.0
            pos = frac @ H.T
            q = np.asarray(q_sh.data)[valid]
            types = np.asarray(t_sh.data)[valid]
            gid = np.asarray(g_sh.data)[valid]
            order = np.argsort(gid, kind="stable")
            # contiguous gid runs coalesce into few pwrites
            gid = gid[order]
            rec = _xyz_records(names, types[order], pos[order], q[order],
                               gid)
            runs = np.flatnonzero(np.diff(gid) != 1)
            starts = np.concatenate([[0], runs + 1])
            ends = np.concatenate([runs + 1, [len(gid)]])
            for s, e in zip(starts, ends):
                fh.seek(len(header) + int(gid[s]) * XYZ_REC)
                fh.write(rec[s * XYZ_REC:e * XYZ_REC])
    _barrier("xyz_slab_done:" + path)


def write_bin_slab(path, engine, step=None):
    """Write the sharded state as a reference rxff.bin (per-rank slabs,
    fileio.F90:587-643) with one slab per mesh device, rank order
    x-fastest (init.F90:74-76).  Cross-process traffic: only the (ndev,)
    per-device counts."""
    ncap = engine.ncap
    nx, ny, nz = engine.mesh_shape
    ndev = nx * ny * nz
    H = np.asarray(engine.Hg)
    Hi = np.linalg.inv(H)
    la, lb, lc = np.linalg.norm(H, axis=0)
    cosg = H[:, 0] @ H[:, 1] / (la * lb)
    cosb = H[:, 0] @ H[:, 2] / (la * lc)
    cosa = H[:, 1] @ H[:, 2] / (lb * lc)
    cell = (la, lb, lc, np.degrees(np.arccos(np.clip(cosa, -1, 1))),
            np.degrees(np.arccos(np.clip(cosb, -1, 1))),
            np.degrees(np.arccos(np.clip(cosg, -1, 1))))
    step = int(getattr(engine, "step_count", 0)) if step is None else step

    # local (block-index d -> slab rows) from this process's shards
    local = {}
    counts = np.zeros(ndev, np.int32)
    ss = engine.sstate
    for shards in zip(ss.frac.addressable_shards, ss.vel.addressable_shards,
                      ss.q.addressable_shards, ss.qsfp.addressable_shards,
                      ss.qsfv.addressable_shards,
                      ss.types.addressable_shards,
                      ss.gid.addressable_shards,
                      ss.valid.addressable_shards):
        lo = shards[0].index[0].start or 0
        ncap_blk = shards[0].data.shape[0]
        # a shard may span several device blocks (multi-host layouts)
        for off in range(0, ncap_blk, ncap):
            d = (lo + off) // ncap
            sl = slice(off, off + ncap)
            valid = np.asarray(shards[7].data[sl])
            cnt = int(valid.sum())
            counts[d] = cnt
            if cnt == 0:
                continue
            frac = np.asarray(shards[0].data[sl])[valid] % 1.0
            gid = np.asarray(shards[6].data[sl])[valid]
            order = np.argsort(gid, kind="stable")
            body = np.zeros((cnt, 10))
            # block d = (ix*ny + iy)*nz + iz (z-fastest)
            ix, iy, iz = d // (ny * nz), (d // nz) % ny, d % nz
            obox = np.array([ix / nx, iy / ny, iz / nz])
            body[:, 0:3] = frac[order] - obox     # local-normalized coords
            body[:, 3:6] = np.asarray(shards[1].data[sl])[valid][order]
            body[:, 6] = np.asarray(shards[2].data[sl])[valid][order]
            body[:, 7] = encode_atype(
                np.asarray(shards[5].data[sl])[valid][order], gid[order])
            body[:, 8] = np.asarray(shards[3].data[sl])[valid][order]
            body[:, 9] = np.asarray(shards[4].data[sl])[valid][order]
            local[d] = body

    # the MPI_Scan analog: allgather the tiny per-device counts
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        counts = np.asarray(
            multihost_utils.process_allgather(counts)).reshape(
                jax.process_count(), ndev).sum(axis=0).astype(np.int32)

    # reference rank r = ix + iy*nx + iz*nx*ny (x-fastest); block index
    # d = (ix*ny + iy)*nz + iz.  Build rank -> block map and slab offsets.
    rank_of_block = np.zeros(ndev, np.int64)
    for d in range(ndev):
        ix, iy, iz = d // (ny * nz), (d // nz) % ny, d % nz
        rank_of_block[d] = ix + iy * nx + iz * nx * ny
    counts_by_rank = np.zeros(ndev, np.int32)
    counts_by_rank[rank_of_block] = counts
    head_bytes = 4 * (4 + ndev + 1) + 8 * 6
    offsets_by_rank = head_bytes + 80 * np.concatenate(
        [[0], np.cumsum(counts_by_rank[:-1], dtype=np.int64)])

    if jax.process_index() == 0:
        with open(path, "wb") as fh:
            np.array([ndev, nx, ny, nz], np.int32).tofile(fh)
            counts_by_rank.tofile(fh)
            np.array([step], np.int32).tofile(fh)
            np.asarray(cell, np.float64).tofile(fh)
            fh.truncate(head_bytes + 80 * int(counts.sum()))
    _barrier("bin_slab_header:" + path)

    with open(path, "r+b") as fh:
        for d, body in local.items():
            fh.seek(int(offsets_by_rank[rank_of_block[d]]))
            body.astype(np.float64).tofile(fh)
    _barrier("bin_slab_done:" + path)
