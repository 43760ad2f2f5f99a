"""Two-stage flat-list packing (`reax._flat_compact_rows`).

The cached angle/torsion/hbond lists are packed from big candidate masks;
the two-stage (per-row then global) pack must produce bit-identical lists
to the single global pack, and must surface per-row overflow through the
same `cnt > cap` check the engine already uses (the reference aborts on
list overflow too, ref: main.F90:402-407).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from rxmd_tpu import ffield, system, neighbors, reax, units


@pytest.fixture(scope="module")
def setup(inputs):
    ff = ffield.parse_ffield(inputs["ffield"])
    st = system.from_cellfile(inputs["input.xyz"], ff.name_to_type)
    ffd = reax.ffdev_from(ff)
    img = neighbors.make_image_table(
        st.n, neighbors.nimg_for_cutoff(np.asarray(st.H), units.RCTAP0))
    nbrs = neighbors.build_neighbors_brute(
        st.pos, st.H, st.types, img, ffd.rc2b, ffd.rctap2, 20, 768)
    bo = reax.bond_order(st.pos, st.H, st.types, img, nbrs, ffd)
    amask = jnp.ones(st.n, bool)
    tc = reax.term_counts(st.pos, st.H, st.types, st.gid, img, nbrs, ffd)
    return st, ffd, img, nbrs, bo, amask, tc


def test_flat_compact_rows_random():
    rng = np.random.default_rng(7)
    mask = jnp.asarray(rng.random((37, 53)) < 0.2)
    cap = 512
    ref = reax._flat_compact(mask.reshape(-1), cap)
    got = reax._flat_compact_rows(mask, cap, rowcap=int(mask.sum(1).max()))
    for a, b in zip(ref, got):
        assert jnp.array_equal(a, b)


def test_flat_compact_rows_overflow_sentinel():
    mask = jnp.ones((4, 9), bool)
    _, _, cnt = reax._flat_compact_rows(mask, cap=64, rowcap=3)
    assert int(cnt) > 64          # sentinel trips every cnt > cap check
    # the sentinel is distinguishable from a total-cap overflow so the
    # engine can direct the user at the *_row caps, not ang/tor/hbf
    assert int(cnt) == reax.ROW_OVERFLOW


@pytest.mark.parametrize("which", ["torsion", "hbond"])
@pytest.mark.parametrize("chunk", [7, 64])
def test_builders_identical_chunked(setup, which, chunk):
    """Row-chunked (lax.map) builds — the large-N path that bounds the
    torsion/hbond builds' peak memory — must be bit-identical to the
    one-shot build."""
    st, ffd, img, nbrs, bo, amask, tc = setup
    ks = tc["degmax"] + 2
    if which == "torsion":
        mk = lambda ch: reax.build_torsion_list(
            st.types, st.gid, img, nbrs, bo, amask, ffd, cap=4096, ks=ks,
            rowcap=tc["tor_row"] + 4, chunk=ch)
    else:
        mk = lambda ch: reax.build_hbond_list(
            st.pos, st.H, st.types, img, nbrs, bo, amask, ffd,
            cap=tc["hbf"] + 64,
            kh=max(tc["h_slots"], 2), rowcap=tc["hb"] + 4, chunk=ch)
    l0, l1 = mk(0), mk(chunk)
    assert int(l0.cnt) > 0
    for a, b in zip(l0, l1):
        assert jnp.array_equal(a, b)


def test_neighbor_build_identical_chunked(setup):
    """Row-chunked cell neighbor build (the large-N path bounding the
    stencil gather's footprint) must match the one-shot build exactly."""
    st, ffd, img, nbrs, bo, amask, tc = setup
    H = np.asarray(st.H)
    L = np.diag(H)
    nimg = np.array(neighbors.nimg_for_cutoff(H, units.RCTAP0))
    grid = neighbors.make_cell_grid(-nimg * L, (1.0 + nimg) * L, 3.2,
                                    units.RCTAP0)
    pose = neighbors.ext_positions(st.pos, st.H, img)
    valid = jnp.ones(pose.shape[0], bool)
    a, _ = neighbors.build_neighbors_cells(
        pose, valid, st.types[img.owner], grid, ffd.rc2b, ffd.rctap2,
        20, 768, nrows=st.n)
    b, _ = neighbors.build_neighbors_cells(
        pose, valid, st.types[img.owner], grid, ffd.rc2b, ffd.rctap2,
        20, 768, nrows=st.n, row_chunk=37)
    for x, y in zip(a, b):
        assert jnp.array_equal(x, y)


@pytest.mark.parametrize("which", ["angle", "torsion", "hbond"])
def test_builders_identical_under_rowcap(setup, which):
    st, ffd, img, nbrs, bo, amask, tc = setup
    ks = tc["degmax"] + 2
    if which == "angle":
        mk = lambda rc: reax.build_angle_list(
            st.types, img, nbrs, bo, amask, ffd, cap=2048, ks=ks, rowcap=rc)
        rc = tc["ang_row"] + 4
    elif which == "torsion":
        mk = lambda rc: reax.build_torsion_list(
            st.types, st.gid, img, nbrs, bo, amask, ffd, cap=4096, ks=ks,
            rowcap=rc)
        rc = tc["tor_row"] + 4
    else:
        mk = lambda rc: reax.build_hbond_list(
            st.pos, st.H, st.types, img, nbrs, bo, amask, ffd,
            cap=tc["hbf"] + 64,
            kh=max(tc["h_slots"], 2), rowcap=rc)
        rc = tc["hb"] + 4
    l0, l1 = mk(0), mk(rc)
    assert int(l0.cnt) > 0
    for a, b in zip(l0, l1):
        assert jnp.array_equal(a, b)
    # a too-small rowcap must trip the overflow check, never truncate
    l2 = mk(1)
    assert int(l2.cnt) > l2.valid.shape[0]
