"""I/O round-trip tests: reference rxff.bin format, native checkpoint,
trajectory writers."""
import numpy as np
import pytest

from rxmd_tpu import ffield, system
from rxmd_tpu.io import refbin, checkpoint, traj


@pytest.fixture
def ff_state(inputs):
    ff = ffield.parse_ffield(inputs["ffield"])
    st = system.from_cellfile(inputs["input.xyz"], ff.name_to_type)
    rng = np.random.default_rng(1)
    import dataclasses
    import jax.numpy as jnp
    return ff, dataclasses.replace(
        st,
        vel=jnp.asarray(rng.normal(size=(st.n, 3)) * 1e-3),
        q=jnp.asarray(rng.normal(size=st.n) * 0.1),
        qsfp=jnp.asarray(rng.normal(size=st.n) * 0.1),
        qsfv=jnp.asarray(rng.normal(size=st.n) * 0.01))


def test_refbin_roundtrip(ff_state, tmp_path):
    ff, st = ff_state
    path = str(tmp_path / "rxff.bin")
    refbin.write_rxff_bin(path, st)
    st2, meta = refbin.read_rxff_bin(path)
    assert meta["nprocs"] == 1
    assert st2.n == st.n
    assert np.allclose(np.asarray(st2.pos), np.asarray(st.pos), atol=1e-9)
    assert np.allclose(np.asarray(st2.vel), np.asarray(st.vel))
    assert np.allclose(np.asarray(st2.q), np.asarray(st.q))
    assert np.allclose(np.asarray(st2.qsfp), np.asarray(st.qsfp))
    assert (np.asarray(st2.types) == np.asarray(st.types)).all()
    assert (np.asarray(st2.gid) == np.asarray(st.gid)).all()


def test_atype_encoding():
    t0 = np.array([0, 1, 2, 3], np.int32)
    gid = np.array([0, 7, 123456, 99999], np.int32)
    enc = refbin.encode_atype(t0, gid)
    t1, g1 = refbin.decode_atype(enc)
    assert (t0 == t1).all() and (gid == g1).all()


def test_checkpoint_roundtrip(ff_state, tmp_path):
    ff, st = ff_state
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, st)
    st2 = checkpoint.load(path)
    assert np.allclose(np.asarray(st2.pos), np.asarray(st.pos))
    assert np.allclose(np.asarray(st2.qsfv), np.asarray(st.qsfv))
    assert int(st2.step) == int(st.step)


def test_xyz_roundtrip(ff_state, tmp_path):
    ff, st = ff_state
    path = str(tmp_path / "t.xyz")
    traj.write_xyz(path, st, ff.atom_names)
    frames = list(traj.read_xyz_frames(path, ff.name_to_type))
    assert len(frames) == 1
    f = frames[0]
    assert np.allclose(f["pos"], np.asarray(st.pos), atol=1e-5)
    assert (f["types"] == np.asarray(st.types)).all()
    assert np.allclose(f["cell"][:3], [13.18, 11.57, 10.71], atol=1e-3)


def test_refbin_multirank_roundtrip(ff_state, tmp_path):
    """Per-rank slab write (ref: WriteBIN fileio.F90:587-643): atoms are
    binned into the vprocs grid in the reference's x-fastest rank order
    with local normalized coordinates, so the reference can restart at
    that layout; our reader reassembles the identical state."""
    ff, st = ff_state
    path = str(tmp_path / "rxff2.bin")
    refbin.write_rxff_bin(path, st, vprocs=(2, 2, 1))
    st2, meta = refbin.read_rxff_bin(path)
    assert meta["nprocs"] == 4
    assert meta["vprocs"] == (2, 2, 1)
    assert int(sum(meta["counts"])) == st.n
    assert (np.asarray(meta["counts"]) > 0).all()
    # slab order differs from input order: compare after sorting by gid
    o1 = np.argsort(np.asarray(st.gid))
    o2 = np.argsort(np.asarray(st2.gid))
    H = np.asarray(st.H)
    d = np.asarray(st2.pos)[o2] - np.asarray(st.pos)[o1]
    # positions agree modulo the box wrap applied at write time
    frac = d @ np.linalg.inv(H).T
    frac -= np.round(frac)
    assert np.abs(frac @ H.T).max() < 1e-9
    assert np.allclose(np.asarray(st2.vel)[o2], np.asarray(st.vel)[o1])
    assert np.allclose(np.asarray(st2.q)[o2], np.asarray(st.q)[o1])
    assert np.allclose(np.asarray(st2.qsfp)[o2], np.asarray(st.qsfp)[o1])
    assert (np.asarray(st2.types)[o2] == np.asarray(st.types)[o1]).all()
    # every slab's local normalized coords lie in [0, 1/vprocs) + rounding
    with open(path, "rb") as fh:
        head = np.fromfile(fh, np.int32, 4)
        counts = np.fromfile(fh, np.int32, 4)
        np.fromfile(fh, np.int32, 1)
        np.fromfile(fh, np.float64, 6)
        body = np.fromfile(fh, np.float64).reshape(-1, 10)
    off = 0
    for k in range(4):
        sl = body[off:off + counts[k], 0:3]
        assert sl[:, 0].max() < 1.0 / 2 + 1e-12   # vx=2
        assert sl[:, 1].max() < 1.0 / 2 + 1e-12   # vy=2
        assert sl.min() >= -1e-12
        off += counts[k]
