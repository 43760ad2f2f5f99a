"""Command-line driver: the `rxmd` executable equivalent.

Usage (mirrors the reference, ref: main.F90:2-114, cmdline.F90):

    python -m rxmd_tpu [--rxmdin rxmd.in] [--ffield ffield] \
        [--run_from_xyz cell.xyz] [--outDir DAT] [overrides...]

Reads the rxmd.in deck, loads DAT/rxff.bin (reference format) or a native
checkpoint DAT/rxff.npz or an input cell via --run_from_xyz, runs the MD
loop with PRINTE-format output, and writes the final checkpoint.
"""
import os
import sys

import numpy as np


def main(argv=None):
    from . import config, ffield, system, md
    # multi-host launch (the MPI-world analog, ref: main.F90:10): set
    # RXMD_COORDINATOR=host:port RXMD_NUM_PROCESSES=N RXMD_PROCESS_ID=i on
    # every process; the device mesh then spans all processes and the
    # sharded engine's collectives cross process boundaries.
    import jax
    if os.environ.get("RXMD_COORDINATOR"):
        jax.distributed.initialize(
            coordinator_address=os.environ["RXMD_COORDINATOR"],
            num_processes=int(os.environ["RXMD_NUM_PROCESSES"]),
            process_id=int(os.environ["RXMD_PROCESS_ID"]))
    args = config.cli_parser().parse_args(argv)
    cfg = config.RunConfig()
    if os.path.exists(args.rxmdin):
        cfg = config.parse_rxmd_in(args.rxmdin, cfg)
    cfg = config.apply_cli(cfg, args)
    if np.dtype(cfg.dtype) == np.float64:
        # float64 means float64: without x64 every array would silently be
        # float32.  f32 runs leave it off so indices stay 32-bit.
        jax.config.update("jax_enable_x64", True)

    ff = ffield.parse_ffield(cfg.ffield_path, lg=getattr(args, "lg", False))

    import jax.numpy as jnp
    dtype = jnp.dtype(cfg.dtype)
    from .io import refbin, checkpoint
    if args.run_from_xyz:
        mc = tuple(args.mc) if getattr(args, "mc", None) else (1, 1, 1)
        st = system.from_cellfile(args.run_from_xyz, ff.name_to_type,
                                  mc=mc, dtype=dtype)
    elif os.path.exists(os.path.join(cfg.data_dir, "rxff.npz")):
        st = checkpoint.load(os.path.join(cfg.data_dir, "rxff.npz"), dtype)
    elif os.path.exists(os.path.join(cfg.data_dir, "rxff.bin")):
        st, _ = refbin.read_rxff_bin(os.path.join(cfg.data_dir, "rxff.bin"),
                                     dtype)
    else:
        print("ERROR: no input configuration "
              "(DAT/rxff.bin, DAT/rxff.npz or --run_from_xyz)",
              file=sys.stderr)
        return 1

    nvp = int(np.prod(cfg.vprocs))
    sharded = nvp > 1
    if sharded:
        # spatial domain decomposition over a device mesh shaped like the
        # rxmd.in `processors` grid (ref: cmdline.F90:273-276, init.F90:48-53)
        from .parallel.engine import ShardedEngine
        if len(jax.devices()) < nvp:
            print(f"ERROR: processors {cfg.vprocs} needs {nvp} devices, "
                  f"have {len(jax.devices())}", file=sys.stderr)
            return 1
        eng = ShardedEngine(ff, st, cfg, mesh_shape=cfg.vprocs, dtype=dtype)
    else:
        eng = md.Engine(ff, st, cfg, dtype=dtype)
    p0 = True
    if os.environ.get("RXMD_COORDINATOR"):
        # multi-host: rank 0 prints and writes (ref: `if(myid==0)` guards)
        p0 = jax.process_index() == 0
        if not p0:
            sys.stdout = open(os.devnull, "w")
    print("-" * 64)
    print(f"{'parameter set:':>30s} {ff.header}")
    print(f"{'time step[fs]:':>30s} {cfg.dt_fs:10.2e}")
    print(f"{'MDMODE CURRENTSTEP NTIMESTPE:':>30s} {cfg.mdmode} "
          f"{int(st.step)} {cfg.ntime_step}")
    print(f"{'isQEq,QEq_tol,NMAXQEq,qstep:':>30s} {cfg.isQEq} "
          f"{cfg.QEq_tol:.1e} {cfg.NMAXQEq} {cfg.qstep}")
    print(f"{'NATOMS:':>30s} {st.n}")
    print(f"{'device:':>30s} {jax.devices()[0].platform} "
          f"{jax.devices()[0].device_kind} x{len(jax.devices())} "
          f"dtype {jnp.dtype(dtype).name}")
    pair_path, qeq_path = (("ELL gather (sharded)", "ELL gather (sharded)")
                           if sharded else eng.path_names())
    print(f"{'pair path, QEq path:':>30s} {pair_path}; {qeq_path}")
    if sharded:
        print(f"{'req proc arrangement:':>30s} {cfg.vprocs} "
              f"ncap {eng.ncap} bcap {eng.bcap}")
    print(f"{'neighbor caps kb/knb:':>30s} {eng.kb}/{eng.knb} "
          f"caps {eng.caps}")
    print("-" * 64)
    print("nstep  TE  PE  KE: 1-Ebond 2-(Elnpr,Eover,Eunder) "
          "3-(Eval,Epen,Ecoa) 4-(Etors,Econj) 5-Ehbond "
          "6-(Evdw,EClmb,Echarge)")

    os.makedirs(cfg.data_dir, exist_ok=True)

    if sharded:
        from .io import checkpoint as _ck

        if cfg.mdmode == 10:
            # sharded structural optimization (ref: main.F90:25, cg.F90);
            # CG direction vectors migrate with their atoms (MigrateVec3D
            # analog, cg.F90:292-314)
            from . import opt
            opt.conjugate_gradient(eng, ftol=cfg.ftol)
            final = eng.to_state()
            if p0:
                _ck.save(os.path.join(cfg.data_dir, "rxff.npz"), final)
                refbin.write_rxff_bin(
                    os.path.join(cfg.data_dir, "rxff.bin"), final)
            print("structural optimization finished")
            return 0

        # pdb/bnd writers need the gathered state; xyz/bin have scalable
        # per-process slab writers (the MPI-IO analog, fileio.F90:81-95),
        # so only gather when a gather-only format was requested
        need_gather = cfg.is_pdb or cfg.is_bondfile

        def swriter(e):
            base = os.path.join(cfg.data_dir, f"{e.step_count:09d}")
            if not need_gather:
                e.write_frame_slab(base)    # every process writes its slab
                return
            stg = e.to_state()          # cross-host collective: all ranks
            if not p0:
                return
            e.write_frame(base, st=stg)

        eng.run(cfg.ntime_step, log=print,
                writer=swriter if (cfg.is_xyz or cfg.is_pdb
                                   or cfg.is_bondfile
                                   or cfg.is_binary) else None)
        final = eng.to_state()
        if p0:
            _ck.save(os.path.join(cfg.data_dir, "rxff.npz"), final)
            refbin.write_rxff_bin(os.path.join(cfg.data_dir, "rxff.bin"),
                                  final)
        print("rxmd-tpu successfully finished")
        return 0

    if cfg.mdmode == 10:
        # structural optimization instead of MD (ref: main.F90:25, cg.F90)
        from . import opt
        opt.conjugate_gradient(eng, ftol=cfg.ftol)
        from .io import checkpoint as _ck
        _ck.save(os.path.join(cfg.data_dir, "rxff.npz"), eng.state)
        refbin.write_rxff_bin(os.path.join(cfg.data_dir, "rxff.bin"),
                              eng.state)
        print("structural optimization finished")
        return 0

    def writer(state, comps):
        base = os.path.join(cfg.data_dir,
                            f"{int(state.step):09d}")
        eng.write_frame(base)

    eng.run(cfg.ntime_step,
            writer=writer if (cfg.is_xyz or cfg.is_pdb or cfg.is_bondfile
                              or cfg.is_binary) else None)
    checkpoint.save(os.path.join(cfg.data_dir, "rxff.npz"), eng.state)
    refbin.write_rxff_bin(os.path.join(cfg.data_dir, "rxff.bin"), eng.state)
    # per-phase timing / occupancy / memory report (ref: FinalizeMD
    # main.F90:128-186)
    for line in eng.summary():
        print(line)
    print("rxmd-tpu successfully finished")
    return 0


if __name__ == "__main__":
    sys.exit(main())
