"""Multi-process (2 proc x 4 CPU devices) dryrun of the multihost path.

Exercises initialize_multihost / jax.distributed over localhost. Each
process runs the same SPMD program; the 8-device global mesh spans both
processes, so the all-gather collectives actually cross the process
boundary, as they would between hosts.

Run (no args): spawns both workers and validates y on process 0.
Exit 0 = PASS.
"""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PORT = int(os.environ.get("DRYRUN_PORT", "12355"))


def worker(pid: int) -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)
    import numpy as np
    from tilespmv_tpu.parallel.mesh import initialize_multihost
    initialize_multihost(coordinator_address=f"localhost:{PORT}",
                        num_processes=2, process_id=pid)
    assert len(jax.devices()) == 8, jax.devices()
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from tilespmv_tpu.io import generate
    from tilespmv_tpu.parallel.distributed import DistributedSpMV
    from tilespmv_tpu.parallel.mesh import ROW_AXIS, make_mesh

    csr = generate.mixed_structure(2048, 2048, seed=5)
    mesh = make_mesh(8)
    op = DistributedSpMV(csr, mesh=mesh, x_mode="allgather")
    x = np.linspace(-1.0, 1.0, csr.n).astype(np.float32)
    y = op(x)
    # gather the sharded y for validation (replicate via device_get of
    # the addressable shards + allgather through a jitted identity)
    yg = np.asarray(
        jax.jit(lambda a: a,
                out_shardings=NamedSharding(mesh, P()))(y))
    ref = csr.matvec(x.astype(np.float64))
    err = float(np.max(np.abs(yg[: csr.m] - ref))
                / max(1e-30, np.max(np.abs(ref))))
    if pid == 0:
        print(f"multiprocess dryrun: ndev={len(jax.devices())} "
              f"x_mode={op.x_mode} rel_err={err:.2e} "
              f"{'PASS' if err < 1e-4 else 'FAIL'}", flush=True)
    return 0 if err < 1e-4 else 1


if __name__ == "__main__":
    if len(sys.argv) > 1:
        sys.exit(worker(int(sys.argv[1])))
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, __file__, str(i)],
                              env=env) for i in range(2)]
    rcs = [p.wait(timeout=900) for p in procs]
    print("worker exit codes:", rcs)
    sys.exit(0 if all(rc == 0 for rc in rcs) else 1)
