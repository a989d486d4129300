"""One rank of tests/test_torch_sharded_bundle.py's process group.

    python tests/torch_sharded_worker.py RANK WORLD PORT INPUTS.npz OUT_DIR

Joins a gloo process group at tcp://127.0.0.1:PORT, runs every case of the
test on the CPU in float64 — the port's single placement and its solve
sharded over the group — and writes OUT_DIR/rank{RANK}.npz. Every
all-reduce and all-gather is recorded with its element count, per case.
"""

from __future__ import annotations

import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from caliscope_tpu_torch.parallel import make_obs_mesh, shard_problem, sharded_lm_iteration  # noqa: E402
from caliscope_tpu_torch.solvers import bundle as TB  # noqa: E402

COLLECTIVES: list[tuple[str, int]] = []


def _recorded(name, fn):
    def wrapper(tensor, *args, **kwargs):
        t = tensor[0] if isinstance(tensor, list) else tensor
        COLLECTIVES.append((name, t.numel() if name == "all_reduce" else args[0].numel()))
        return fn(tensor, *args, **kwargs)

    return wrapper


dist.all_reduce = _recorded("all_reduce", dist.all_reduce)
dist.all_gather = _recorded("all_gather", dist.all_gather)


def sparse_problem(d):
    return TB.make_problem(d["cam_idx"], d["pt_idx"], d["uv"], d["K"], d["dist"], d["fisheye"], device="cpu")


def dense_problem(d, constrained=False):
    cons = tuple(d[k] for k in ("pa_idx", "pa_w", "pb_idx", "pb_w", "target", "weight")) if constrained else None
    return TB.make_dense_problem(
        d["cam_idx"], d["pt_idx"], d["uv"], d["K"], d["dist"], d["fisheye"], n_points=int(d["n_points"]),
        constraints=cons, device="cpu",
    )


def solve_fields(prefix, res):
    return {
        f"{prefix}_cam9": res.cam9, f"{prefix}_X": res.X.numpy(), f"{prefix}_cost": res.cost_final,
        f"{prefix}_iters": res.n_iterations, f"{prefix}_devices": res.n_devices,
    }


def counted(out, name, fn):
    """Run fn, keeping the collectives it issued under `name`: (kind, numel)
    pairs in order, as two arrays."""
    COLLECTIVES.clear()
    value = fn()
    out[f"{name}_kinds"] = np.array([k for k, _ in COLLECTIVES])
    out[f"{name}_sizes"] = np.array([n for _, n in COLLECTIVES], np.int64)
    return value


def main(rank: int, world: int, port: int, inputs: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank, timeout=timedelta(seconds=120)
    )
    d = dict(np.load(inputs))
    out: dict[str, np.ndarray] = {}
    mesh = make_obs_mesh("cpu")
    cam9, X0, lam = d["cam9"], d["X0"], np.float64(1e-4)

    # one LM iteration of the sparse problem
    sp = sparse_problem(d)
    single = TB.lm_iteration(sp, cam9, X0, lam, cg_max_iter=100)
    sharded = counted(out, "iteration", lambda: sharded_lm_iteration(shard_problem(sp, mesh), cam9, X0, lam, mesh, cg_max_iter=100))
    for prefix, res in (("iteration_single", single), ("iteration_sharded", sharded)):
        for name, v in zip(("cam9", "X", "lam", "cost", "accept"), res):
            out[f"{prefix}_{name}"] = v.numpy()

    # a full sparse solve, the problem sharded first
    cfg = TB.BAConfig(max_iter=20, solver="cg", shard="never")
    out |= solve_fields("sparse_single", TB.lm_solve(sp, cam9, X0, cfg))
    out |= solve_fields("sparse_sharded", TB.lm_solve(shard_problem(sp, mesh), cam9, X0, cfg))

    # the shard policy inside lm_solve
    for policy, kw in (("never", {}), ("always", {}), ("auto", {}), ("auto_min1", dict(shard_min_obs=1))):
        config = TB.BAConfig(max_iter=15, shard=policy.split("_")[0], **kw)
        out |= solve_fields(f"policy_{policy}", TB.lm_solve(sp, cam9, X0, config))

    # the dense layout: reprojection-only, then with constraint rows
    fixed = dict(ftol=0.0, gtol=0.0, xtol=0.0, solver="schur")
    for name, constrained, iters in (("dense", False, 10), ("constrained", True, 6)):
        problem = dense_problem(d, constrained)
        config = TB.BAConfig(max_iter=iters, **fixed)
        out |= solve_fields(f"{name}_single", TB.lm_solve(problem, cam9, d["Xb"], config))
        res = counted(out, name, lambda: TB.lm_solve(problem, cam9, d["Xb"], config, mesh=mesh))
        out |= solve_fields(f"{name}_sharded", res)
        out[f"{name}_cg"] = np.array(res.cg_iterations, np.int64)

    # CaptureVolume.optimize, the production path
    from caliscope_tpu_torch.synthetic.camera_synthesizer import strip_extrinsics
    from caliscope_tpu_torch.synthetic.factories import default_ring_scene
    from caliscope_tpu_torch.volume import CaptureVolume

    scene = default_ring_scene(noise_sigma_px=0.5, n_frames=8)
    vol = CaptureVolume.bootstrap(scene.image_points_noisy(), strip_extrinsics(scene.cameras), device="cpu")
    out["volume_rmse0"] = vol.reprojection_report.overall_rmse
    # single placement with the solver 'auto' takes when sharded
    for policy, kw in (("never", dict(solver="schur")), ("always", {})):
        v = vol.optimize(shard=policy, **kw)
        cams = v.camera_array
        out[f"volume_{policy}_rmse"] = v.reprojection_report.overall_rmse
        out[f"volume_{policy}_cost"] = v.optimization_status.final_cost
        out[f"volume_{policy}_iters"] = v.optimization_status.iterations
        out[f"volume_{policy}_cam9"] = TB.initial_cam9(cams)
        out[f"volume_{policy}_xyz"] = v.world_points.xyz
    # ranks holding different problems: every rank raises, and together
    for case in ("values", "shapes"):
        other = dict(d)
        if rank == 1 and case == "values":
            other["uv"] = d["uv"] + 1e-9
        if rank == 1 and case == "shapes":
            other = {k: v[:-1] if k in ("cam_idx", "pt_idx", "uv") else v for k, v in d.items()}
        try:
            TB.lm_solve(sparse_problem(other), cam9, X0, TB.BAConfig(max_iter=3, shard="always"))
            out[f"mismatch_{case}"] = np.array("no error")
        except ValueError as e:
            out[f"mismatch_{case}"] = np.array(str(e))
    dist.barrier()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
