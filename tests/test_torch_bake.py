"""Baked bundle-adjustment problems (BAConfig(bake_problem=True),
caliscope_tpu_torch/solvers/baked.py) held against the JAX package's baked
solve and against the port's own unbaked solve.

Inputs: a 4-camera ring rig of 60 points (tests/torch_ba_common.py) on the
dense layout, its sparse rows with repeated pairs and masked padding rows,
and 40 distance rows, all from a seed. Float64 on the CPU, both sides.

- Against the JAX package's baked solve (its executable compiles the problem
  in, so two solves here, each one compile): the tolerances of
  tests/test_torch_bundle.py (cost_initial 1e-12 and cost_final 1e-9
  relative, cam9 and X 1e-8 absolute) and the same LM iterations.
- Against the port's unbaked solve: bit for bit (torch.equal on cam9 and X,
  the same costs, iterations, convergence and CG iterations), over every
  layout and solver. On the CPU the baked runner calls the unbaked loop's
  own pieces, so anything but the same bits is a fault of the split.
- On CUDA (marked, skips here): the same with the fused Schur kernel inside
  the captured head graph, and its launches counted per replay.
"""

from __future__ import annotations

import dataclasses
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caliscope_tpu.solvers import bundle as JB

from caliscope_tpu_torch.solvers import baked as BK
from caliscope_tpu_torch.solvers import bundle as TB
from caliscope_tpu_torch.solvers import fused_schur as FS
from torch_ba_common import constraint_rows, ring_rig, sparse_rows

COST0_RTOL = 1e-12
COST_RTOL = 1e-9
PARAM_ATOL = 1e-8
CG_TAIL = 13  # cg_max_iter that is no multiple of CG_CHECK_EVERY: the shorter last chunk runs


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for this file's small solves: under
    xdist's parallel workers a thread pool per worker spins against the
    others. The worker's setting is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    """(rig, {name: (JAX problem or None, port problem)})."""
    rng = np.random.default_rng(31)
    rig = ring_rig(rng, C=4, P=60)
    cam, pt, uv, mask = sparse_rows(rng, rig)
    con = constraint_rows(rng, rig[8], Q=40)
    P = rig[7].shape[0]
    problems = {
        "dense": (
            JB.make_dense_problem(*rig[:6], n_points=P),
            TB.make_dense_problem(*rig[:6], n_points=P, device="cpu"),
        ),
        "sparse": (None, TB.make_problem(cam, pt, uv, *rig[3:6], obs_mask=mask, device="cpu")),
        "dense_constrained": (None, TB.make_dense_problem(*rig[:6], n_points=P, constraints=con, device="cpu")),
        "sparse_constrained": (
            JB.make_problem(cam, pt, uv, *rig[3:6], constraints=con, obs_mask=mask),
            TB.make_problem(cam, pt, uv, *rig[3:6], constraints=con, obs_mask=mask, device="cpu"),
        ),
    }
    return rig, problems


def fresh(problem, clone=False):
    """The same tensors (or copies of them) in a new problem object, without
    a runner cache."""
    if not clone:
        return dataclasses.replace(problem)
    return dataclasses.replace(problem, **{
        f.name: getattr(problem, f.name).clone()
        for f in dataclasses.fields(problem) if isinstance(getattr(problem, f.name), torch.Tensor)
    })


def assert_same_bits(got, want):
    assert got.n_iterations == want.n_iterations and got.converged == want.converged
    assert got.cg_iterations == want.cg_iterations
    assert (got.solver, got.obs_minor, got.fused_schur) == (want.solver, want.obs_minor, want.fused_schur)
    np.testing.assert_array_equal(got.cam9, want.cam9)
    assert torch.equal(got.X, want.X)
    assert got.cost_initial == want.cost_initial and got.cost_final == want.cost_final
    assert got.gradient_norm == want.gradient_norm


JAX_CASES = [
    ("dense", dict(solver="schur")),
    ("sparse_constrained", dict(solver="schur", obs_minor="never", cg_max_iter=CG_TAIL, max_iter=30)),
]


@pytest.mark.parametrize("name,cfg", JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_baked_solve_matches_jax_baked(case, name, cfg):
    rig, problems = case
    jp, tp = problems[name]
    want = JB.lm_solve(jp, rig[6], rig[7], JB.BAConfig(bake_problem=True, **cfg))
    assert len(jp._baked_runners) == 1  # the JAX package's own cache
    tp = fresh(tp)
    got = TB.lm_solve(tp, rig[6], rig[7], TB.BAConfig(bake_problem=True, **cfg))
    assert len(tp._baked_runners) == 1
    assert got.n_iterations == want.n_iterations and got.converged == want.converged
    np.testing.assert_allclose(got.cost_initial, want.cost_initial, rtol=COST0_RTOL)
    np.testing.assert_allclose(got.cost_final, want.cost_final, rtol=COST_RTOL)
    np.testing.assert_allclose(got.cam9, want.cam9, atol=PARAM_ATOL, rtol=0)
    np.testing.assert_allclose(got.X.numpy(), np.asarray(want.X), atol=PARAM_ATOL, rtol=0)
    if name == "sparse_constrained":  # every CG ran to its cap: 8 + the shorter chunk of 5
        assert got.cg_iterations and max(got.cg_iterations) == CG_TAIL


BIT_CASES = [
    (layout, solver, obs_minor, cg_max_iter)
    for layout, minors in (("dense", (False,)), ("sparse", (False, True)))
    for obs_minor in minors
    for solver in ("dense", "schur", "schur_cg", "cg")
    for cg_max_iter in (200,)
] + [
    (layout, solver, obs_minor, CG_TAIL)
    for layout, obs_minor in (("dense_constrained", False), ("sparse_constrained", False), ("sparse_constrained", True))
    for solver in ("schur", "cg")
]


def _bit_id(c):
    layout, solver, obs_minor, cg_max_iter = c
    return f"{layout}{'-obs_minor' if obs_minor else ''}-{solver}-cg{cg_max_iter}"


@pytest.mark.parametrize("layout,solver,obs_minor,cg_max_iter", BIT_CASES, ids=[_bit_id(c) for c in BIT_CASES])
def test_baked_equals_unbaked_bit_for_bit(case, layout, solver, obs_minor, cg_max_iter):
    rig, problems = case
    tp = fresh(problems[layout][1])
    cfg = dict(solver=solver, obs_minor="always" if obs_minor else "never", cg_max_iter=cg_max_iter, max_iter=25)
    want = TB.lm_solve(tp, rig[6], rig[7], TB.BAConfig(**cfg))
    got = TB.lm_solve(tp, rig[6], rig[7], TB.BAConfig(bake_problem=True, **cfg))
    assert got.solver == solver and got.obs_minor == obs_minor
    assert_same_bits(got, want)
    runner = next(iter(tp._baked_runners.values()))
    # one read of the LM's flag an iteration, one of the CG's a chunk
    chunks = sum(max(1, -(-c // 8)) if c < cg_max_iter else len(BK._cg_chunks(cg_max_iter)) for c in got.cg_iterations)
    assert runner.host_reads == got.n_iterations + chunks
    assert runner.has_cg == bool(got.cg_iterations)


def test_the_cache_reuses_clones_and_recaptures(case):
    rig, problems = case
    tp = fresh(problems["sparse_constrained"][1], clone=True)  # edited below
    cfg = TB.BAConfig(solver="schur", cg_max_iter=CG_TAIL, max_iter=10)
    first = TB.lm_solve(tp, rig[6], rig[7], TB.BAConfig(solver="schur", cg_max_iter=CG_TAIL, max_iter=10, bake_problem=True))
    X_first = first.X.clone()
    (key, runner), = tp._baked_runners.items()
    assert key[0] == tuple(sorted(key[0])) and runner.solves == 1
    # a second solve, from another start, reuses the runner and leaves the
    # first result's points alone
    rng = np.random.default_rng(2)
    X_other = rig[7] + rng.normal(scale=0.003, size=rig[7].shape)
    second = TB.lm_solve(tp, rig[6], X_other, TB.BAConfig(solver="schur", cg_max_iter=CG_TAIL, max_iter=10, bake_problem=True))
    assert list(tp._baked_runners.values()) == [runner] and runner.solves == 2
    assert torch.equal(first.X, X_first) and not torch.equal(second.X, first.X)
    assert_same_bits(second, TB.lm_solve(tp, rig[6], X_other, cfg))
    # another configuration adds an entry
    TB.lm_solve(tp, rig[6], rig[7], TB.BAConfig(solver="cg", cg_max_iter=CG_TAIL, max_iter=3, bake_problem=True))
    assert len(tp._baked_runners) == 2 and tp._baked_runners[key] is runner
    # a field edited in place: the runner is made again, and solves the edited problem
    tp.uv.add_(0.25)
    edited = TB.lm_solve(tp, rig[6], rig[7], TB.BAConfig(solver="schur", cg_max_iter=CG_TAIL, max_iter=10, bake_problem=True))
    assert tp._baked_runners[key] is not runner and len(tp._baked_runners) == 2
    assert_same_bits(edited, TB.lm_solve(tp, rig[6], rig[7], cfg))
    assert edited.cost_initial != first.cost_initial
    # a field replaced: made again
    runner = tp._baked_runners[key]
    tp.con_weight = tp.con_weight * 2.0
    again = TB.lm_solve(tp, rig[6], rig[7], TB.BAConfig(solver="schur", cg_max_iter=CG_TAIL, max_iter=10, bake_problem=True))
    assert tp._baked_runners[key] is not runner
    assert_same_bits(again, TB.lm_solve(tp, rig[6], rig[7], cfg))
    # the runner holds a copy of the problem object, not the problem itself
    assert tp._baked_runners[key].problem is not tp


def test_capture_volume_optimize_baked_equals_unbaked():
    from caliscope_tpu_torch.synthetic.factories import default_ring_scene
    from caliscope_tpu_torch.volume import CaptureVolume

    scene = default_ring_scene(4, 12)
    ip = scene.image_points_noisy()
    volume = CaptureVolume(scene.cameras, ip, ip.triangulate(scene.cameras, device="cpu"), device="cpu")
    want = volume.optimize(refine_intrinsics=True)
    got = volume.optimize(refine_intrinsics=True, bake_problem=True)
    np.testing.assert_array_equal(got.world_points.xyz, want.world_points.xyz)
    for cid, cam in want.camera_array.cameras.items():
        other = got.camera_array.cameras[cid]
        np.testing.assert_array_equal(other.rotation, cam.rotation)
        np.testing.assert_array_equal(other.translation, cam.translation)
        np.testing.assert_array_equal(other.matrix, cam.matrix)
    assert got.optimization_status.final_cost == want.optimization_status.final_cost
    assert got.optimization_status.iterations == want.optimization_status.iterations


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sharded_baked_on_the_cpu_over_gloo(case):
    """A world of one over gloo with CPU tensors: the baked solve is the
    unbaked one, bit for bit, with the same all-reduces."""
    import torch.distributed as dist

    from caliscope_tpu_torch.parallel import make_obs_mesh

    rig, problems = case
    tp = fresh(problems["dense_constrained"][1])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    try:
        mesh = make_obs_mesh("cpu")
        cfg = dict(solver="schur", cg_max_iter=CG_TAIL, max_iter=8)
        n0 = mesh.all_reduces
        want = TB.lm_solve(tp, rig[6], rig[7], TB.BAConfig(**cfg), mesh=mesh)
        n1 = mesh.all_reduces
        got = TB.lm_solve(tp, rig[6], rig[7], TB.BAConfig(bake_problem=True, **cfg), mesh=mesh)
        n2 = mesh.all_reduces
    finally:
        dist.destroy_process_group()
    assert got.n_devices == 1 and n2 - n1 == n1 - n0 > 0
    assert_same_bits(got, want)


@pytest.mark.cuda
def test_baked_kernel_path_on_cuda(case):
    """On the card: the dense reprojection-only Schur solve baked into CUDA
    graphs, with kernel 1 in the head graph, equals the unbaked solve bit
    for bit; kernel 1's launches equal the Schur solves of each; a second
    solve captures nothing new."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py's baked phase runs this check on the card")
    rig, _ = case
    P = rig[7].shape[0]
    tp = TB.make_dense_problem(*rig[:6], n_points=P, device="cuda")
    cfg = dict(solver="schur", max_iter=15)
    n0 = FS.schur_s_rhs.launches
    want = TB.lm_solve(tp, rig[6], rig[7], TB.BAConfig(**cfg))
    n1 = FS.schur_s_rhs.launches
    got = TB.lm_solve(tp, rig[6], rig[7], TB.BAConfig(bake_problem=True, **cfg))
    n2 = FS.schur_s_rhs.launches
    again = TB.lm_solve(tp, rig[6], rig[7], TB.BAConfig(bake_problem=True, **cfg))
    n3 = FS.schur_s_rhs.launches
    assert want.fused_schur and got.fused_schur
    assert n1 - n0 == want.n_iterations and n2 - n1 == got.n_iterations and n3 - n2 == again.n_iterations
    (runner,) = tp._baked_runners.values()
    assert runner.graphs is not None and runner.counts["head"][0] == 1 and runner.solves == 2
    assert_same_bits(got, want)
    assert_same_bits(again, want)
