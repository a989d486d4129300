"""Baked bundle-adjustment problems: the LM iteration as captured CUDA
graphs, cached on the problem.

Port of the `bake_problem=True` branch of caliscope_tpu/solvers/bundle.py::
lm_solve. There the problem's arrays are closed over by one jitted LM
program, which is cached on the problem instance (`problem._baked_runners`)
under the solver options, so repeated solves of one problem reuse it. Here a
`BakedRunner` takes that place, in the same cache: it owns the solve's plan
(solvers/bundle.py::_Plan), the bounds and every state buffer, and runs the
LM iteration in the pieces solvers/bundle.py splits it into at its two host
reads:

- init: the start's cost, the damping and the counters;
- head: blocks, gradient and the step as far as its CG (`_lm_head`), the
  CG's start where the solver ends in one;
- chunk: CG_CHECK_EVERY frozen CG iterations (`_pcg_chunk`), and a shorter
  one where cg_max_iter is no multiple of it;
- tail: the step from the CG's iterate, the gain-ratio update and the
  termination test (`_lm_tail`).

A solve copies its start into the buffers and runs init, then per LM
iteration head, chunks until the CG's flag reads false, and tail, reading
the LM's flag after it: the host reads of the unbaked loop, so the
iteration and CG counts are the unbaked solve's. It returns clones of what
it read from the buffers, so a later solve leaves an earlier result alone.

On CUDA each piece is captured once as a CUDA graph (torch.cuda.graph, all
in one private memory pool) after one eager warm-up pass, and a solve
replays them: the fused Schur kernel (kernel 1) runs inside the head graph
of every dense reprojection-only Schur solve, and a sharded problem's
NCCL all-reduces inside the graphs. A graph holds pointers where JAX holds
values, so the runner keeps every tensor its graphs read alive, and a
problem whose tensor fields were replaced or edited in place since the
capture is captured again (`baked_runner`). A capture that fails raises a
RuntimeError naming the piece and the op that refused; nothing falls back to
an unbaked solve. Over gloo on CUDA tensors the collectives run on the host,
which a graph cannot hold, so a baked sharded solve there raises ValueError.

On the CPU there are no graphs: the runner calls the same pieces eagerly,
which is its plain version, bit for bit the unbaked solve.

Counters: kernel 1's `schur_s_rhs.launches` and a mesh's `all_reduces` /
`bytes_reduced` count once when a piece is captured and nothing when it is
replayed. The runner takes the warm-up's and the captures' counts out again
and adds each graph's count per replay, so launches still equal Schur solves
and all-reduces the collectives that ran. A runner is not for two threads at
once.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten, tree_map

from caliscope_tpu_torch import _cuda_build
from caliscope_tpu_torch.solvers import fused_schur
from caliscope_tpu_torch.solvers.bundle import (
    _bounds,
    _cg_chunks,
    _CGSystem,
    _cost_only,
    _lm_head,
    _lm_tail,
    _make_plan,
    _pcg_chunk,
    _pcg_start,
)

CACHE_ATTR = "_baked_runners"  # the JAX package's name for the cache on the problem


def baked_runner(given, problem, P: int, opts: dict) -> "BakedRunner":
    """The runner of `problem` (`given` as the caller passed it, or its
    shard) for these solver options, from given's cache or made and cached
    now. The key is the JAX package's, `tuple(sorted(opts.items()))`, with
    the dtype, the device, the local point count and the mesh. A cached
    runner whose problem fields were replaced or edited in place since it
    captured is made again."""
    mesh = problem.shard.mesh if problem.shard is not None else None
    device = problem.uv.device
    if mesh is not None and device.type == "cuda":
        import torch.distributed as dist

        backend = str(dist.get_backend())
        if "nccl" not in backend:
            raise ValueError(
                f"bake_problem=True on a problem sharded over {backend} on CUDA tensors: {backend} runs its "
                "collectives on the host, which a CUDA graph cannot capture; shard over NCCL, or solve with "
                "bake_problem=False"
            )
    key = (tuple(sorted(opts.items())), problem.uv.dtype, device, P, mesh)
    cache = given.__dict__.setdefault(CACHE_ATTR, {})
    runner = cache.get(key)
    if runner is None or runner.stale(given):
        cache.pop(key, None)  # the stale runner's graphs and pool go with it
        # a copy of the problem object (the same tensors), so that the
        # runner does not hold the object that holds it
        runner = cache[key] = BakedRunner(dataclasses.replace(problem), P, opts, given)
    return runner


def _field_values(problem) -> list:
    """Each field of the problem with, for a tensor, its version counter
    (which every in-place edit moves)."""
    values = (getattr(problem, f.name) for f in dataclasses.fields(problem))
    return [(v, v._version if isinstance(v, torch.Tensor) else None) for v in values]


def _copy_into(dst, src) -> None:
    for d, s in zip(tree_flatten(dst)[0], tree_flatten(src)[0]):
        d.copy_(s)


class _FailingOp(TorchFunctionMode):
    """Notes the first torch function that raised under it (the op a capture
    refused)."""

    def __init__(self):
        super().__init__()
        self.name: Optional[str] = None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        try:
            return func(*args, **(kwargs or {}))
        except Exception:
            if self.name is None:
                self.name = getattr(func, "__qualname__", None) or getattr(func, "__name__", None) or repr(func)
            raise


class BakedRunner:
    """One problem's LM solve with fixed options, baked: its plan, bounds,
    state buffers and, on CUDA, its graphs. See the module docstring."""

    def __init__(self, problem, P: int, opts: dict, given):
        self.problem = problem
        self.opts = dict(opts)
        self.fields = _field_values(given)  # the caller's problem object, as it was at the capture
        dt, dev = problem.uv.dtype, problem.uv.device
        on_dev = dict(dtype=dt, device=dev)
        C = problem.n_cameras
        self.plan = _make_plan(problem, P, dt)
        self.mesh = self.plan.mesh
        self.lb, self.ub = _bounds(C, on_dev)
        self.cam9 = torch.zeros((C, 9), **on_dev)
        self.X = torch.zeros((P, 3), **on_dev)
        self.lam, self.cost0, self.cost, self.gnorm = (torch.zeros((), **on_dev) for _ in range(4))
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        self.running = torch.zeros((), dtype=torch.bool, device=dev)  # the CG's flag after a chunk
        self.lm_it = torch.zeros((), dtype=torch.int64, device=dev)
        self.cg_hist = torch.zeros(max(self.opts["max_iter"], 1), dtype=torch.int64, device=dev)
        self.cg = None  # the CG's state buffers (bundle._CGState), made by the first head
        self.chunks = _cg_chunks(self.opts["cg_max_iter"])
        self.ctx = None  # (the step or its _CGSystem, the model's terms) of the last head
        self.graphs = None  # {piece: torch.cuda.CUDAGraph} on CUDA
        self.pool = None  # the graphs' shared private memory pool (its id)
        self.counts = {}  # {piece: (kernel 1 launches, all-reduces, bytes reduced) per replay}
        self.capture_seconds = 0.0  # the warm-up pass and the captures, host clock
        self.host_reads = 0  # device->host reads of flags over this runner's solves
        self.solves = 0
        if dev.type == "cuda":
            self._capture()

    # ---- the pieces ---------------------------------------------------------

    def _init(self):
        o = self.opts
        cost0 = _cost_only(self.problem, self.cam9, self.X, o["loss"], o["f_scale"], o["obs_minor"], self.plan)
        self.cost0.copy_(cost0)
        self.cost.copy_(cost0)
        self.lam.fill_(o["init_lambda"])
        self.gnorm.fill_(float("inf"))
        self.lm_it.zero_()

    def _head(self):
        o = self.opts
        solved, gnorm, model, _, _ = _lm_head(
            self.problem, self.plan, self.cam9, self.X, self.lam, loss=o["loss"], f_scale=o["f_scale"],
            solver_kind=o["solver_kind"], fused=o["fused"], obs_minor=o["obs_minor"],
        )
        self.gnorm.copy_(gnorm)
        if isinstance(solved, _CGSystem):
            start = _pcg_start(solved.M_inv, solved.b, o["cg_tol"], solved.points_mesh)
            if self.cg is None:
                self.cg = tree_map(torch.empty_like, start)
            _copy_into(self.cg, start)
        self.ctx = (solved, model)

    def _chunk(self, n: int):
        solved = self.ctx[0]
        state, running = _pcg_chunk(solved.A_mv, solved.M_inv, self.cg, n, solved.points_mesh)
        _copy_into(self.cg, state)
        self.running.copy_(running)

    def _tail(self):
        o = self.opts
        solved, model = self.ctx
        if isinstance(solved, _CGSystem):
            dxc, dxp = solved.finish(self.cg.x)
            self.cg_hist.index_copy_(0, self.lm_it.view(1), self.cg.it.view(1))
        else:
            dxc, dxp = solved
        cam9, X, lam, cost, done = _lm_tail(
            self.problem, self.plan, self.cam9, self.X, self.lam, self.cost, self.gnorm, dxc, dxp, model,
            self.lb, self.ub, loss=o["loss"], f_scale=o["f_scale"], ftol=o["ftol"], xtol=o["xtol"], gtol=o["gtol"],
            obs_minor=o["obs_minor"],
        )
        _copy_into((self.cam9, self.X, self.lam, self.cost, self.done), (cam9, X, lam, cost, done))
        self.lm_it.add_(1)

    @property
    def has_cg(self) -> bool:
        return self.cg is not None

    def _piece(self, name):
        if isinstance(name, tuple):  # ("chunk", n)
            return lambda: self._chunk(name[1])
        return {"init": self._init, "head": self._head, "tail": self._tail}[name]

    def _piece_names(self):
        chunks = [("chunk", n) for n in sorted(set(self.chunks))] if self.has_cg else []
        return ["init", "head", *chunks, "tail"]

    # ---- capture and replay -------------------------------------------------

    def _counters(self):
        mesh = self.mesh
        return (fused_schur.schur_s_rhs.launches, mesh.all_reduces if mesh else 0, mesh.bytes_reduced if mesh else 0)

    def _set_counters(self, launches, reduces, nbytes):
        with _cuda_build._count_lock:
            fused_schur.schur_s_rhs.launches = launches
        if self.mesh is not None:
            self.mesh.all_reduces, self.mesh.bytes_reduced = reduces, nbytes

    def _capture(self):
        """One eager pass over the pieces on a side stream (it loads the
        kernels and libraries and makes the CG's buffers; the solve copies
        its own start in afterwards), then each piece captured into one
        shared pool; the counters as they were before."""
        t0 = time.perf_counter()
        before = self._counters()
        dev = self.problem.uv.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._init()
            self._head()  # makes the CG's buffers where the solver ends in a CG
            for name in self._piece_names()[2:]:
                self._piece(name)()
        main.wait_stream(side)
        torch.cuda.synchronize(dev)
        self.ctx = None  # the warm-up's blocks: the head's capture holds its own
        graphs, pool = {}, None
        try:
            for name in self._piece_names():
                piece = self._piece(name)
                g = torch.cuda.CUDAGraph()
                op = _FailingOp()
                start = self._counters()
                try:
                    with torch.cuda.graph(g, pool=pool, capture_error_mode="thread_local"):
                        with op:
                            piece()
                except Exception as e:
                    what = f"the op {op.name}" if op.name else "an op outside torch's functions (a collective, a kernel launch) or the capture's end"
                    raise RuntimeError(
                        f"bake_problem=True: capturing the baked LM iteration's {name} piece as a CUDA graph failed at "
                        f"{what}: {e}"
                    ) from e
                end = self._counters()
                self.counts[name] = tuple(b - a for a, b in zip(start, end))
                graphs[name] = g
                pool = g.pool()
        finally:
            self._set_counters(*before)
        self.graphs = graphs
        self.pool = pool
        torch.cuda.synchronize(dev)
        self.capture_seconds = time.perf_counter() - t0

    def _run(self, name):
        if self.graphs is None:
            return self._piece(name)()
        self.graphs[name].replay()
        launches, reduces, nbytes = self.counts[name]
        if launches:
            _cuda_build.count_launch(fused_schur.schur_s_rhs, "launches", n=launches)
        if self.mesh is not None:
            self.mesh.all_reduces += reduces
            self.mesh.bytes_reduced += nbytes

    def _read(self, flag: torch.Tensor) -> bool:
        self.host_reads += 1
        return bool(flag)

    def stale(self, given) -> bool:
        """Whether a field of the problem was replaced or edited in place
        since this runner captured."""
        return any(v is not w or a != b for (v, a), (w, b) in zip(_field_values(given), self.fields))

    def pool_bytes(self) -> Optional[int]:
        """Bytes of the device memory segments of the graphs' private pool
        (None on the CPU)."""
        if self.graphs is None:
            return None
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot() if s.get("segment_pool_id") == self.pool)

    def solve(self, cam9_0: torch.Tensor, X0: torch.Tensor):
        """The LM solve from (cam9_0, X0), this rank's points: (cam9, X,
        cost0, cost, gnorm, iterations, converged, CG iterations per LM
        iteration as device scalars), as bundle._lm_run returns them."""
        self.cam9.copy_(cam9_0)
        self.X.copy_(X0)
        self._run("init")
        it, done = 0, False
        while it < self.opts["max_iter"] and not done:
            self._run("head")
            if self.has_cg:
                for n in self.chunks:
                    self._run(("chunk", n))
                    if not self._read(self.running):
                        break
            self._run("tail")
            it += 1
            done = self._read(self.done)
        self.solves += 1
        cg = list(self.cg_hist[:it].clone()) if self.has_cg else []
        return (self.cam9.clone(), self.X.clone(), self.cost0.clone(), self.cost.clone(), self.gnorm.clone(),
                it, done, cg)
