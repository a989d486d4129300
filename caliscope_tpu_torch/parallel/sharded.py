"""Sharding the bundle-adjustment problem over torch.distributed.

Port of caliscope_tpu/parallel/sharded.py. The JAX package runs one program
over a device mesh from a single controller, and GSPMD inserts the
collectives. PyTorch's idiom is one process per GPU: here a mesh is the
default process group plus this rank's device (`Mesh`), every rank runs
the same LM loop on its own shard of the problem, and the solver all-reduces
every sum that runs over the sharded axis (solvers/bundle.py).

- Dense layout (`shard_dense_problem`): the point axis is sharded. P is
  padded to a multiple of the world size with masked slots (lm_solve pads
  X0 with the centroid to match) and each rank holds a contiguous block of
  points: their observations in all C cameras and their coordinates. Camera
  sums (g_c, d_c, the Schur S and its right-hand side) and scalars summed
  over points are all-reduced; point quantities stay on their rank, and no
  point-axis tensor is gathered until the solve returns its points.
- Sparse layout (`shard_problem`): the observation axis is sharded, padded
  by repeating the last row with obs_mask=False (which keeps the rows
  sorted by (point, camera)). Points are replicated; camera and point sums
  are all-reduced.
- Cameras and constraint rows are replicated on every rank. A constraint's
  contributions to the point sums and to the cost are added once: on the
  dense layout by the rank that owns the point, on the sparse layout after
  the all-reduce.

Every value that decides control flow (the LM's accept and stop tests, the
CG's stop test) is computed from all-reduced or replicated values, so all
ranks take the same branches.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

import torch
import torch.distributed as dist

from caliscope_tpu_torch.device import resolve_device


class Mesh:
    """The default process group a solve is sharded over, this rank's place
    in it and its device, with counts of the collectives issued through it.
    A baked solve (solvers/baked.py) captures its all-reduces in CUDA graphs
    over NCCL and adds each graph's count here per replay."""

    def __init__(self, device: torch.device):
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.device = device
        self.all_reduces = 0  # collectives issued (sums and maxima)
        self.bytes_reduced = 0  # bytes of the tensors all-reduced
        self.all_gathers = 0

    def sum(self, *tensors: torch.Tensor) -> list[torch.Tensor]:
        """The tensors summed over the ranks, in one all-reduce of their
        concatenation (they share a dtype)."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self._all_reduce(flat, dist.ReduceOp.SUM)
        return [part.view(t.shape) for part, t in zip(torch.split(flat, [t.numel() for t in tensors]), tensors)]

    def max(self, t: torch.Tensor) -> torch.Tensor:
        out = t.clone()
        self._all_reduce(out, dist.ReduceOp.MAX)
        return out

    def _all_reduce(self, flat, op) -> None:
        dist.all_reduce(flat, op=op)
        self.all_reduces += 1
        self.bytes_reduced += flat.numel() * flat.element_size()

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's equally sized block of rows, concatenated in rank
        order."""
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous())
        self.all_gathers += 1
        return torch.cat(parts)


@dataclass(frozen=True)
class Shard:
    """A problem's place in a mesh: this rank's block [offset, offset +
    length) of the sharded axis (points on the dense layout, observation
    rows on the sparse one), padded to n_global over all ranks."""

    mesh: Mesh
    offset: int
    length: int
    n_global: int


def make_obs_mesh(device=None) -> Mesh:
    """The default process group as a mesh, with this rank's device:
    `device`, or CUDA device rank % device_count when none is named
    (raising without CUDA, as every entry point does). The process group
    must be initialised (torch.distributed.init_process_group)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_obs_mesh needs an initialised torch.distributed process group")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return Mesh(dev)


def _pad_len(n: int, k: int) -> int:
    return (n + k - 1) // k * k


def _block(mesh: Mesh, n: int) -> tuple[int, int, int]:
    n_global = _pad_len(max(n, mesh.size), mesh.size)
    length = n_global // mesh.size
    return mesh.rank * length, length, n_global


def shard_dense_problem(problem, mesh: Mesh):
    """This rank's block of the dense layout's point axis; cameras and
    constraints replicate. Padded points have every slot masked and are
    pinned by the solver's zero-diagonal prior; the caller pads X0 to match
    (lm_solve does)."""
    offset, length, n_global = _block(mesh, problem.n_points)
    pad = n_global - problem.n_points

    def block(a, fill):
        if pad:
            a = torch.cat([a, torch.full((*a.shape[:-1], pad), fill, dtype=a.dtype, device=a.device)], -1)
        return a[..., offset : offset + length].contiguous()

    return replace(
        problem,
        uv=block(problem.uv, 0),
        obs_mask=block(problem.obs_mask, False),
        shard=Shard(mesh, offset, length, n_global),
    )


# the problem fields summed into check_same_problem's fingerprint (either
# layout; a field the layout lacks enters as a fixed marker)
CHECKED_FIELDS = (
    "cam_idx", "pt_idx", "uv", "obs_mask", "K0", "dist0", "fisheye", "inv_fx", "param_free",
    "con_pa_idx", "con_pa_w", "con_pb_idx", "con_pb_w", "con_target", "con_weight",
)


def _fingerprint(t, device) -> torch.Tensor:
    """(size, sum, position-weighted sum) of a tensor or array, in float64."""
    if t is None:
        return torch.full((3,), -1.0, dtype=torch.float64, device=device)
    x = torch.as_tensor(np.asarray(t) if not isinstance(t, torch.Tensor) else t, device=device).reshape(-1).to(torch.float64)
    pos = torch.arange(1, x.numel() + 1, dtype=torch.float64, device=device)
    return torch.stack([torch.tensor(float(x.numel()), dtype=torch.float64, device=device), x.sum(), (x * pos).sum()])


def check_same_problem(problem, mesh: Mesh, *replicated) -> None:
    """Raise ValueError unless every rank of the mesh holds the same whole
    problem and the same `replicated` arrays (a solve's start cameras and
    points). One all-reduce of a fingerprint of fixed size (three float64
    numbers a field), so ranks whose problems differ in shape raise too,
    together, instead of parting ways in a later collective."""
    device = problem.uv.device
    v = torch.cat([_fingerprint(getattr(problem, name, None), device) for name in CHECKED_FIELDS]
                  + [_fingerprint(a, device) for a in replicated])
    v = torch.nan_to_num(v, nan=-2.0, posinf=-3.0, neginf=-4.0)
    hi, neg_lo = mesh.max(torch.cat([v, -v])).chunk(2)
    if not torch.equal(hi, -neg_lo):
        raise ValueError(
            "the ranks hold different bundle-adjustment problems; a sharded solve needs the same problem and "
            "start on every rank (run independent solves with shard='never')"
        )


def shard_problem(problem, mesh: Mesh, *replicated):
    """This rank's shard of the problem (either layout): the observation
    rows of a sparse problem, padded to a multiple of the world size by
    repeating the last row with obs_mask=False; cameras and constraints
    replicate. A dense problem goes to shard_dense_problem. Raises
    ValueError, on every rank, unless all ranks pass the same problem and
    the same `replicated` arrays (check_same_problem)."""
    from caliscope_tpu_torch.solvers.bundle import BADenseProblem

    if problem.shard is not None:
        raise ValueError("the problem is already sharded")
    check_same_problem(problem, mesh, *replicated)
    if isinstance(problem, BADenseProblem):
        return shard_dense_problem(problem, mesh)
    offset, length, n_global = _block(mesh, problem.n_obs)
    pad = n_global - problem.n_obs

    def rows(a, masked=False):
        if pad:
            tail = torch.zeros_like(a[-1:]) if masked else a[-1:]
            a = torch.cat([a, tail.expand(pad, *a.shape[1:])])
        return a[offset : offset + length].contiguous()

    return replace(
        problem,
        cam_idx=rows(problem.cam_idx),
        pt_idx=rows(problem.pt_idx),
        uv=rows(problem.uv, masked=True),
        obs_mask=rows(problem.obs_mask, masked=True),
        shard=Shard(mesh, offset, length, n_global),
    )


def sharded_lm_iteration(problem, cam9, X, lam, mesh: Mesh = None, **kwargs):
    """One LM iteration of a problem already sharded by shard_problem, with
    the parameters replicated: (cam9', X', lam', cost', accepted), X' whole
    on every rank. kwargs as lm_iteration."""
    from caliscope_tpu_torch.solvers.bundle import lm_iteration

    if problem.shard is None or (mesh is not None and problem.shard.mesh is not mesh):
        raise ValueError("sharded_lm_iteration takes a problem sharded over the given mesh (shard_problem)")
    return lm_iteration(problem, cam9, X, lam, **kwargs)
