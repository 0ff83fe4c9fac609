"""The compiled ParalleX engine for a uniform grid on one device
(counterpart of `repro.amr.compiled`).

The reference erases the dataflow LCO graph of a window into one XLA
program over the production mesh.  Here the mesh is one card and the
same layout stays a tensor:

  * AGAS placement  -> the (locality, slot) layout of the block pool,
                       one (n_localities, slots, 3, grain) tensor; the
                       locality axis, sharded over chips in the
                       reference, is axis 0;
  * parcels         -> the two halo legs between neighbouring
                       localities (`lax.ppermute` in the reference), here
                       index shifts with wrap along that axis;
  * LCO/dataflow    -> stream order between rounds;
  * HPX threads     -> one fused-RK3 launch over every resident block of
                       every locality per step (`kernels/stencil`).

`shard_map` has no counterpart, and `lax.scan` over the steps becomes a
Python loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.amr.wave import (H, NFIELDS, WaveProblem, global_step,
                                  initial_data)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.stencil import ops


@dataclasses.dataclass(frozen=True)
class CompiledAMRConfig:
    """Static layout: n_localities x slots blocks of `grain` points."""

    grain: int = 256
    slots: int = 8              # blocks resident per locality
    n_steps: int = 8            # steps taken by one step_fn call
    # stencil backend: None runs the CUDA kernel on the card and the
    # plain version on the CPU (the reference's use_pallas)
    use_kernel: Optional[bool] = None
    # Communication-avoiding fusion: carry a 3k-cell halo and take k RK3
    # steps per parcel exchange.  Exchanges per step drop k-fold; extra
    # compute is the shrinking-halo overlap, fraction ~ 3k(k+1)/grain.
    steps_per_exchange: int = 1

    def n_blocks(self, n_loc: int) -> int:
        return n_loc * self.slots

    def n_points(self, n_loc: int) -> int:
        return self.n_blocks(n_loc) * self.grain


def assemble_halos(pool: torch.Tensor, hk: int) -> torch.Tensor:
    """(n_loc, S, 3, g) -> (n_loc * S, 3, g + 2 hk): every block with
    `hk` cells of each neighbour.  Intra-locality halos come from pool
    neighbours (an AGAS-local lookup); the pool-edge slots splice in the
    two parcel legs, which wrap around the ring.  With one step per
    exchange the physical refresh overwrites the wrapped cells of the
    first and last block; with several, the refresh of the earlier steps
    mirrors about the wrong column and leaves some of them, as the
    reference does (its layout is kept, so the two engines agree)."""
    n_loc, slots = pool.shape[:2]
    # right-moving leg: my last block's right edge -> next locality;
    # left-moving leg: my first block's left edge -> previous locality
    from_left = torch.roll(pool[:, -1, :, -hk:], 1, 0)
    from_right = torch.roll(pool[:, 0, :, :hk], -1, 0)
    lefts = torch.cat([from_left[:, None], pool[:, :-1, :, -hk:]], dim=1)
    rights = torch.cat([pool[:, 1:, :, :hk], from_right[:, None]], dim=1)
    u = torch.cat([lefts, pool, rights], dim=-1)
    return u.reshape(n_loc * slots, NFIELDS, -1)


def make_uniform_step(prob: WaveProblem, cfg: CompiledAMRConfig,
                      n_loc: int, device: DeviceLike = None):
    """Build the n-step evolution of a uniform grid of `n_loc`
    localities on one device.

    Returns (step_fn, make_inputs, initial_pool, to_global, device,
    info), the reference's order with the device in its sharding slot:
    step_fn(pool) -> pool advances cfg.n_steps steps; pool has shape
    (n_loc, slots, NFIELDS, grain); make_inputs() gives that shape and
    the dtype.
    """
    dev = resolve_device(device)
    g = cfg.grain
    S = cfg.slots
    nb = cfg.n_blocks(n_loc)
    n_pts = cfg.n_points(n_loc)
    dr = prob.rmax / (n_pts - 1)
    dt = prob.cfl * dr
    dtype = prob.torch_dtype()

    K = cfg.steps_per_exchange
    HK = H * K
    if cfg.n_steps % K:
        raise ValueError("n_steps must be a multiple of "
                         "steps_per_exchange")
    if HK > g:
        raise ValueError("halo exceeds grain: lower steps_per_exchange")

    # physical-boundary masks: only the first block of the first
    # locality and the last block of the last one
    left_phys = torch.zeros((nb, 1, 1), dtype=torch.bool, device=dev)
    right_phys = torch.zeros((nb, 1, 1), dtype=torch.bool, device=dev)
    left_phys[0] = True
    right_phys[-1] = True

    # radial coordinates per block, (int start -> float) + offset, * dr;
    # step i of an exchange sees the validity band shrunk by H per side
    blk0 = torch.arange(nb, device=dev) * g
    offsets = torch.arange(-HK, g + HK, dtype=dtype, device=dev)
    r_full = (blk0[:, None] + offsets[None, :]) * dr
    r_ext = [r_full[:, H * i: r_full.shape[1] - H * i].contiguous()
             for i in range(K)]

    def local_step(pool: torch.Tensor) -> torch.Tensor:
        """One exchange + K fused RK3 steps over every block."""
        u = assemble_halos(pool, HK)
        for i in range(K):
            # one fused RK3 per block (the reference's vmapped block step)
            u = ops.stencil_rk3_step(u, r_ext[i], left_phys, right_phys,
                                     dr=dr, dt=dt, p=prob.p,
                                     use_kernel=cfg.use_kernel)
        return u.reshape(n_loc, S, NFIELDS, g)

    def step_fn(pool: torch.Tensor) -> torch.Tensor:
        for _ in range(cfg.n_steps // K):
            pool = local_step(pool)
        return pool

    def make_inputs():
        return (n_loc, S, NFIELDS, g), dtype

    def initial_pool() -> torch.Tensor:
        """Initial data laid out into the pool."""
        u = initial_data(prob, level_dr=dr, n=n_pts, device=dev)
        blocks = u.reshape(NFIELDS, n_loc, S, g)
        return blocks.permute(1, 2, 0, 3).contiguous()

    def to_global(pool: torch.Tensor) -> torch.Tensor:
        return pool.permute(2, 0, 1, 3).reshape(NFIELDS, n_pts)

    return step_fn, make_inputs, initial_pool, to_global, dev, dict(
        n_loc=n_loc, grain=g, slots=S, n_points=n_pts, dr=dr, dt=dt)


def reference_uniform(prob: WaveProblem, n_pts: int, n_steps: int,
                      dr: float, dt: float,
                      device: DeviceLike = None) -> torch.Tensor:
    """Global plain oracle for the compiled engine."""
    u = initial_data(prob, level_dr=dr, n=n_pts, device=device)
    r = torch.arange(n_pts, dtype=u.dtype, device=u.device) * dr
    for _ in range(n_steps):
        u = global_step(u, r, dr, dt, prob.p)
    return u
