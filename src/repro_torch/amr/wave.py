"""The paper's application physics: semilinear wave equation in
spherical symmetry (paper Sec. III, Eqns. 1-3; Liebling PRD 71 044019),
on torch tensors (counterpart of `repro.amr.wave`).

    chi_t = Pi                                   (1)
    Phi_t = d_r Pi                               (2)
    Pi_t  = (1/r^2) d_r (r^2 Phi) + chi^p        (3)    p = 7

Second-order centered finite differences in space, third-order SSP
Runge-Kutta (Shu-Osher) in time, initial data a Gaussian pulse

    chi0 = A exp[-(r - R0)^2 / delta^2],  Phi0 = d_r chi0,  Pi0 = 0,

R0 = 8, delta = 1, amplitude A tuned to explore criticality.

The *fused block step* is the unit of work of a ParalleX task: one RK3
step on a block carrying a halo of H = 3 ghost cells per side (one
stencil radius per RK stage), so a task needs neighbor data only once
per step.

Physical boundaries are local: the origin uses even/odd/even mirror
symmetry for (chi, Phi, Pi) plus the l'Hopital regularization
(1/r^2) d_r(r^2 Phi)|_{r=0} = 3 Phi'(0); the outer boundary uses linear
extrapolation ghosts.  Both are refreshed after every RK stage, so a
boundary block loses no halo width at its physical side.

The torch functions take any leading batch dimensions: a state is
(..., 3, W) and its radii (..., W), so `fused_rk3_block` on a batch of
blocks is the reference's vmapped one.  The arithmetic keeps the
reference's float order.  The numpy twins are copies of the
reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, torch_dtype

H = 3          # halo width: 1 stencil radius x 3 RK stages
NFIELDS = 3    # chi, Phi, Pi
SIGNS = np.array([1.0, -1.0, 1.0])  # mirror parity of (chi, Phi, Pi) at r=0


@dataclasses.dataclass(frozen=True)
class WaveProblem:
    """Static problem definition (paper Sec. III parameters)."""

    p: int = 7
    amplitude: float = 0.01
    r0: float = 8.0
    delta: float = 1.0
    rmax: float = 20.0
    n_points: int = 512          # base (level-0) grid points
    cfl: float = 0.25
    dtype: str = "float32"

    @property
    def dr(self) -> float:
        # r_i = i * dr, i = 0 .. n_points-1; r=0 is on the grid.
        return self.rmax / (self.n_points - 1)

    @property
    def dt(self) -> float:
        return self.cfl * self.dr

    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


def _ipow(x: torch.Tensor, p: int) -> torch.Tensor:
    """x ** p for an integer p by binary exponentiation, in the order of
    JAX's `integer_pow` (x^7 = (x * x^2) * x^4)."""
    if p == 0:
        return torch.ones_like(x)
    y, acc = abs(p), None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return 1.0 / acc if p < 0 else acc


def _where(cond, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`a` where `cond`, else `b`; `cond` a Python bool or a bool tensor
    that broadcasts."""
    if isinstance(cond, (bool, np.bool_)):
        return a if cond else b
    return torch.where(cond, a, b)


def grid(prob: WaveProblem, level_dr: Optional[float] = None,
         n: Optional[int] = None, offset: int = 0,
         device: DeviceLike = None) -> torch.Tensor:
    dr = prob.dr if level_dr is None else level_dr
    n = prob.n_points if n is None else n
    return (offset + torch.arange(n, dtype=prob.torch_dtype(),
                                  device=resolve_device(device))) * dr


def initial_data(prob: WaveProblem, level_dr: Optional[float] = None,
                 n: Optional[int] = None, offset: int = 0,
                 device: DeviceLike = None) -> torch.Tensor:
    """(3, n) initial state on a grid r_i = (offset + i) * level_dr."""
    r = grid(prob, level_dr, n, offset, device)
    chi = prob.amplitude * torch.exp(-((r - prob.r0) ** 2) / prob.delta**2)
    phi = chi * (-2.0 * (r - prob.r0) / prob.delta**2)  # analytic d_r chi
    pi = torch.zeros_like(chi)
    return torch.stack([chi, phi, pi])


def rhs(u: torch.Tensor, r: torch.Tensor, dr: float, p: int) -> torch.Tensor:
    """RHS of Eqns. (1)-(3) on the interior [1, W-1) of a width-W array
    (u (..., 3, W), r (..., W)).

    Edge cells of the result are zero-filled garbage; callers slice.
    """
    chi, phi, pi = u[..., 0, :], u[..., 1, :], u[..., 2, :]
    inner = slice(1, u.shape[-1] - 1)
    dpi = (pi[..., 2:] - pi[..., :-2]) / (2.0 * dr)
    r2phi = r * r * phi
    dmono = (r2phi[..., 2:] - r2phi[..., :-2]) / (2.0 * dr)
    rc = r[..., inner]
    # l'Hopital at r=0: (1/r^2) d_r(r^2 Phi) -> 3 Phi'(0).
    near_zero = torch.abs(rc) < 0.5 * dr
    safe_r2 = torch.where(near_zero, 1.0, rc * rc)
    dphi3 = 3.0 * (phi[..., 2:] - phi[..., :-2]) / (2.0 * dr)
    mono = torch.where(near_zero, dphi3, dmono / safe_r2)
    dchi = pi[..., inner]
    dpi_t = mono + _ipow(chi[..., inner], p)
    out = torch.zeros_like(u)
    out[..., 0, inner] = dchi
    out[..., 1, inner] = dpi
    out[..., 2, inner] = dpi_t
    return out


def refresh_physical_ghosts(u: torch.Tensor, left_phys, right_phys
                            ) -> torch.Tensor:
    """Refill the H ghost cells at physical sides from interior data.

    `left_phys`/`right_phys` are Python bools or bool tensors that
    broadcast against (..., 3, H) — the masked form keeps a batch of
    blocks uniform.  Left: mirror symmetry about r=0 (interior index H
    is the r=0 point).  Right: linear extrapolation.
    """
    w = u.shape[-1]
    signs = torch.as_tensor(SIGNS, dtype=u.dtype, device=u.device)[:, None]
    # ghosts 0,1,2 mirror interior 6,5,4 (about index H=3).
    left_vals = signs * u[..., [2 * H, 2 * H - 1, 2 * H - 2]]
    u = torch.cat([_where(left_phys, left_vals, u[..., 0:H]), u[..., H:]],
                  dim=-1)
    last = u[..., w - H - 1]
    prev = u[..., w - H - 2]
    slope = last - prev
    right_vals = torch.stack(
        [last + (k + 1) * slope for k in range(H)], dim=-1)
    return torch.cat([u[..., :w - H],
                      _where(right_phys, right_vals, u[..., w - H:])],
                     dim=-1)


def fused_rk3_block(u_ext: torch.Tensor, r_ext: torch.Tensor, dr: float,
                    dt: float, p: int, left_phys=False, right_phys=False
                    ) -> torch.Tensor:
    """One fused SSP-RK3 step on a block with H-cell halos.

    u_ext: (..., 3, g + 2H) state at time t, halos filled with neighbor
    data at time t (or physical ghosts); r_ext (..., g + 2H).  Returns
    (..., 3, g): interior at t + dt.

    Stage validity shrinks by one cell per side and stage at interior
    sides; physical sides are refreshed after every stage, so they do
    not shrink.  The discarded edge bands absorb the invalid cells.
    """
    def L(u):
        return rhs(u, r_ext, dr, p)

    u0 = refresh_physical_ghosts(u_ext, left_phys, right_phys)
    u1 = u0 + dt * L(u0)
    u1 = refresh_physical_ghosts(u1, left_phys, right_phys)
    u2 = 0.75 * u0 + 0.25 * (u1 + dt * L(u1))
    u2 = refresh_physical_ghosts(u2, left_phys, right_phys)
    u3 = u0 / 3.0 + (2.0 / 3.0) * (u2 + dt * L(u2))
    u3 = refresh_physical_ghosts(u3, left_phys, right_phys)
    return u3[..., H:-H]


def _rhs_np(u: np.ndarray, r: np.ndarray, dr: float, p: int) -> np.ndarray:
    """NumPy twin of `rhs` (host-engine fast path; same arithmetic)."""
    phi, pi = u[1], u[2]
    w = u.shape[-1]
    inner = slice(1, w - 1)
    dpi = (pi[2:] - pi[:-2]) / (2.0 * dr)
    r2phi = r * r * phi
    dmono = (r2phi[2:] - r2phi[:-2]) / (2.0 * dr)
    rc = r[inner]
    near_zero = np.abs(rc) < 0.5 * dr
    safe_r2 = np.where(near_zero, 1.0, rc * rc)
    dphi3 = 3.0 * (phi[2:] - phi[:-2]) / (2.0 * dr)
    mono = np.where(near_zero, dphi3, dmono / safe_r2)
    out = np.zeros_like(u)
    out[0, inner] = pi[inner]
    out[1, inner] = dpi
    out[2, inner] = mono + u[0, inner] ** p
    return out


def _refresh_np(u: np.ndarray, left_phys: bool, right_phys: bool
                ) -> np.ndarray:
    w = u.shape[-1]
    if left_phys:
        u[:, 0:H] = SIGNS[:, None].astype(u.dtype) * \
            u[:, [2 * H, 2 * H - 1, 2 * H - 2]]
    if right_phys:
        last = u[:, w - H - 1]
        slope = last - u[:, w - H - 2]
        for k in range(H):
            u[:, w - H + k] = last + (k + 1) * slope
    return u


def fused_rk3_block_np(u_ext: np.ndarray, r_ext: np.ndarray, dr: float,
                       dt: float, p: int, left_phys: bool = False,
                       right_phys: bool = False) -> np.ndarray:
    """NumPy twin of `fused_rk3_block` for the host dataflow engine.

    Static bool boundary flags only (host tasks know their sides).
    Kept in lockstep with the torch version; tests/test_torch_amr.py
    asserts they agree to float roundoff.
    """
    dr = u_ext.dtype.type(dr)
    dt = u_ext.dtype.type(dt)
    u0 = _refresh_np(u_ext.copy(), left_phys, right_phys)
    u1 = u0 + dt * _rhs_np(u0, r_ext, dr, p)
    u1 = _refresh_np(u1, left_phys, right_phys)
    u2 = u0.dtype.type(0.75) * u0 + u0.dtype.type(0.25) * \
        (u1 + dt * _rhs_np(u1, r_ext, dr, p))
    u2 = _refresh_np(u2, left_phys, right_phys)
    u3 = u0 / u0.dtype.type(3.0) + u0.dtype.type(2.0 / 3.0) * \
        (u2 + dt * _rhs_np(u2, r_ext, dr, p))
    u3 = _refresh_np(u3, left_phys, right_phys)
    return u3[:, H:-H]


def global_step(u: torch.Tensor, r: torch.Tensor, dr: float, dt: float,
                p: int) -> torch.Tensor:
    """Reference RK3 step on the whole level array (the plain oracle).

    Pads with physical ghosts on both sides and runs the identical fused
    step, so block-decomposed execution at any granularity must agree
    with it.
    """
    dtype = u.dtype
    pad = torch.zeros((NFIELDS, H), dtype=dtype, device=u.device)
    u_ext = torch.cat([pad, u, pad], dim=-1)
    r_ext = torch.cat([
        r[0] + torch.arange(-H, 0, dtype=dtype, device=u.device) * dr,
        r,
        r[-1] + torch.arange(1, H + 1, dtype=dtype, device=u.device) * dr,
    ])
    return fused_rk3_block(u_ext, r_ext, dr, dt, p,
                           left_phys=True, right_phys=True)


def energy(u: torch.Tensor, r: torch.Tensor, dr: float) -> torch.Tensor:
    """Diagnostic energy integral E = int (Pi^2 + Phi^2) r^2 dr.

    Not conserved for p=7 (the nonlinearity pumps energy) but smooth in
    time; a NaN/blow-up sentinel.
    """
    dens = (u[2] ** 2 + u[1] ** 2) * r * r
    return torch.sum(dens) * dr


def linf(u: torch.Tensor) -> torch.Tensor:
    return torch.max(torch.abs(u))
