"""The paper's AMR application: the semilinear wave physics and the
compiled uniform-grid engine (`amr.compiled`).  The Berger-Oliger
hierarchy, regridding, task graph and the barrier/dataflow engines of
the reference are not ported yet (ROADMAP Queue A item 11)."""

from repro_torch.amr.wave import (H, NFIELDS, WaveProblem, energy,
                                  fused_rk3_block, global_step, grid,
                                  initial_data, linf)

__all__ = ["H", "NFIELDS", "WaveProblem", "energy", "fused_rk3_block",
           "global_step", "grid", "initial_data", "linf"]
