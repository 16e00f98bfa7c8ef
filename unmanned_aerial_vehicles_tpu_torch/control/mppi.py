"""MPPI: sampling-based MPC for the 12-state rigid body (port of
``control/mppi.py``).

Each tick rolls K perturbed control sequences through the full nonlinear
plant and softmax-averages them by cost (Williams et al., information-
theoretic MPC). The sampling stage (K rollouts x N RK4 steps plus the stage
costs) is one launch of kernel K12 (``ops.mppi_pallas``) with
``fused_rollouts=True``, in float32 whatever the controller's dtype (the
costs are cast back). ``fused_rollouts=False``, or a float64 controller on
the CPU, runs K12's plain version in the controller's dtype. The softmax
and the update are PyTorch.

The exploration noise comes from a random stream whose state the carry
holds (``init_carry(state, seed)``: a ``torch.Generator``'s ``get_state()``
bytes). Each ``solve`` restores that state into the controller's scratch
generator, draws from it and puts the advanced state into the new carry, so
``solve`` is a function of its carry: two solves from one carry draw the
same noise, and the old and new carries never share a stream (as the JAX
package's split PRNG keys). ``solve(..., eps=...)`` takes an explicit ``(K, N, 4)``
standard-normal draw instead (another package's draws, for instance).

Interface as ``control.mpc_rigid.RigidBodyMPC`` (``init_carry`` / ``solve``
on the z-up rigid-body plant with ``[T, tau]`` inputs).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from .._device import resolve_device
from ..models.params import X500_PARAMS, RigidBodyParams
from ..models.rigid_body import rigid_body_rk4_step
from ..ops.mppi_pallas import mppi_rollout_costs_fused, mppi_rollout_costs_plain


@dataclass(frozen=True)
class MPPIConfig:
    horizon: int = 25
    num_samples: int = 512
    dt: float = 0.02
    temperature: float = 0.3      # lambda: softmax sharpness over costs
    # per-channel exploration noise std: [thrust N, tau x, tau y, tau z Nm]
    noise_std: Tuple[float, float, float, float] = (3.0, 0.03, 0.03, 0.01)
    # also roll out the updated nominal sequence and return it as X_nom
    return_trajectory: bool = False
    # the sampling stage through kernel K12 (in float32); False runs its
    # plain version
    fused_rollouts: bool = True
    # stage costs
    q_pos: float = 60.0
    q_vel: float = 6.0
    q_att: float = 30.0           # roll/pitch levelness
    q_yaw: float = 2.0
    q_rate: float = 1.0
    r_control: Tuple[float, float, float, float] = (0.02, 40.0, 40.0, 80.0)
    terminal_weight: float = 5.0  # multiplies q_pos/q_vel at the last stage

    @property
    def weights(self) -> tuple:
        """``(q_pos, q_vel, q_att, q_yaw, q_rate, r0..r3, terminal_weight)``,
        the sampling kernel's cost operand."""
        return (self.q_pos, self.q_vel, self.q_att, self.q_yaw, self.q_rate, *self.r_control,
                self.terminal_weight)


class MPPICarry(NamedTuple):
    U_nom: torch.Tensor            # (N, 4) nominal control sequence (warm start)
    rng_state: torch.Tensor        # the exploration stream's generator state (uint8)


class MPPIController:
    """Information-theoretic MPC on the rigid-body plant.

    Per ``solve``: sample K perturbation sequences, clip them to the
    actuator box, roll the plant out for each, weight by ``softmax(-cost /
    lambda)``, update the nominal sequence, apply its first control and
    shift it for the next tick."""

    def __init__(self, config: MPPIConfig = MPPIConfig(), params: RigidBodyParams = X500_PARAMS,
                 dtype=torch.float32, device=None):
        self.config = config
        self.params = params
        self.dtype = dtype
        self.device = resolve_device(device)
        kw = dict(dtype=dtype, device=self.device)
        mg = params.mass * params.gravity
        self.u_hover = torch.tensor([mg, 0.0, 0.0, 0.0], **kw)
        self._u_hover_host = (mg, 0.0, 0.0, 0.0)   # the kernel's argument, no device read
        self.u_lo = torch.tensor([0.3 * mg, -0.8, -0.8, -0.4], **kw)
        self.u_hi = torch.tensor([1.6 * mg, 0.8, 0.8, 0.4], **kw)
        self._noise_std = torch.tensor(config.noise_std, **kw)
        # restored from the carry before every draw, so its own state never
        # reaches a result
        self._scratch_gen = torch.Generator(device=self.device)

    def init_carry(self, state12: torch.Tensor, seed: int = 0) -> MPPICarry:
        """Hover warm start and the state of a generator seeded with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return MPPICarry(U_nom=self.u_hover[None, :].repeat(self.config.horizon, 1),
                         rng_state=gen.get_state())

    def _use_fused(self) -> bool:
        # K12 computes in float32 whatever the controller's dtype; only a
        # float64 controller on the CPU keeps its sampling stage in float64
        return self.config.fused_rollouts and (self.device.type != "cpu"
                                               or self.dtype == torch.float32)

    def solve(self, carry: MPPICarry, state12: torch.Tensor, target_pos, target_yaw=0.0,
              reference_positions: torch.Tensor | None = None, eps: torch.Tensor | None = None):
        """One MPPI tick; returns ``(u0, X_nom, new_carry)`` (``X_nom`` is
        None unless ``return_trajectory``). ``reference_positions (N, 3)``
        are per-stage targets (a point ``target_pos`` is tiled otherwise);
        ``eps (K, N, 4)`` standard normals replace the generator's draw."""
        cfg = self.config
        kw = dict(dtype=self.dtype, device=self.device)
        x0 = state12.to(**kw)
        target_pos = torch.as_tensor(target_pos, **kw)
        target_yaw = torch.as_tensor(target_yaw, **kw)
        if reference_positions is not None:
            targets = torch.as_tensor(reference_positions, **kw)
        else:
            targets = target_pos[None, :].repeat(cfg.horizon, 1)
        rng_state = carry.rng_state
        if eps is None:
            gen = self._scratch_gen
            gen.set_state(rng_state)
            eps = torch.randn(cfg.num_samples, cfg.horizon, 4, generator=gen, **kw)
            rng_state = gen.get_state()
        U_cand = torch.minimum(torch.maximum(carry.U_nom[None] + self._noise_std * eps.to(**kw),
                                             self.u_lo), self.u_hi)

        rollout_costs = mppi_rollout_costs_fused if self._use_fused() else mppi_rollout_costs_plain
        costs = rollout_costs(x0, U_cand, targets, target_yaw, self.params, cfg.dt,
                              self._u_hover_host, cfg.weights).to(self.dtype)
        w = torch.softmax(-(costs - costs.min()) / cfg.temperature, dim=0)
        # weighted average of the clipped candidates (feasible: the box is
        # convex)
        U_new = torch.einsum("k,knu->nu", w, U_cand)

        X_nom = None
        if cfg.return_trajectory:
            X = [x0]
            for k in range(cfg.horizon):
                X.append(rigid_body_rk4_step(X[-1], U_new[k], self.params, cfg.dt))
            X_nom = torch.stack(X)
        U_shift = torch.cat([U_new[1:], U_new[-1:]])
        return U_new[0], X_nom, MPPICarry(U_nom=U_shift, rng_state=rng_state)
