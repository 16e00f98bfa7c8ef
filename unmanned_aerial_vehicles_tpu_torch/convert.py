"""Carry the JAX package's values across into the port's objects.

Every function here takes plain numpy arrays (``np.asarray`` of the JAX
package's arrays) and builds the port's counterpart, so both packages can
compute from identical operands. Padded JAX layouts (128-lane rows) are cut
down to the port's semantic shapes. This module imports neither JAX nor
the JAX package.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ._device import resolve_device
from .control.cascade_pid import CascadePidGains, ComparisonPidParams
from .control.mpc_sqp import SQPCarry
from .control.pid import PIDGains
from .gp.exact_gp import GPParams, GPPosterior
from .gp.per_dim import PerDimGP, Standardizer
from .gp.residual_gp import OutputCorrectionConfig, ResidualDataset
from .loop.closed_loop import FlightResumeState
from .loop.rigid_loop import MultiTickCarry
from .models.params import RigidBodyParams
from .models.px4_surrogate import RateLoopParams
from .ops.controller_pallas import FusedControllerData, StructuredBatchData
from .ops.rigid_tick_pallas import RigidTickOperands
from .ops.tick_pallas import FusedTickData, GPRows, build_tick_data


def _keep(a, dev):
    """A tensor of ``a``'s own dtype on ``dev`` (copied: JAX's host views
    are read-only)."""
    return torch.as_tensor(np.array(a, order="C"), device=dev)


def _t(a, dtype, dev):
    return _keep(a, dev).to(dtype)


def gp_posterior_from_numpy(
    X_train, chol, alpha, y_mean, y_std, length_scale, signal_variance, noise_variance,
    x_shift=None, y_train_norm=None, dtype=torch.float64, device=None,
) -> GPPosterior:
    """A ``GPPosterior`` from the JAX posterior's arrays. ``dtype`` applies
    to the factor, alpha and the hyperparameters; the training inputs and
    target statistics keep their own float width."""
    dev = resolve_device(device)
    keep = lambda a: _keep(a, dev)
    params = GPParams.create(
        length_scale=np.array(length_scale, np.float64),
        signal_variance=float(np.asarray(signal_variance)),
        noise_variance=float(np.asarray(noise_variance)),
        dtype=dtype, device=dev,
    )
    alpha_t = _t(alpha, dtype, dev)
    return GPPosterior(
        params=params,
        X_train=keep(X_train),
        chol=_t(chol, dtype, dev),
        alpha=alpha_t,
        y_mean=keep(y_mean),
        y_std=keep(y_std),
        y_train_norm=keep(y_train_norm) if y_train_norm is not None else torch.zeros_like(alpha_t),
        x_shift=keep(x_shift) if x_shift is not None else None,
    )


def dataset_from_numpy(X, Y, head, count, device=None) -> ResidualDataset:
    """A ``ResidualDataset`` ring buffer from the JAX one's arrays."""
    dev = resolve_device(device)
    keep = lambda a: _keep(a, dev)
    return ResidualDataset(
        X=keep(X), Y=keep(Y),
        head=torch.tensor(int(np.asarray(head)), dtype=torch.int64, device=dev),
        count=torch.tensor(int(np.asarray(count)), dtype=torch.int64, device=dev),
    )


def fused_controller_data_from_numpy(padded: Mapping[str, np.ndarray], horizon: int,
                                     nu: int = 4, nx: int = 6) -> FusedControllerData:
    """Cut the JAX package's padded ``FusedControllerData`` fields (a
    mapping such as ``jax_data._asdict()``) down to semantic shapes."""
    N = horizon
    Nnu, Nnx = N * nu, N * nx
    m = Nnu + Nnx
    a = {k: np.asarray(v, np.float32) for k, v in padded.items()}
    c = lambda arr: np.ascontiguousarray(arr)
    return FusedControllerData(
        SxT=c(a["SxT"][:nx, :Nnx]),
        SwT=c(a["SwT"][:Nnx, :Nnx]),
        SuTqT=c(a["SuTqT"][:Nnx, :Nnu]),
        SuT=c(a["SuT"][:Nnu, :Nnx]),
        P1=c(a["P1"][:m, :m]),
        P0mat=c(a["P0mat"][:Nnu, :m]),
        P0matT=c(a["P0matT"][:m, :Nnu]),
        MinvT=c(a["MinvT"][:Nnu, :Nnu]),
        u_lo_row=c(a["u_lo_row"][0, :m]),
        u_hi_row=c(a["u_hi_row"][0, :m]),
        x_lo_row=c(a["x_lo_row"][0, :m]),
        x_hi_row=c(a["x_hi_row"][0, :m]),
    )


def fused_tick_data_from_numpy(padded_ctrl: Mapping[str, np.ndarray], horizon: int,
                               nu: int = 4, nx: int = 6, device=None) -> FusedTickData:
    """``FusedTickData`` on ``device`` from the JAX controller data's
    padded fields (the tick layouts are rebuilt from them)."""
    ctrl = fused_controller_data_from_numpy(padded_ctrl, horizon, nu, nx)
    return build_tick_data(ctrl, horizon, nu, nx, device=device)


def gp_rows_from_numpy(ztrT, sq2_row, alpha_s, y_mean_row, inv_ls_row, scal_row,
                       kinv=None, y_std_row=None, n_features: int = 10,
                       device=None) -> GPRows:
    """``GPRows`` from the JAX package's padded GP rows (with ``kinv`` and
    ``y_std_row`` when they were built ``with_variance=True``)."""
    dev = resolve_device(device)
    f = lambda a: _t(a, torch.float32, dev).contiguous()
    d = n_features
    return GPRows(
        ztrT=f(np.asarray(ztrT)[:d, :]),
        sq2=f(np.asarray(sq2_row)[0]),
        alpha_s=f(np.asarray(alpha_s)[:, :6]),
        y_mean=f(np.asarray(y_mean_row)[0, :6]),
        inv_ls=f(np.asarray(inv_ls_row)[:, :d]),
        scal=f(np.asarray(scal_row)[0, :3]),
        kinv=None if kinv is None else f(kinv),
        y_std=None if y_std_row is None else f(np.asarray(y_std_row)[0, :6]),
    )


def output_correction_config_from_fields(fields: Mapping) -> OutputCorrectionConfig:
    """``OutputCorrectionConfig`` from the JAX one's fields (a mapping such
    as ``dataclasses.asdict(cfg)``)."""
    return OutputCorrectionConfig(**{k: type(getattr(OutputCorrectionConfig, k))(v)
                                     for k, v in fields.items()})


def flight_resume_state_from_numpy(leaves, tick: int, meta, horizon: int, nu: int = 4,
                                   nx: int = 6, device=None) -> FlightResumeState:
    """A ``FlightResumeState`` from a JAX one's carry leaves in pytree order
    (``jax.tree_util.tree_leaves(rs.carry)``, or the ``leaf_i`` arrays of
    the JAX package's ``save_resume_state`` file): the padded state, aux,
    X_tail, slack and dual rows; the ring buffer's X, Y, head and count
    (one placeholder leaf for a frozen GP); the GP rows (six, eight with
    the variance operands, none without a GP). ``meta`` is the JAX
    fingerprint ``(horizon, K, capacity, variance, scaled)``."""
    dev = resolve_device(device)
    leaves = [np.asarray(a) for a in leaves]
    meta = tuple(int(v) for v in meta)
    carry = multitick_carry_from_numpy(*leaves[:5], horizon, nu, nx, device=dev)
    online = meta[2] > 0
    rest = leaves[5 + (4 if online else 1):]
    dataset = dataset_from_numpy(*leaves[5:9], device=dev) if online else None
    gp = gp_rows_from_numpy(*rest, n_features=nu + nx, device=dev) if rest else None
    return FlightResumeState(carry=(*carry, dataset, gp), tick=int(tick), meta=meta)


def multitick_carry_from_numpy(state_row, aux_row, xtail_row, z_row, y_row, horizon: int,
                               nu: int = 4, nx: int = 6, device=None):
    """The K5 carries ``(state (12,), aux (9,), xtail (Nnx,), z (m,),
    y (m,))`` from the JAX kernel's padded rows (aux lanes: previous x0 in
    0:6, integral in 8:11)."""
    dev = resolve_device(device)
    f = lambda a: _t(a, torch.float32, dev).contiguous()
    m = horizon * (nu + nx)
    aux = np.concatenate([np.asarray(aux_row)[0, 0:6], np.asarray(aux_row)[0, 8:11]])
    return (
        f(np.asarray(state_row)[0, :12]),
        f(aux),
        f(np.asarray(xtail_row)[0, : horizon * nx]),
        f(np.asarray(z_row)[0, :m]),
        f(np.asarray(y_row)[0, :m]),
    )


def structured_batch_data_from_numpy(padded: Mapping, horizon: int, nu: int = 4, nx: int = 6,
                                     device=None) -> StructuredBatchData:
    """``StructuredBatchData`` on ``device`` from the JAX package's padded
    one (a mapping such as ``jax_sdata._asdict()``), cut to semantic
    shapes."""
    dev = resolve_device(device)
    N = horizon
    Nnu, Nnx = N * nu, N * nx
    f = lambda a, rows, cols: _t(np.asarray(a)[:rows, :cols], torch.float32, dev).contiguous()
    v = lambda a, n: _t(np.asarray(a)[0, :n], torch.float32, dev).contiguous()
    return StructuredBatchData(
        SxT=f(padded["SxT"], nx, Nnx),
        SwT=f(padded["SwT"], Nnx, Nnx),
        SuTqT=f(padded["SuTqT"], Nnx, Nnu),
        SuT=f(padded["SuT"], Nnu, Nnx),
        SuRow=f(padded["SuRow"], Nnx, Nnu),
        MinvT=f(padded["MinvT"], Nnu, Nnu),
        u_lo=v(padded["u_lo"], Nnu), u_hi=v(padded["u_hi"], Nnu),
        x_lo=v(padded["x_lo"], Nnx), x_hi=v(padded["x_hi"], Nnx),
        horizon=N, nu=nu, nx=nx,
    )


def split_planes_from_numpy(ZU, ZX, YU, YX, horizon: int, nu: int = 4, nx: int = 6,
                            device=None):
    """K8's ``(ZU (B, Nnu), ZX (B, Nnx), YU (B, Nnu), YX (B, Nnx))`` from
    the JAX package's ``(B, n_pad)`` iterate planes."""
    dev = resolve_device(device)
    f = lambda a, n: _t(np.asarray(a)[:, :n], torch.float32, dev).contiguous()
    Nnu, Nnx = horizon * nu, horizon * nx
    return f(ZU, Nnu), f(ZX, Nnx), f(YU, Nnu), f(YX, Nnx)


def row_from_numpy(row, n: int, device=None) -> torch.Tensor:
    """The first ``n`` lanes of a JAX kernel's ``(1, pad)`` row (an operand
    or an output of K3, K4 or K6) as a float32 ``(n,)`` tensor."""
    return _t(np.asarray(row)[0, :n], torch.float32, resolve_device(device)).contiguous()


def rows_from_numpy(rows, n: int, device=None) -> torch.Tensor:
    """The first ``n`` lanes of a batched JAX kernel's ``(B, pad)`` rows
    (K16's X0, W, REF, Z0, Y0 and outputs) as a float32 ``(B, n)``
    tensor."""
    return _t(np.asarray(rows)[:, :n], torch.float32, resolve_device(device)).contiguous()


def square_from_numpy(mat, n: int, device=None) -> torch.Tensor:
    """The leading ``(n, n)`` block of a padded JAX operand (K16's
    ``ShiftT``) as a float32 tensor."""
    return _t(np.asarray(mat)[:n, :n], torch.float32, resolve_device(device)).contiguous()


def composite_admm_operands_from_numpy(P1_pad, GMinvT_pad, horizon: int, nu: int = 4,
                                       nx: int = 6, device=None):
    """K6's ``(P1 (m, m), GMinvT (n, m))`` from the JAX MPC's padded
    ``_P1_pad`` and ``_GMinvT_pad`` (``use_fused_admm``)."""
    dev = resolve_device(device)
    n, m = horizon * nu, horizon * (nu + nx)
    f = lambda a, rows, cols: _t(np.asarray(a)[:rows, :cols], torch.float32, dev).contiguous()
    return f(P1_pad, m, m), f(GMinvT_pad, n, m)


def noisy_carry_from_numpy(state_row, est_row, p_mat, aux_row, xtail_row, z_row, y_row,
                           horizon: int, n_est: int = 12, nu: int = 4, nx: int = 6, device=None):
    """The K9 carries ``(state (12,), est (n_est,), P (n_est, n_est),
    aux (13,), xtail (Nnx,), z (m,), y (m,))`` from the JAX noisy kernel's
    padded rows and its (128, 128) covariance (aux lanes there: estimate
    x0 in 0:6, integral in 8:11, applied control in 11:15)."""
    dev = resolve_device(device)
    f = lambda a: _t(a, torch.float32, dev).contiguous()
    m = horizon * (nu + nx)
    aux = np.asarray(aux_row)[0]
    return (
        f(np.asarray(state_row)[0, :12]),
        f(np.asarray(est_row)[0, :n_est]),
        f(np.asarray(p_mat)[:n_est, :n_est]),
        f(np.concatenate([aux[0:6], aux[8:11], aux[11:15]])),
        f(np.asarray(xtail_row)[0, : horizon * nx]),
        f(np.asarray(z_row)[0, :m]),
        f(np.asarray(y_row)[0, :m]),
    )


def plant_rows_from_numpy(rows, device=None) -> torch.Tensor:
    """``(R, 10)`` plant rows from the JAX package's ``(R, 16)`` ones (the
    10 plant lanes of its padded row)."""
    return _t(np.asarray(rows)[:, :10], torch.float32, resolve_device(device)).contiguous()


def rigid_params_from_numpy(fields: Mapping) -> RigidBodyParams:
    """``RigidBodyParams`` from the JAX parameter set's fields (a mapping
    such as ``{f: getattr(p, f) for f in ...}``; scalars or numpy values)."""
    kw = {k: float(np.asarray(v)) for k, v in fields.items() if k != "wind"}
    if "wind" in fields:
        kw["wind"] = tuple(float(v) for v in np.asarray(fields["wind"]).reshape(3))
    return RigidBodyParams(**kw)


def sqp_carry_from_numpy(slack, dual, X_prev, U_prev, dtype=torch.float32,
                         device=None) -> SQPCarry:
    """An ``SQPCarry`` from the JAX engine's carry arrays."""
    dev = resolve_device(device)
    f = lambda a: _t(a, dtype, dev)
    return SQPCarry(slack=f(slack), dual=f(dual), X_prev=f(X_prev), U_prev=f(U_prev))


def multitick_carry12_from_numpy(state, X_plan, U_plan, z, y, dtype=torch.float32,
                                 device=None) -> MultiTickCarry:
    """The 12-state multi-tick tier's ``MultiTickCarry`` from the JAX
    one's arrays."""
    dev = resolve_device(device)
    f = lambda a: _t(a, dtype, dev)
    return MultiTickCarry(state=f(state), X_plan=f(X_plan), U_plan=f(U_plan), z=f(z), y=f(y))


def rigid_tick_operands_from_numpy(sxct, sutqt, f0_row, gml, p1, d_row, e_row, ie_row, ce_row,
                                   ice_row, lo_row, hi_row, horizon: int, nu: int = 4,
                                   nx: int = 12, *, gs, device=None) -> RigidTickOperands:
    """K11's semantic operands from the JAX multi-tick kernel's padded
    layouts: ``sxct (16, pad)`` holds Sx' in rows 0:12 and Sc in row 12,
    ``sutqt (pad, pad)`` is SuT_q', ``gml (pad, pad)`` is GMinvT_s, ``p1
    (pad, pad)`` is P1, and every ``*_row`` is a ``(1, pad)`` row. ``gs (m,
    N nu)`` is the JAX relinearisation's equilibrated constraint matrix Gs
    (unpadded; the JAX kernel takes only P1 = Gs GMinvT_s), whose factors
    the port's kernel reads. Raises unless Gs's top ``N nu`` rows are
    diagonal and ``Gs @ GMinvT_s`` is P1 within float32 rounding: the
    kernel relies on both and the plain version on neither."""
    dev = resolve_device(device)
    N = horizon
    Nnu, Nnx, m = N * nu, N * nx, N * (nu + nx)
    f = lambda a: _t(np.ascontiguousarray(a), torch.float32, dev).contiguous()
    row = lambda r, n: f(np.asarray(r)[0, :n])
    sxct = np.asarray(sxct)
    gs = np.asarray(gs, np.float32)[:m, :Nnu].astype(np.float64)
    gml = np.asarray(gml, np.float32)[:Nnu, :m].astype(np.float64)
    p1 = np.asarray(p1, np.float32)[:m, :m]
    top = gs[:Nnu]
    if np.any(top != np.diag(np.diagonal(top))):
        raise ValueError("Gs's top N nu rows are not diagonal (G = [I; Su])")
    # a float32 product of N nu terms is within (N nu + 1) eps of |Gs| |GMinvT_s|
    slack = (Nnu + 1) * np.finfo(np.float32).eps * (np.abs(gs) @ np.abs(gml))
    if np.any(np.abs(gs @ gml - p1) > slack):
        raise ValueError("P1 is not Gs @ GMinvT_s within float32 rounding")
    return RigidTickOperands(
        Sx=f(sxct[0:nx, :Nnx].T), Sc=f(sxct[12, :Nnx]),
        SuT_q=f(np.asarray(sutqt)[:Nnx, :Nnu].T), f0=row(f0_row, Nnu),
        GMinvT_s=f(gml), Gs=f(gs), P1=f(p1),
        d=row(d_row, Nnu), e=row(e_row, m), ie=row(ie_row, m), ce=row(ce_row, m),
        ice=row(ice_row, m), lo=row(lo_row, m), hi=row(hi_row, m),
    )


def rigid_tick_carry_from_numpy(x_row, z_row, y_row, refs, horizon: int, nu: int = 4,
                                nx: int = 12, device=None):
    """K11's ``(x (12,), z (m,), y (m,), refs (K, N nx))`` from the JAX
    kernel's padded ``x_row (1, 16)``, slack and dual rows and ``(K, pad)``
    reference rows."""
    dev = resolve_device(device)
    m, Nnx = horizon * (nu + nx), horizon * nx
    f = lambda a: _t(np.ascontiguousarray(a), torch.float32, dev).contiguous()
    return (f(np.asarray(x_row)[0, :12]), f(np.asarray(z_row)[0, :m]),
            f(np.asarray(y_row)[0, :m]), f(np.asarray(refs)[:, :Nnx]))


def mppi_noise_from_numpy(eps, dtype=torch.float32, device=None) -> torch.Tensor:
    """The JAX MPPI tick's ``(K, N, 4)`` standard-normal exploration draw,
    for ``MPPIController.solve(..., eps=...)``."""
    return _t(eps, dtype, resolve_device(device)).contiguous()


def cascade_gains_from_numpy(leaves, device=None) -> CascadePidGains:
    """``CascadePidGains`` from the leaves of the JAX package's gain pytree
    (``jax.tree_util.tree_leaves`` order: position, velocity and attitude,
    each kp, ki, kd, max_output, max_integral; then hover_thrust,
    thrust_min, thrust_max, max_rate), as float32 tensors and floats."""
    dev = resolve_device(device)
    leaves = list(leaves)
    pid = lambda i: PIDGains(*(_t(leaves[i + j], torch.float32, dev) for j in range(5)))
    return CascadePidGains(pid(0), pid(5), pid(10), *(float(np.asarray(v)) for v in leaves[15:19]))


def mpc_theta_from_numpy(theta: Mapping, device=None) -> dict:
    """The tuner's log-weight dict (``tuning.mpc_weights_theta``) from the
    JAX package's, as float32 tensors."""
    dev = resolve_device(device)
    return {k: _t(v, torch.float32, dev) for k, v in theta.items()}


def rigid_conditions_from_numpy(body_fields: Mapping, x0, device=None):
    """A population's per-member true plants ``(bodies, x0)`` from the JAX
    package's ``sample_conditions`` (its batched ``RigidBodyParams`` fields
    as a mapping of ``(B,)`` arrays, the wind a tuple of three or ``(B,
    3)``; ``x0 (B, 12)``): ``bodies`` a ``RigidBodyParams`` whose every
    field is a ``(B,)`` float32 tensor on ``device`` (``monte_carlo_mpc12``'s
    ``conditions``)."""
    dev = resolve_device(device)
    f = lambda a: _t(np.asarray(a, np.float32), torch.float32, dev)
    body = {k: f(v) for k, v in body_fields.items() if k != "wind"}
    wind = body_fields["wind"]
    body["wind"] = tuple(f(w) for w in (wind if isinstance(wind, (tuple, list))
                                        else np.asarray(wind).T))
    return RigidBodyParams(**body), f(x0)


def monte_carlo_conditions_from_numpy(body_fields: Mapping, rate_fields: Mapping, x0,
                                      device=None):
    """A population's ``(bodies, rate_loops, x0)`` from the JAX package's
    ``sample_conditions`` (``rigid_conditions_from_numpy``'s bodies and
    start, and the batched ``RateLoopParams`` fields as a mapping of
    ``(B,)`` arrays), every field a float32 tensor on ``device``."""
    dev = resolve_device(device)
    bodies, x0 = rigid_conditions_from_numpy(body_fields, x0, dev)
    rates = {k: _t(np.asarray(v, np.float32), torch.float32, dev)
             for k, v in rate_fields.items()}
    return bodies, RateLoopParams(**rates), x0


def comparison_pid_params_from_fields(fields: Mapping) -> ComparisonPidParams:
    """``ComparisonPidParams`` from the JAX package's dataclass fields (a
    mapping of name to number)."""
    return ComparisonPidParams(**{k: float(np.asarray(v)) for k, v in fields.items()})


def gp_params_from_numpy(log_length_scale, log_signal_variance, log_noise_variance,
                         device=None) -> GPParams:
    """``GPParams`` from the JAX package's log-hyperparameter arrays, bit
    for bit (each keeps its own dtype; any leading batch axis stays)."""
    dev = resolve_device(device)
    return GPParams(_keep(log_length_scale, dev), _keep(log_signal_variance, dev),
                    _keep(log_noise_variance, dev))


def per_dim_gp_from_numpy(posteriors: Mapping, scaler_X: Mapping, scaler_Y: Mapping,
                          device=None) -> PerDimGP:
    """A ``PerDimGP`` from the JAX package's: ``posteriors`` maps each
    ``GPPosterior`` field (``params`` as the three ``log_*`` arrays) to its
    stacked array, one entry per output; the scalers map ``mean`` and
    ``std`` to arrays. Every array keeps its dtype."""
    dev = resolve_device(device)
    params = gp_params_from_numpy(posteriors["log_length_scale"],
                                  posteriors["log_signal_variance"],
                                  posteriors["log_noise_variance"], dev)
    fields = {k: (None if posteriors.get(k) is None else _keep(posteriors[k], dev))
              for k in GPPosterior._fields if k != "params"}
    scaler = lambda sc: Standardizer(_keep(sc["mean"], dev), _keep(sc["std"], dev))
    return PerDimGP(GPPosterior(params=params, **fields), scaler(scaler_X), scaler(scaler_Y))
