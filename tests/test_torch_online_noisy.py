"""Port parity for the noisy flights against the JAX package on the CPU,
continued from ``test_torch_noisy_flight.py`` (whose helpers fly both
packages on the JAX package's own sensor draws): the single-tick tier (K4
on the estimate, the staged filter between launches), and the online-noisy
flight on the multi-tick tier, which learns from the estimates (ROADMAP
F2: each launch's last transition waits for the next launch's first
estimate).

Tolerances: position gap <= 1e-4 m over 48 ticks; the ring buffer's count
identical at every tick, its contents equal to those captured from the JAX
flight's estimates within 1e-5.
"""

import numpy as np
import pytest
import torch

from test_torch_noisy_flight import K, T, fly_both, posterior_pair
from unmanned_aerial_vehicles_tpu.gp.residual_gp import (
    ResidualGPConfig as JGPCfg,
    build_horizon_residuals as j_residuals,
)
from unmanned_aerial_vehicles_tpu.loop import OnlineFusedGPConfig as JOnline
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import (
    ResidualGPConfig,
    add_training_samples_batch,
    build_horizon_residuals,
    empty_dataset,
)
from unmanned_aerial_vehicles_tpu_torch.loop import OnlineFusedGPConfig, closed_loop

torch.set_num_threads(1)

RING = 32


def test_single_tick_noisy_flight_matches_jax():
    jpost, post = posterior_pair()
    got, want = fly_both(
        dict(use_fused_tick=True),
        dict(residual_fn=lambda X, U: j_residuals(jpost, X, U, JGPCfg(residual_gain=1.0))),
        dict(residual_fn=lambda X, U: build_horizon_residuals(
            post, X, U, ResidualGPConfig(residual_gain=1.0))),
    )
    for key in ("u_mpc", "accel_cmd", "thrust"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-4,
                                   err_msg=key)


@pytest.fixture(scope="module")
def online_noisy():
    """The online-noisy flight in both packages, with the port's ring-buffer
    captures and its final data set recorded."""
    captured = []
    original = closed_loop._OnlineGP.capture

    def recording(self, states, controls, states_next, launch, k):
        captured.append((states.clone(), controls.clone(), states_next.clone()))
        original(self, states, controls, states_next, launch, k)
        captured_sets["last"] = self.dataset

    captured_sets = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(closed_loop._OnlineGP, "capture", recording)
    # bench.py's gain 0.1: at gain 1 the refitted GP amplifies float32
    # rounding so that the two packages' estimates part by ~1e-5 in 48 ticks
    try:
        got, want = fly_both(
            dict(use_fused_tick=True, ticks_per_dispatch=K),
            dict(online_gp=JOnline(gp=JGPCfg(max_data_points=RING, residual_gain=1.0),
                                   refit_every=16, min_samples=4), gp_gain=0.1),
            dict(online_gp=OnlineFusedGPConfig(
                gp=ResidualGPConfig(max_data_points=RING, residual_gain=1.0), refit_every=16,
                min_samples=4), gp_gain=0.1),
        )
    finally:
        mp.undo()
    return got, want, captured, captured_sets["last"]


def test_online_noisy_flight_matches_jax(online_noisy):
    got, want, _, dataset = online_noisy
    np.testing.assert_array_equal(got["gp_count"].numpy(), np.asarray(want["gp_count"]))
    assert int(got["gp_count"][-1]) > 4          # the refits had data to fit
    # the ring from the JAX flight's estimates and applied commands, with
    # the same deferral: launch i's last transition completes at launch i+1
    est = torch.from_numpy(np.array(want["state_est"]))
    controls = torch.cat([torch.from_numpy(np.array(want["accel_cmd"])),
                          torch.clamp(torch.from_numpy(np.array(want["u_mpc"]))[:, 3:4],
                                      -0.8, 0.8)], dim=1)
    gcfg = ResidualGPConfig(max_data_points=RING, residual_gain=1.0)
    ring = empty_dataset(RING, torch.float32, "cpu")
    for i in range(T // K):
        lo = max(i * K - 1, 0)
        ring = add_training_samples_batch(ring, est[lo:(i + 1) * K - 1],
                                          controls[lo:(i + 1) * K - 1],
                                          est[lo + 1:(i + 1) * K], gcfg)
    assert int(ring.count) == int(dataset.count)
    np.testing.assert_allclose(dataset.X.numpy(), ring.X.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dataset.Y.numpy(), ring.Y.numpy(), rtol=0, atol=1e-5)


def test_online_noisy_ring_holds_no_self_transitions(online_noisy):
    """Each launch's last estimate is formed only by the next launch's first
    predict + fuse, so that sample is deferred: launch 0 captures K-1
    transitions, every later launch K, the first of them completing the
    previous launch's last tick; no captured transition maps an estimate to
    itself."""
    got, _, captured, _ = online_noisy
    est = got["state_est"]
    assert len(captured) == T // K
    for i, (pre, ctl, nxt) in enumerate(captured):
        assert pre.shape[0] == (K - 1 if i == 0 else K)
        first = i * K - 1 if i else 0
        assert torch.equal(pre, est[first:(i + 1) * K - 1])
        assert torch.equal(nxt, est[first + 1:(i + 1) * K])
        assert torch.all((nxt - pre).abs().amax(dim=1) > 0)
        if i:
            # the deferred sample: the previous launch's last estimate and
            # command, completed by this launch's first estimate
            assert torch.equal(pre[0], captured[i - 1][2][-1])
            assert torch.equal(ctl[0], got["accel_cmd"].new_tensor(
                torch.cat([got["accel_cmd"][i * K - 1],
                           torch.clamp(got["u_mpc"][i * K - 1, 3:4], -0.8, 0.8)]).tolist()))
