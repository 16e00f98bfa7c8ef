"""Port parity for the IO readers against the JAX package on the CPU: the
native CSV parser and its NumPy fallback, the flight datasets, the
streaming ``uavlog`` recorder (native and NumPy), the npz flight logs and
their analysis.

Files are written by the tests (the reference's datasets are not used).
The port builds its C++ readers from its own ``native/`` sources into its
git-ignored ``_build/native/``; the JAX package's ``native/`` directory
must not change while the port builds and runs them. Tolerances: parsed
and recorded values equal bit for bit, the uavlog files byte for byte;
the tracking metrics within 1e-6 relative (float32 logs, the two packages'
reductions in other orders).
"""

import os
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.io import (
    UavLogWriter as JWriter,
    analyze_flight_log as j_analyze,
    load_flight_log as j_load_log,
    load_gp_dataset as j_load_dataset,
    load_gp_datasets as j_load_datasets,
    load_numeric_csv as j_load_csv,
    read_uavlog as j_read_uavlog,
    save_flight_log as j_save_log,
    write_uavlog as j_write_uavlog,
)
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.io import (
    CSV_HEADER,
    UavLogWriter,
    analyze_flight_log,
    load_flight_log,
    load_gp_dataset,
    load_gp_datasets,
    load_numeric_csv,
    native_available,
    read_uavlog,
    save_flight_log,
    save_gp_dataset,
    write_uavlog,
)
from unmanned_aerial_vehicles_tpu_torch.io import fast_csv, uavlog
from unmanned_aerial_vehicles_tpu_torch.loop import mpc_flight_rollout
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
JAX_NATIVE = REPO / "unmanned_aerial_vehicles_tpu" / "native"


def _write_csv(path, rows, header=CSV_HEADER):
    with open(path, "w") as f:
        f.write(header + "\n")
        for r in rows:
            f.write(",".join(repr(float(v)) for v in r) + "\n")


def _dataset_rows(rng, n=40):
    rows = rng.normal(size=(n, 16)) * np.concatenate([np.logspace(-3, 2, 10), np.full(6, 0.3)])
    rows[3, 12] = np.nan          # non-finite: dropped
    rows[7, 10:] = 3.0            # residual norm 7.3 >= 5: dropped
    return rows


@pytest.fixture(scope="module")
def rollout():
    """A short flight of the port (float32 tensors) and its numpy copy."""
    mpc = LinearMPC(LinearMPCConfig(horizon=5, admm_iterations=10), device="cpu")

    def ref(t):
        pos, yaw = ramped_figure8_reference(t, 2.0, 0.05)
        return pos + torch.tensor([0.0, 0.0, 3.0], dtype=pos.dtype), yaw

    outs = mpc_flight_rollout(mpc, ref, 12, device="cpu")
    return outs, {k: v.numpy() for k, v in outs.items()}


@pytest.fixture
def numpy_only(monkeypatch):
    """The port's readers with their native libraries switched off."""
    monkeypatch.setattr(fast_csv, "_get_lib", lambda: None)
    monkeypatch.setattr(uavlog, "_get_lib", lambda: None)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_csv_parser_matches_jax(tmp_path, rng, route, request):
    if route == "numpy":
        request.getfixturevalue("numpy_only")
    else:
        assert native_available()
    path = str(tmp_path / "data.csv")
    rows = _dataset_rows(rng)
    _write_csv(path, rows)
    got = load_numeric_csv(path, 16)
    want = j_load_csv(path, 16)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (40, 16) and got.dtype == np.float64


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_dataset_round_trip_and_filters_match_jax(tmp_path, rng, route, request):
    if route == "numpy":
        request.getfixturevalue("numpy_only")
    path = str(tmp_path / "flights" / "flight.csv")
    rows = _dataset_rows(rng)
    save_gp_dataset(path, rows[:, :10], rows[:, 10:])
    X, Y = load_gp_dataset(path)
    jX, jY = j_load_dataset(path)
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(Y, jY)
    assert X.shape == (38, 10)
    # a second file, a file of another schema (skipped with a warning), even down-sampling
    other = str(tmp_path / "flights" / "flight_metrics.csv")
    _write_csv(other, rng.normal(size=(5, 3)), header="a,b,c")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        X2, Y2 = load_gp_datasets([path, other, path], max_samples=50, dtype=np.float32)
    assert any("skipping" in str(w.message) for w in caught)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jX2, jY2 = j_load_datasets([path, other, path], max_samples=50, dtype=np.float32)
    np.testing.assert_array_equal(X2, jX2)
    np.testing.assert_array_equal(Y2, jY2)
    assert X2.shape == (50, 10) and X2.dtype == np.float32


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_uavlog_bytes_equal_jax_and_torn_frame_dropped(tmp_path, rollout, route, request):
    if route == "numpy":
        request.getfixturevalue("numpy_only")
    outs, outs_np = rollout
    mine, theirs = str(tmp_path / "port.uavlog"), str(tmp_path / "jax.uavlog")
    frames = write_uavlog(mine, outs)          # tensors in
    assert frames == j_write_uavlog(theirs, outs_np) == outs["state"].shape[0]
    assert Path(mine).read_bytes() == Path(theirs).read_bytes()
    with open(mine, "ab") as f:                # a torn final frame
        f.write(b"\x00" * 10)
    got, want = read_uavlog(mine), j_read_uavlog(mine)
    assert set(got) == set(want) and "final_state" not in got
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].shape[0] == frames


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_streaming_writer_matches_jax(tmp_path, rng, route, request):
    if route == "numpy":
        request.getfixturevalue("numpy_only")
    channels = {"pos": 3, "thrust": 1, "u": 4}
    blocks = [{"pos": rng.normal(size=3), "thrust": 0.5, "u": rng.normal(size=4)},
              {"pos": rng.normal(size=(5, 3)), "thrust": rng.normal(size=5),
               "u": torch.tensor(rng.normal(size=(5, 4)))}]
    paths = str(tmp_path / "a.uavlog"), str(tmp_path / "b.uavlog")
    with UavLogWriter(paths[0], channels) as w, JWriter(paths[1], channels) as jw:
        for block in blocks:
            jblock = {k: np.asarray(v) for k, v in block.items()}
            assert w.append(block) == jw.append(jblock)
    assert Path(paths[0]).read_bytes() == Path(paths[1]).read_bytes()
    with pytest.raises(ValueError, match="bad channel"):
        UavLogWriter(str(tmp_path / "c.uavlog"), {"a:b": 1})


def test_npz_flight_logs_cross_load_and_analysis_matches_jax(tmp_path, rollout):
    outs, outs_np = rollout
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    save_flight_log(mine, outs, seed=3)
    j_save_log(theirs, outs_np, seed=3)
    for path in (mine, theirs):
        got, want = load_flight_log(path), j_load_log(path)
        assert set(got) == set(want) and int(got["meta_seed"]) == 3
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    log = dict(load_flight_log(mine), thrust=np.linspace(0.05, 1.02, outs_np["state"].shape[0]))
    got, want = analyze_flight_log(log), j_analyze(log)
    assert set(got) == set(want) and {"rms_pos", "max_pos", "mean_thrust_sat_pct"} <= set(got)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9, err_msg=k)
    uav = str(tmp_path / "log.uavlog")
    save_flight_log(uav, outs)
    assert analyze_flight_log(load_flight_log(uav))["rms_pos"] == pytest.approx(
        got["rms_pos"], rel=1e-6)


def test_native_readers_build_into_the_port_and_leave_the_jax_native_alone(tmp_path, rng):
    path = str(tmp_path / "x.csv")
    _write_csv(path, _dataset_rows(rng))
    j_load_csv(path, 16)                      # the JAX package's own build, if any, first
    j_write_uavlog(str(tmp_path / "j.uavlog"), {"state": np.zeros((3, 12), np.float32)})
    before = {p.name: p.stat().st_mtime_ns for p in JAX_NATIVE.iterdir()}
    for source, library in (("csv_loader.cpp", "libuavcsv.so"), ("uavlog.cpp", "libuavlog.so")):
        built = fast_csv.build_native(source, library)
        assert built.parent.parent == fast_csv.NATIVE_BUILD and built.exists()
        assert str(built).startswith(str(REPO / "unmanned_aerial_vehicles_tpu_torch" / "_build"))
    assert native_available() and uavlog.native_available()
    for lib in (fast_csv._get_lib(), uavlog._get_lib()):
        assert Path(lib._name).parent.parent == fast_csv.NATIVE_BUILD
    load_numeric_csv(path, 16)
    write_uavlog(str(tmp_path / "p.uavlog"), {"state": torch.zeros(3, 12)})
    assert {p.name: p.stat().st_mtime_ns for p in JAX_NATIVE.iterdir()} == before
    assert not os.path.exists(fast_csv.NATIVE_SRC / "libuavcsv.so")
