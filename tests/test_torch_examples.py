"""The port's examples (``examples_torch/01-15``), each run headless in a
subprocess on the CPU with ``UAV_FAST_EXAMPLES=1`` (sizes through
``utils.examples.scaled``) and ``UAV_EXAMPLES_DEVICE=cpu``; 01, 02 and 06
read the seeded CSVs written here (their first argument). Each must exit 0
and print something.

Six examples take 15-34 s each here on one thread (many staged or noisy
flights, or three LTV flights), and five more 7-9 s (02, 05, 09, 12, 13,
of which ~3 s is the start of the process); all eleven are marked ``slow``,
as all fifteen JAX examples are (``tests/test_examples.py``), and
``chip_smoke.py`` runs all fifteen on the card. 01, 03, 06 and 10 (the
data examples' reading of the CSVs, in-flight learning, the full-corpus GP
and the precision tiers) stay in the quick run.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu_torch.io import save_gp_dataset

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = sorted((REPO / "examples_torch").glob("[0-9]*.py"))
WITH_DATA = ("01", "02", "06")
SLOW = ("02", "04", "05", "07", "08", "09", "11", "12", "13", "14", "15")


def test_examples_discovered():
    assert len(EXAMPLES) == 15, EXAMPLES
    assert [p.name[:2] for p in EXAMPLES] == [f"{i:02d}" for i in range(1, 16)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("examples_corpus")
    rng = np.random.default_rng(5)
    for k in range(2):
        X = rng.normal(size=(150, 10))
        X[:, 2] += 3.0
        save_gp_dataset(str(d / f"flight_{k}.csv"), X,
                        0.05 * rng.normal(size=(150, 6)) + 0.02 * X[:, 3:9])
    return str(d / "*.csv")


def run_example(path, corpus, device="cpu"):
    env = dict(os.environ, UAV_FAST_EXAMPLES="1", MPLBACKEND="Agg", OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("UAV_EXAMPLES_DEVICE", None)
    if device is not None:
        env["UAV_EXAMPLES_DEVICE"] = device
    argv = [sys.executable, str(path)] + ([corpus] if path.name[:2] in WITH_DATA else [])
    return subprocess.run(argv, capture_output=True, text=True, timeout=600, env=env,
                          cwd=str(REPO))


@pytest.mark.parametrize(
    "path", [pytest.param(p, marks=pytest.mark.slow) if p.name[:2] in SLOW else p
             for p in EXAMPLES], ids=[p.name[:2] for p in EXAMPLES])
def test_example_runs_headless(path, corpus):
    res = run_example(path, corpus)
    assert res.returncode == 0, (f"{path.name} failed\n--- stdout ---\n{res.stdout[-2000:]}\n"
                                 f"--- stderr ---\n{res.stderr[-4000:]}")
    assert res.stdout.strip(), "example printed nothing"


def test_data_examples_refuse_an_empty_glob(tmp_path):
    res = run_example(EXAMPLES[0], str(tmp_path / "none" / "*.csv"))
    assert res.returncode != 0
    assert "no flight CSVs match" in res.stderr


def test_examples_default_to_cuda_and_refuse_without_it(corpus):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    res = run_example(EXAMPLES[4], corpus, device=None)
    assert res.returncode != 0 and "RuntimeError" in res.stderr
