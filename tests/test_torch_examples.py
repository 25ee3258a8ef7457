"""The port's example twins (``repro_torch.examples``) on the CPU, at
smoke size: each runs with ``--device cpu`` and meets its own checks
(eigen_qr's eigenvalues within 5e-2 of numpy's, the Kalman filter
converging, the least-squares residual, the served tokens in the
vocabulary), and ``train_lm``'s fault-tolerance drill prints the
reference's sentinels (twin of
``tests/test_robustness.py::test_train_lm_fault_tolerance_drill``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.examples import (eigen_qr, kalman_filter, quickstart,
                                  serve_lm, train_lm)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs files in parallel worker
    processes, and these small per-token ops only thrash when each
    process spreads them over every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_quickstart_on_cpu(capsys):
    """Every registered method reconstructs and is orthogonal (asserted
    inside), the quarantine catches the poisoned request, lstsq solves,
    theta is the paper's ~0.75."""
    out = quickstart.main(["--device", "cpu"])
    assert {"tiled", "geqrf_ht", "tsqr", "geqr2_ht"} <= set(out)
    assert out["lstsq"] < 1e-3 and out["orthogonalize"] < 1e-4
    assert abs(out["theta"] - 0.749) < 0.02
    assert "quarantined:nonfinite_input" in capsys.readouterr().out


def test_eigen_qr_on_cpu():
    assert eigen_qr.main(["--device", "cpu"]) < 5e-2


def test_kalman_filter_on_cpu():
    first, last = kalman_filter.main(["--device", "cpu"])
    assert last < first


def test_serve_lm_on_cpu():
    out = serve_lm.main(["--device", "cpu", "--steps", "8"])
    assert tuple(out.shape) == (4, 8)


def test_train_lm_smoke_on_cpu(tmp_path):
    """Two QR-Muon steps of the smoke config through the batched
    orthogonalization, finite losses."""
    res = train_lm.main(["--device", "cpu", "--smoke", "--steps", "2",
                         "--seq", "16", "--batch", "2", "--batched-ortho",
                         "--checkpoint-dir", str(tmp_path / "ck")])
    assert res["final_step"] == 2
    assert np.isfinite([m["loss"] for m in res["history"]]).all()


_FT_ARGS = ["--device", "cpu", "--smoke", "--steps", "12", "--seq", "16",
            "--batch", "2", "--optimizer", "adamw", "--fault-tolerance",
            "--checkpoint-every", "4", "--crash-at", "6",
            "--inject-straggler-at", "11", "--watchdog-threshold", "2.0"]


def test_train_lm_fault_tolerance_drill(tmp_path):
    """The straggler at step 11 (after the restored run's five-step
    warm-up) and the crash at step 6: the reference's sentinels, from
    ``python -m repro_torch.examples.train_lm`` as a process."""
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.train_lm"] + _FT_ARGS
        + ["--checkpoint-dir", str(tmp_path / "ckpt")],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 OMP_NUM_THREADS="1"))
    out = res.stdout
    assert res.returncode == 0, res.stderr[-3000:]
    assert "CRASH_SIMULATED step=6" in out, res.stderr[-3000:]
    assert "[trainer] restored step 6" in out, out
    assert "[watchdog] straggler step 11" in out, out
    assert "STRAGGLERS=[11]" in out, out
    assert "FT_OK" in out, out
