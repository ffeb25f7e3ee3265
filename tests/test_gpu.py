"""Checks that need the card: the same functions ``chip_smoke.py`` runs
(mgf_tpu/checks.py), at the same sizes.  Whether a card exists is decided
inside the ``gpu_devices`` fixture, so every worker collects the same
tests; here on the CPU they skip."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu_devices():
    from mgf_tpu.utils.runtime import require_gpu
    try:
        return require_gpu()
    except RuntimeError as e:
        pytest.skip(str(e))


def test_gpu_oracle_contact_parity(gpu_devices):
    from mgf_tpu import checks
    worst, dvs, matmuls = checks.oracle_contact_parity()
    checks.check_oracle_bounds(worst)
    assert matmuls[1] == 0, matmuls
    assert np.median(dvs) <= 1e-3, dvs


@pytest.mark.parametrize("mixed,chunks,chunk", [(False, 8, 64),
                                                (True, 2, 16)])
def test_gpu_stress_scene(gpu_devices, mixed, chunks, chunk):
    from mgf_tpu import checks
    r = checks.stress_run(100_000, mixed=mixed, chunks=chunks, chunk=chunk)
    assert r["steps_per_s"] > 0 and r["recompiles"] == 0, r


def test_gpu_spatial_four_cards(gpu_devices):
    from mgf_tpu import checks
    if len(gpu_devices) < 4:
        pytest.skip(f"needs 4 GPUs, JAX sees {len(gpu_devices)}")
    checks.spatial_vs_single(n_devices=4)
