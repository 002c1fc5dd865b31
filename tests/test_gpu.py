"""The device paths on an NVIDIA GPU, at small sizes, against the host.

Every test takes the ``gpu`` fixture, which skips it where JAX has no
GPU. On a machine with a card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import numpy as np
import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu

SPEC = dict(kmer_len=31, num_hash=5, num_filter=256, log2_filter_len=18, num_files=2)


def test_fusion_budget_from_device_memory(gpu):
    from kwage.utils.runtime import fusion_budget_bytes

    limit = gpu.memory_stats()["bytes_limit"]
    assert 0 < fusion_budget_bytes(gpu) <= limit


def test_search_device_equals_host(gpu, tmp_path):
    result = cs.phase_search(str(tmp_path), SPEC, 16, (100, 2000), seed=3)
    assert result["queries_hit"] == {"1.0": 8, "0.5": 12}
    cs.phase_serve(result, time_kernels=False)


def test_build_device_equals_host(gpu, tmp_path):
    assert cs.phase_build(str(tmp_path), 8, 30_000, seed=3)["sha256_identical"]


def test_sriracha_device_equals_host(gpu, tmp_path):
    cs.phase_sriracha(str(tmp_path), 5000, 150, 3, {21: (4, 1000), 11: (32, 2500)},
                      {21: "hash", 11: "table"})


def test_transpose_and_pack_on_device(gpu):
    out = cs.phase_kernels(num_filter=256, log2_bits=16, log2_image=18, batch=4)
    assert out["transpose"]["device_ms"] > 0
    assert np.isfinite(out["set_filter_bits_multi"]["ms"])
