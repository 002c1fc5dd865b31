"""The shared accelerator decisions (kwage.utils.runtime): the device
memory budget, the compile-cache location, and the refusal to run an
accelerator flag on a CPU that JAX fell back to."""

import os

import jax
import numpy as np
import pytest

from kwage.utils.runtime import (
    COMPILE_CACHE_DIR,
    CPU_BUDGET_BYTES,
    DEVICE_BUDGET_FRACTION,
    NoAcceleratorError,
    enable_compile_cache,
    fusion_budget_bytes,
    require_accelerator,
)


class FakeDevice:
    def __init__(self, platform, stats, kind="fake"):
        self.platform = platform
        self.device_kind = kind
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.fixture
def no_budget_env(monkeypatch):
    monkeypatch.delenv("KWAGE_FUSION_BUDGET_BYTES", raising=False)


def test_budget_is_a_share_of_free_device_memory(no_budget_env):
    dev = FakeDevice("gpu", {"bytes_limit": 60 << 30, "bytes_in_use": 20 << 30})
    assert fusion_budget_bytes(dev) == int((40 << 30) * DEVICE_BUDGET_FRACTION)


def test_budget_override_wins(monkeypatch):
    monkeypatch.setenv("KWAGE_FUSION_BUDGET_BYTES", "12345")
    dev = FakeDevice("gpu", {"bytes_limit": 60 << 30})
    assert fusion_budget_bytes(dev) == 12345


def test_budget_cpu_without_stats_uses_test_budget(no_budget_env):
    assert fusion_budget_bytes(FakeDevice("cpu", None)) == CPU_BUDGET_BYTES
    assert fusion_budget_bytes() == CPU_BUDGET_BYTES  # the real CPU backend


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 5}])
def test_budget_accelerator_without_limit_is_an_error(no_budget_env, stats):
    with pytest.raises(RuntimeError, match="bytes_limit"):
        fusion_budget_bytes(FakeDevice("gpu", stats, kind="NVIDIA H100"))


def test_compile_cache_honours_env(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    try:
        enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_fixed_path_in_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == COMPILE_CACHE_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert COMPILE_CACHE_DIR == os.path.join(repo, ".jax_cache")


@pytest.fixture
def implicit_cpu():
    """JAX on the CPU without anyone having asked for it."""
    before = jax.config.jax_platforms
    jax.config.update("jax_platforms", None)
    try:
        yield
    finally:
        jax.config.update("jax_platforms", before)


def test_require_accelerator_refuses_implicit_cpu(implicit_cpu):
    with pytest.raises(NoAcceleratorError, match="JAX_PLATFORMS=cpu"):
        require_accelerator("--device")


def test_require_accelerator_accepts_explicit_cpu():
    assert "cpu" in jax.config.jax_platforms
    require_accelerator("--device")


@pytest.fixture
def tiny_db(tmp_path):
    from kwage.core import FilterInfo
    from kwage.core.params import BloomParam
    from kwage.io.db_file import write_db_file

    rng = np.random.default_rng(0)
    param = BloomParam(kmer_len=11, log_2_filter_len=10, num_hash=2)
    slices = rng.integers(0, 256, size=(1 << 10, 1), dtype=np.uint8)
    path = tmp_path / "a.db"
    write_db_file(str(path), param, slices, [FilterInfo() for _ in range(8)])
    return str(path)


def _cli_cases(db, tmp_path):
    from kwage.cli.kwage import main as kwage_main
    from kwage.cli.maestro import main as maestro_main
    from kwage.cli.sriracha import main as sriracha_main

    q = "ACGTTGCAACGTAGGCTAGCATCG"
    return {
        "kwage --device": lambda: kwage_main(["-d", db, "--device", q]),
        "kwage --serve-engine device": lambda: kwage_main(["-d", db, "--serve", "0"]),
        "maestro --device-build": lambda: maestro_main(
            ["--meta", str(tmp_path / "inv.bin"), "--scratch", str(tmp_path / "s"),
             "--source-dir", str(tmp_path), "--device-build"]),
        "maestro --device-transpose": lambda: maestro_main(
            ["--meta", str(tmp_path / "inv.bin"), "--scratch", str(tmp_path / "s"),
             "--source-dir", str(tmp_path), "--device-transpose"]),
        "sriracha --device": lambda: sriracha_main(
            ["--device", "-i", str(tmp_path / "subj.fasta"), str(tmp_path / "r.fasta")]),
    }


@pytest.mark.parametrize("case", [
    "kwage --device", "kwage --serve-engine device", "maestro --device-build",
    "maestro --device-transpose", "sriracha --device",
])
def test_accelerator_flags_refuse_implicit_cpu(case, tiny_db, tmp_path, implicit_cpu, capsys):
    rc = _cli_cases(tiny_db, tmp_path)[case]()
    assert rc == 1
    assert "needs an accelerator" in capsys.readouterr().err


def test_kwage_device_runs_on_explicit_cpu(tiny_db, capsys):
    from kwage.cli.kwage import main as kwage_main

    q = "ACGTTGCAACGTAGGCTAGCATCG"
    assert kwage_main(["-d", tiny_db, "--device", q]) == 0
    dev = capsys.readouterr().out
    assert kwage_main(["-d", tiny_db, q]) == 0
    assert capsys.readouterr().out == dev


def test_runtime_imports_no_jax():
    """The helpers must be importable before JAX initializes (the CLIs
    decide platform questions through them)."""
    import subprocess
    import sys

    code = ("import sys; import kwage.utils.runtime; "
            "print('jax' in sys.modules)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=repo).stdout
    assert out.strip() == "False"
