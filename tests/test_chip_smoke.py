"""chip_smoke.py rehearsed on the CPU: every phase at a tiny size, and
main() refusing to run without a GPU.  Also the compile-cache helper and
source audits that keep TPU-only code out of the tree."""

import os
import re

import jax
import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_refuses_cpu(capsys):
    rc = cs.main([])
    assert rc != 0
    assert '"ok"' not in capsys.readouterr().out


def test_script_view_reads_reference_log_as_script():
    """The lock-mode-max end-of-transmission pair and the two forms of a
    CTCSS hand-over reduce to the script's events."""
    log = ["Tuned to channel 14 (RSSI: 40.92dB)",
           "Acquired CTCSS code: 20 (frequency: 131.80Hz)",
           "Changed active channel from 14 to 6", "Lost CTCSS code",
           "Acquired CTCSS code: 33 (frequency: 210.70Hz)",
           "Changed active channel from 6 to 2", "Detuned from channel 2"]
    script = [(0, 10, 14, 20, 0.3), (5, 10, 6, 33, 1.0)]
    assert cs.script_view(log) == cs.expected_events(script)
    log[3:5] = ["CTCSS code change: 33 (frequency: 210.70Hz)"]
    assert cs.script_view(log) == cs.expected_events(script)


@pytest.mark.parametrize("phase,kw", [
    ("scanner", dict(n_sub=120, k=10, k_rt=1, n_prefix=40, n_oracle=20)),
    ("waterfall", dict(n_sub=20, k=10, rows=5)),
    ("dsd", dict(n_sub=20, k=10)),
    ("single", dict(n_sub=20, k=10)),
    ("record", dict(n_sub=24, k=4)),
    ("batch", dict(n_caps=2, n_sub=20, k=10)),
    ("four_gpus", dict(n_caps=4, n_sub=8, k=4)),
])
def test_phase_passes_at_tiny_size(phase, kw, tmp_path):
    getattr(cs, f"phase_{phase}")(work=str(tmp_path), **kw)


def test_native_phase_builds_host_engine():
    cs.phase_native()


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    from sdr_pmr446_tpu.utils import compile_cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    from sdr_pmr446_tpu.utils import compile_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_cache/" in open(os.path.join(ROOT, ".gitignore")).read()


def _sources():
    """The program's Python files: the package, tools, tests and the
    top-level scripts."""
    for f in os.listdir(ROOT):
        if f.endswith(".py"):
            yield os.path.join(ROOT, f)
    for top in ("sdr_pmr446_tpu", "tools", "tests"):
        for d, _, files in os.walk(os.path.join(ROOT, top)):
            for f in files:
                if f.endswith(".py"):
                    yield os.path.join(d, f)


@pytest.mark.parametrize("pattern", [
    r"pallas\.tpu|pl[t]pu|interpret\s*=",
    r"""default_backend\(\)\s*[!=]=|[!=]=\s*["']tpu["']""",
])
def test_no_tpu_only_code(pattern):
    """No module imports the Pallas TPU dialect, runs kernels in interpret
    mode, or branches on the backend being a TPU."""
    rx = re.compile(pattern)
    hits = [f"{os.path.relpath(p, ROOT)}:{i}"
            for p in _sources() if os.path.abspath(p) != __file__
            for i, line in enumerate(open(p, encoding="utf-8"), 1)
            if rx.search(line)]
    assert not hits, hits
