"""The port's five examples (``examples/torch_*.py``) on the CPU.

``torch_quickstart`` and ``torch_extract_weather`` print what the JAX
scripts print, timings aside: the JAX scripts run as subprocesses in
``tmp_path`` (``extract_weather.py`` writes its bench file there, never
into the repo), the port's in process with ``--device cpu``; their
bench files agree but for the plan time.  ``torch_serve_lm``,
``torch_train_lm`` and ``torch_train_recsys`` run at small sizes with
the checks ``chip_smoke.py``'s examples phase makes on the card: every
request served and the pages reclaimed; one restart restored from a
checkpoint and the loss falling.  Without ``--device`` an example
needs the card.  The file takes ~35 s alone.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import check_bench_file  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
TIMING = re.compile(r"\d[\d,]*\.\d+ ?(ms|s\b|tok/s)")


def example(name: str):
    """The example module ``examples/<name>.py``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_jax(script: str, cwd: Path) -> str:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(EXAMPLES / script)],
                         cwd=str(cwd), env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def untimed(text: str) -> list:
    """The printed lines with every timing masked and the bench file's
    name left out."""
    return [TIMING.sub("<t>", line) for line in text.splitlines()
            if not line.startswith("wrote ")]


def test_quickstart_prints_what_the_jax_script_prints(tmp_path, capsys,
                                                      monkeypatch):
    want = run_jax("quickstart.py", tmp_path)
    monkeypatch.chdir(tmp_path)
    got = example("torch_quickstart").main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert untimed(printed) == untimed(want)
    assert len(got["rows"]) == 4 and got["device"] == "cpu"
    # the France line: points, runs and the mean of the values read
    assert (f"France: {got['france']['n_points']} points in "
            f"{got['france']['n_runs']} contiguous runs") in want
    assert list(tmp_path.iterdir()) == []


def test_extract_weather_matches_the_jax_script(tmp_path, capsys,
                                                monkeypatch):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    want = run_jax("extract_weather.py", jax_dir)
    monkeypatch.chdir(port_dir)
    got = example("torch_extract_weather").main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert untimed(printed) == untimed(want)
    # The port writes its own bench file, never BENCH_extraction.json.
    assert sorted(p.name for p in port_dir.iterdir()) == [
        "BENCH_torch_extraction.json"]
    ours = port_dir / "BENCH_torch_extraction.json"
    assert check_bench_file(ours) == []
    theirs = json.loads((jax_dir / "BENCH_extraction.json").read_text())
    ours = json.loads(ours.read_text())
    for rows in (theirs["rows"], ours["rows"]):
        for row in rows:
            assert row.pop("plan_time_s") >= 0.0
    assert ours == theirs
    assert ours["seam_shift_cache_hit"] is True
    assert got["irregular"]["seam_shift_cache_hit"] is True


def test_extract_weather_writes_where_it_is_told(tmp_path, capsys):
    out = tmp_path / "elsewhere.json"
    got = example("torch_extract_weather").main(["--device", "cpu",
                                                 "--out", str(out)])
    assert got["out"] == str(out) and check_bench_file(out) == []
    assert f"wrote {out}" in capsys.readouterr().out


def test_serve_lm_serves_every_request_and_drains(capsys):
    got = example("torch_serve_lm").main(["--device", "cpu"])
    assert got["requests"] == 10 and got["new_tokens"] == 120
    assert all(len(out) == 12 for _, out in got["outputs"])
    assert got["utilization"] == 0
    assert "page-pool utilization after drain: 0%" in capsys.readouterr().out


def test_train_lm_restarts_from_a_checkpoint_and_learns(tmp_path,
                                                        monkeypatch):
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    ckpt = tmp_path / "ckpt"
    got = example("torch_train_lm").main([
        "--device", "cpu", "--preset", "small", "--steps", "60",
        "--preempt-at", "55", "--batch", "2", "--seq", "64",
        "--ckpt-dir", str(ckpt)])
    assert got["restarts"] == 1
    # steps 0-54, then 50-59 again from the checkpoint of step 49
    assert len(got["losses"]) == 55 + 10
    assert got["final_loss"] < got["first_loss"]
    assert list(cwd.iterdir()) == [] and any(ckpt.iterdir())


def test_train_recsys_learns(tmp_path, monkeypatch):
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    ckpt = tmp_path / "ckpt"
    got = example("torch_train_recsys").main([
        "--device", "cpu", "--steps", "60", "--batch", "512",
        "--ckpt-dir", str(ckpt)])
    assert got["restarts"] == 0 and len(got["losses"]) == 60
    assert got["final_loss"] < got["first_loss"]
    assert list(cwd.iterdir()) == [] and any(ckpt.iterdir())


def test_an_example_needs_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable,
                          str(EXAMPLES / "torch_serve_lm.py")],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert list(tmp_path.iterdir()) == []
