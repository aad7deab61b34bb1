"""The port's static verification layer (``repro_torch.analysis``) against
the JAX package's (``repro.analysis``).

* lint: on every fixture of the JAX forms (``tests/test_analysis.py``'s,
  all three rules, pragmas included) both give the same (rule, line)
  list; the port's int32-cast rule also fires on torch's casts and in
  ``models/``, which the JAX tool misses, and stays silent on creations,
  reductions with ``dtype=`` and ``_build.expect`` checks;
* the lock checker and the bench schema check agree with the JAX ones on
  both source trees and on the repo's bench files (read only);
* faults planted in a copy of ``src/repro_torch`` are reported at their
  lines;
* the CLI: source analyzers touch no device, the self-check plans with
  the device planner on the CPU, ``--all`` reads only the port's bench
  files, and nothing of ``jax`` or ``repro`` is imported.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import bench_schema as jax_bench  # noqa: E402
from repro.analysis import concurrency as jax_locks  # noqa: E402
from repro.analysis import lint as jax_lint  # noqa: E402

from repro_torch.analysis import (check_bench_file,  # noqa: E402
                                  check_lock_discipline, lint_source,
                                  lint_tree)
from repro_torch.analysis import __main__ as cli  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
PORT = SRC / "repro_torch"
PRAGMA = "# lint-ok: unchecked-i32-cast"


def rule_lines(diags) -> list:
    return [(d.rule, d.line) for d in diags]


def run_cli(*argv, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *argv], cwd=str(cwd), env=env,
                          capture_output=True, text=True, timeout=300)


# -- lint: the JAX forms ------------------------------------------------------
# (source, path relative to the package): every snippet of
# tests/test_analysis.py's lint fixtures, and a few more of each rule.
JAX_FORMS = {
    "float32_literal_in_planner": (
        "import numpy as np\n"
        "def f(x):\n"
        "    return np.asarray(x, dtype=np.float32)\n", "core/geometry.py"),
    "float32_string_dtype": (
        "def f(x):\n    return x.astype('float32')\n", "core/slicer.py"),
    "float64_planner": (
        "import numpy as np\n"
        "def f(x):\n"
        "    return np.asarray(x, dtype=np.float64)\n", "core/hull.py"),
    "float32_outside_planner": (
        "import jax.numpy as jnp\n"
        "def f(x):\n"
        "    return x.astype(jnp.float32)\n", "models/layers.py"),
    "float32_pragma": (
        "import numpy as np\n"
        "X = np.float32  # lint-ok: planner-float32\n"
        "Y = np.float32\n", "core/hull.py"),
    "direct_boolean_mask": (
        "def load(cube, threshold):\n"
        "    field = cube.read_all()\n"
        "    return field[field > threshold]\n", "dataplane/foo.py"),
    "mask_variable": (
        "def load(cube, threshold):\n"
        "    field = cube.read_all()\n"
        "    mask = field > threshold\n"
        "    return field[mask]\n", "dataplane/foo.py"),
    "mask_pragma": (
        "def load(field, t):\n"
        "    return field[field > t]  # lint-ok: load-then-filter\n",
        "dataplane/foo.py"),
    "plan_first_dataplane": (
        "def load(cube, request, data):\n"
        "    plan, _ = cube.plan(request)\n"
        "    return data[plan.offsets]\n", "dataplane/foo.py"),
    "mask_outside_dataplane": (
        "def f(x):\n    return x[x > 0]\n", "benchmarks_helper.py"),
    "unguarded_astype": (
        "import numpy as np\n"
        "def f(offsets):\n"
        "    return offsets.astype(np.int32)\n", "core/foo.py"),
    "constructor_cast": (
        "import jax.numpy as jnp\n"
        "def f(off):\n"
        "    return jnp.int32(off)\n", "serve/foo.py"),
    "raw_cast_paged_attn": (
        "import jax.numpy as jnp\n"
        "def f(block_table):\n"
        "    return block_table.astype(jnp.int32)\n",
        "kernels/paged_attn/kernel.py"),
    "checked_cast_paged_attn": (
        "from repro.kernels._casting import checked_cast_i32\n"
        "def f(block_table, n_pages):\n"
        "    return checked_cast_i32(block_table,\n"
        "                            n_elements=n_pages,\n"
        "                            allow_negative_one=True)\n",
        "kernels/paged_attn/kernel.py"),
    "raw_cast_segment": (
        "import numpy as np\n"
        "def f(segment_ids):\n"
        "    return np.int32(segment_ids)\n", "kernels/segment/kernel.py"),
    "raw_cast_slice": (
        "import jax.numpy as jnp\n"
        "def f(plane_rows):\n"
        "    return plane_rows.astype(jnp.int32)\n", "kernels/slice/ref.py"),
    "raw_cast_plan": (
        "import jax.numpy as jnp\n"
        "def f(run_starts):\n"
        "    return jnp.int32(run_starts)\n", "kernels/plan/kernel.py"),
    "typed_arange_plan": (
        "import jax.numpy as jnp\n"
        "def f(ok, n0, n1):\n"
        "    rowoff = jnp.arange(0, n0 * n1, n1, dtype=jnp.int32)\n"
        "    return rowoff, jnp.cumsum(ok, dtype=jnp.int32)\n",
        "kernels/plan/ref.py"),
    "uncovered_kernel_dir": (
        "import jax.numpy as jnp\n"
        "def f(x):\n"
        "    return x.astype(jnp.int32)\n", "kernels/experimental/foo.py"),
    "helper_module": (
        "import numpy as np\n"
        "def checked_cast_i32(x):\n"
        "    return x.astype(np.int32)\n", "kernels/_casting.py"),
    "i32_pragma": (
        "import numpy as np\n"
        "def f(ids):\n"
        "    return ids.astype(np.int32)  # lint-ok: unchecked-i32-cast\n",
        "core/foo.py"),
    "bare_pragma": (
        "import numpy as np\n"
        "def f(ids):\n"
        "    a = ids.astype(np.int32)  # lint-ok\n"
        "    return a, ids.astype(np.int32)\n", "serve/foo.py"),
    "wrong_rule_pragma": (
        "import numpy as np\n"
        "def f(ids):\n"
        "    return ids.astype(np.int32)  # lint-ok: planner-float32\n",
        "core/foo.py"),
    "i64_cast": (
        "import numpy as np\n"
        "def f(offsets):\n"
        "    return offsets.astype(np.int64)\n", "core/foo.py"),
    "syntax_error": ("def f(:\n    pass\n", "core/foo.py"),
}


@pytest.mark.parametrize("name", sorted(JAX_FORMS))
def test_lint_agrees_with_jax_on_jax_forms(name):
    source, rel = JAX_FORMS[name]
    want = rule_lines(jax_lint.lint_source(source, rel))
    assert rule_lines(lint_source(source, rel)) == want


def test_jax_forms_cover_every_rule_and_silence():
    """The fixtures above fire each rule and also stay silent."""
    fired = set()
    silent = 0
    for source, rel in JAX_FORMS.values():
        diags = jax_lint.lint_source(source, rel)
        fired |= {d.rule for d in diags}
        silent += not diags
    assert fired == {"planner-float32", "load-then-filter",
                     "unchecked-i32-cast", "syntax"}
    assert silent >= 8


# -- lint: torch's forms ------------------------------------------------------
CASTS = {
    "to": "ids.to(torch.int32)",
    "to_dtype_kw": "ids.to(dtype=torch.int32)",
    "to_device_dtype": "ids.to(dev, torch.int32)",
    "to_device_kw_dtype": "ids.to(device=dev, dtype=torch.int32)",
    "type": "ids.type(torch.int32)",
    "int": "ids.int()",
    "as_tensor": "torch.as_tensor(ids, dtype=torch.int32)",
    "as_tensor_positional": "torch.as_tensor(ids, torch.int32)",
    "tensor": "torch.tensor(ids, dtype=torch.int32)",
    "asarray": "torch.asarray(ids, dtype=torch.int32)",
}
NOT_CASTS = {
    "zeros": "torch.zeros(n, dtype=torch.int32, device=dev)",
    "empty": "torch.empty((n, 2), dtype=torch.int32)",
    "full": "torch.full((n,), -1, dtype=torch.int32)",
    "arange": "torch.arange(0, n, 2, dtype=torch.int32, device=dev)",
    "sum": "(ids < n).sum(-1, dtype=torch.int32)",
    "cumsum": "torch.cumsum(ids, 0, dtype=torch.int32)",
    "expect": "_build.expect(ids, 'ids', device=dev, dtype=torch.int32, "
              "shape=(None,))",
    "to_int64": "ids.to(torch.int64)",
    "to_device": "ids.to(dev)",
    "long": "ids.long()",
    "int_of_a_value": "int(n)",
    "numpy_asarray": "np.asarray(ids, dtype=np.int32)",
}


def snippet(expr: str) -> str:
    return ("import numpy as np\n"
            "import torch\n"
            "def f(ids, n, dev):\n"
            f"    return {expr}\n")


@pytest.mark.parametrize("rel", ["core/foo.py", "serve/foo.py",
                                 "kernels/gather/ops.py", "models/recsys.py"])
@pytest.mark.parametrize("name", sorted(CASTS))
def test_torch_cast_fires_and_the_jax_tool_misses_it(name, rel):
    src = snippet(CASTS[name])
    assert rule_lines(lint_source(src, rel)) == [("unchecked-i32-cast", 4)]
    assert jax_lint.lint_source(src, rel) == []
    # the pragma, and the paths the rule leaves out, silence it
    lines = src.splitlines()
    lines[3] += f"  {PRAGMA}"
    assert lint_source("\n".join(lines), rel) == []
    for quiet in ("kernels/_casting.py", "dataplane/tokens.py",
                  "train/optimizer.py", "launch/train.py"):
        assert lint_source(src, quiet) == []


@pytest.mark.parametrize("name", sorted(NOT_CASTS))
def test_creations_reductions_and_checks_are_not_casts(name):
    assert lint_source(snippet(NOT_CASTS[name]), "core/foo.py") == []


def test_numpy_cast_in_models_fires_only_in_the_port():
    src = snippet("ids.astype(np.int32)")
    assert rule_lines(lint_source(src, "models/moe.py")) == [
        ("unchecked-i32-cast", 4)]
    assert jax_lint.lint_source(src, "models/moe.py") == []


def test_message_names_the_ports_helper():
    (d,) = lint_source(snippet("ids.int()"), "core/foo.py")
    assert "repro_torch.kernels.checked_cast_i32" in d.message


# -- the real trees -----------------------------------------------------------
def test_port_tree_is_clean():
    assert [str(d) for d in lint_tree(PORT)] == []
    assert [str(d) for d in check_lock_discipline(PORT)] == []


def test_without_pragmas_the_widened_rule_finds_the_two_safe_casts():
    """The port's only int32 casts under the rule's paths are the two
    pragma'd ones: the range-checked flat ids of EmbeddingBag and the
    bool-value promotion of the batched extract."""
    found = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT).as_posix()
        source = path.read_text()
        for d in lint_source(source.replace(PRAGMA, ""), rel):
            found.append((rel, source.splitlines()[d.line - 1].strip()))
    assert [(rel, line.split(PRAGMA)[0].strip()) for rel, line in found] \
        == [("kernels/slice/ref.py", "return values.to(torch.int32) if "
             "values.dtype == torch.bool else values"),
            ("models/recsys.py", "flat = torch.where(bags >= 0, "
             "bags.int() + base, -1)")]
    assert all(line.endswith(PRAGMA) for _, line in found)


@pytest.mark.parametrize("tree", ["repro", "repro_torch"])
def test_lock_checker_agrees_with_jax(tree):
    root = SRC / tree
    assert [str(d) for d in check_lock_discipline(root)] \
        == [str(d) for d in jax_locks.check_lock_discipline(root)]


# -- bench files --------------------------------------------------------------
@pytest.mark.parametrize("name", ["BENCH_extraction.json",
                                  "BENCH_serve.json", "BENCH_kernels.json",
                                  "BENCH_delta.json"])
def test_bench_check_agrees_with_jax_on_the_repo_files(name):
    path = REPO / name
    got = [str(d) for d in check_bench_file(path)]
    assert got == [str(d) for d in jax_bench.check_bench_file(path)]
    assert got == []


MALFORMED = {
    "invalid_json": "{not json",
    "no_tag": json.dumps({"rows": [{}]}),
    "not_an_object": json.dumps([1, 2]),
    "unknown_tag": json.dumps({"bench": "warp-drive", "rows": [{}]}),
    "empty_rows": json.dumps({"bench": "extraction", "rows": []}),
    "row_not_object": json.dumps({"bench": "serve", "rows": [3]}),
    "missing_key": json.dumps({"bench": "extraction", "rows": [
        {"example": "x", "polytope_bytes": 1}]}),
    "wrong_type": json.dumps({"bench": "delta", "rows": [
        {"scenario": "x", "requests": "many", "drift_steps": 1,
         "delta_hits": 1, "delta_hit_rate": 1.0, "cold_plan_ms": 1.0,
         "warm_plan_ms": 1.0, "speedup": 1.0}]}),
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_bench_check_agrees_with_jax_on_malformed_files(name, tmp_path):
    path = tmp_path / "BENCH_x.json"
    path.write_text(MALFORMED[name])
    got = [str(d) for d in check_bench_file(path)]
    assert got and got == [str(d) for d in jax_bench.check_bench_file(path)]
    assert [str(d) for d in check_bench_file(tmp_path / "absent.json")] \
        == [str(d) for d in jax_bench.check_bench_file(
            tmp_path / "absent.json")]


# -- planted faults -----------------------------------------------------------
def test_planted_faults_are_reported_at_their_lines(tmp_path):
    root = tmp_path / "repro_torch"
    shutil.copytree(PORT, root, ignore=shutil.ignore_patterns(
        "__pycache__", "csrc"))
    assert lint_tree(root) == []

    recsys = root / "models" / "recsys.py"
    lines = recsys.read_text().splitlines(keepends=True)
    (at,) = [i for i, line in enumerate(lines, 1) if "bags.int()" in line]
    lines[at - 1] = lines[at - 1].replace(f"  {PRAGMA}", "")
    recsys.write_text("".join(lines))

    core = root / "core" / "extractor.py"
    core_lines = core.read_text().splitlines()
    core.write_text("\n".join(core_lines) + "\n\n\ndef offsets_i32(plan):\n"
                    "    return torch.from_numpy(plan.offsets)"
                    ".to(torch.int32)\n")
    planted = len(core_lines) + 4

    want = [("core/extractor.py", planted), ("models/recsys.py", at)]
    assert [(d.file, d.line) for d in lint_tree(root)] == want
    assert all(d.rule == "unchecked-i32-cast" for d in lint_tree(root))
    # the JAX tool sees neither
    assert jax_lint.lint_tree(root) == []
    out = run_cli("--lint", "--root", str(root))
    assert out.returncode == 1
    for rel, line in want:
        assert f"{rel}:{line}: [unchecked-i32-cast]" in out.stderr


# -- the CLI ------------------------------------------------------------------
def test_cli_source_analyzers_are_clean_and_touch_no_device():
    out = run_cli("--lint", "--locks")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "all checks clean" in out.stdout
    assert "diagnostic" not in out.stdout + out.stderr


def test_cli_self_check_on_the_cpu():
    out = run_cli("--self-check", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "all checks clean" in out.stdout


def test_self_check_plans_through_the_device_planner(monkeypatch):
    from repro_torch.core import device_planner

    invoked = []
    invoke = device_planner.DevicePlanner._invoke

    def recording(self, *a, **kw):
        invoked.append(a)
        return invoke(self, *a, **kw)

    monkeypatch.setattr(device_planner.DevicePlanner, "_invoke", recording)
    assert cli.self_check("cpu") == []
    assert len(invoked) == 2        # box and triangle; span_all on the host


def test_self_check_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--self-check"])


def test_all_reads_only_the_ports_bench_files(tmp_path, monkeypatch,
                                              capsys):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "BENCH_extraction.json").write_text("{not json")
    assert cli.main(["--all", "--device", "cpu"]) == 0
    assert "all checks clean" in capsys.readouterr().out
    (tmp_path / "BENCH_torch_extraction.json").write_text("{not json")
    assert cli.main(["--all", "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "BENCH_torch_extraction.json" in err and "bench-schema" in err
    assert "BENCH_extraction.json:" not in err


def test_bench_and_plan_modes(tmp_path, capsys):
    bench = tmp_path / "b.json"
    bench.write_text(MALFORMED["missing_key"])
    assert cli.main(["--bench", str(bench)]) == 1
    assert "missing key" in capsys.readouterr().err
    assert cli.main([]) == 2


def test_no_jax_and_no_repro(tmp_path):
    """With ``jax`` blocked, the CLI runs the gate and every port example
    imports; afterwards no module of ``repro`` is loaded."""
    code = (
        "import importlib.util, sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch.analysis.__main__ as cli\n"
        "assert cli.main(['--all', '--device', 'cpu']) == 0\n"
        f"for path in sorted(__import__('pathlib').Path({str(REPO)!r})"
        ".joinpath('examples').glob('torch_*.py')):\n"
        "    spec = importlib.util.spec_from_file_location(path.stem, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "    print('imported', path.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('no repro')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("imported torch_") == 5
    assert "no repro" in out.stdout
