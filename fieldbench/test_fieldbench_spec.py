"""CPU tests of ``BENCHMARK.json`` and the files it names."""
import ast
import json
import re
import shutil
from pathlib import Path


from fieldbench import harness
from fieldbench.yardstick import peaks, stencil

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "fieldbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_keys_names_units_and_lines():
    assert set(SPEC) == KEYS["top"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            extra = set(entry) - KEYS[group]
            assert extra <= ({"workloads"} if group in ("end_to_end", "per_layer")
                             else set()), (group, extra)
            assert KEYS[group] <= set(entry), (group, entry)
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            for key in ("why", "layer", "source"):
                if key in entry and group in ("configs", "workloads", "per_layer"):
                    assert line(entry[key]), (key, entry[key])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(line(w) and not w.startswith("/") and ".." not in w
               for w in SPEC["command"])
    assert all(PATH.match(p) for p in SPEC["paths"])


def test_metrics_cover_every_cell_and_bounds_are_in_range():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        reported = [n for n, m in e2e.items() if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2, cell
        assert any(cell in m["workloads"] for m in SPEC["per_layer"]), cell
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(line(k) for k in layers)


def test_run_seconds_fits_the_full_check():
    r = SPEC["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= 1


def test_every_cell_file_is_found_by_name():
    for cell in SPEC["workloads"]:
        files = harness.cell_files(SPEC, cell)
        for f in files.values():
            assert f.is_file(), f
            assert f.is_relative_to(HERE)
        cfg = json.loads(files["config"].read_text())
        entry = next(c for c in SPEC["configs"] if c["name"] == cell["config"])
        assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
        assert cfg["source"] == entry["source"]
    for m in SPEC["per_layer"]:
        assert harness.metric_file(m["name"]).is_file(), m["name"]
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))


def test_no_data_file_is_named_like_the_ignored_bench_outputs():
    # the repository's .gitignore drops bench*.json at every depth
    assert not [p for p in HERE.rglob("bench*.json")]
    for p in HERE.rglob("*"):
        if p.is_file() and "build" not in p.parts and "__pycache__" not in p.parts:
            rel = p.relative_to(HERE).as_posix()
            assert PATH.match(rel), rel


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_no_source_imports_jax_or_the_jax_package():
    for p in HERE.rglob("*.py"):
        tops = set(_imports(p))
        assert not tops & set(harness.FORBIDDEN), (p, tops)


def test_references_import_nothing_of_the_program():
    for p in (HERE / "configs").glob("*.py"):
        tops = set(_imports(p))
        assert tops <= {"__future__", "math", "torch"}, (p, tops)


def test_yardstick_matches_the_kernel_table():
    # PERF.md's kernel table: K1 269.5 MB, K3 and K4 151.4 MB at
    # 512x512x128 float32; Fig. 3's body 8 operations a cell
    grid = (512, 512, 128)
    assert round(stencil.apply_bytes(grid, "float32") / 1e6, 1) == 269.5
    assert round(stencil.transfer_bytes(grid, "float32") / 1e6, 1) == 151.4
    assert stencil.coarse_shape(grid) == (257, 257, 65)
    ref = harness.load_module(HERE / "configs" / "heat3d.py", "t_heat3d_ref")
    cfg = json.loads((HERE / "configs" / "heat3d.json").read_text())
    b = ref.bodies(cfg)
    assert stencil.body_ops(b["ftcs"]) == 8
    assert stencil.body_ops(b["btcs_operator"]) == 7
    assert stencil.body_ops(b["btcs_rhs"]) == 1
    # 0.0804 ms: the bound PERF.md gives K1 at k = 1
    t = peaks.least_seconds(stencil.apply_flops(grid, b["ftcs"]),
                            stencil.apply_bytes(grid, "float32"), "float32")
    assert round(t * 1e3, 4) == 0.0804


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    """A later PR adds a cell and a per-layer metric by adding files and
    entries: the harness finds and runs them without an edit."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(HERE, root / "fieldbench",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = json.loads((HERE / "workloads" / "heat3d-make.json").read_text())
    wl["steps_per_call"] = 30
    (root / "fieldbench" / "workloads" / "heat3d-make-short.json").write_text(
        json.dumps(wl))
    spec["workloads"].append({"name": "heat3d-make-short", "config": "heat3d",
                              "traffic": "heat3d-make-short", "chips": 1,
                              "why": "a test cell"})
    spec["per_layer"].append({"name": "calls_per_window", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "whole step", "moves": "step_ms",
                              "workloads": ["heat3d-make-short"]})
    (root / "fieldbench" / "metrics" / "calls_per_window.py").write_text(
        "def read(run):\n    return run['work']['calls']\n")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cfg = json.loads((HERE / "configs" / "heat3d.json").read_text())
    cfg.update(nx=10, ny=10, nz=8)
    out = harness.run_cell("heat3d-make-short", 5, 0.2, True, device="cpu",
                           root=root, cfg=cfg)
    assert out["metrics"]["calls_per_window"]["value"] >= 1
    assert out["correct"]
