"""BENCHMARK.json and the files it names; a cell, a mix and a metric
added by dropping in files; the work counts; no card, no run."""

import ast
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from asr_bench import core, work

ROOT = core.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_names_its_files():
    b = core.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["asr_bench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        core.cell_files(w["name"], b)
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert hasattr(core.reader(m["name"]), "read")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
    for w in b["workloads"]:
        got = core.metrics_of(b, w["name"], False)
        assert "setup_s" in {m["name"] for m in got} and len(got) >= 2
        assert core.metrics_of(b, w["name"], True)


def _digests(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            if "__pycache__" in d:
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha1(
                    fh.read()).hexdigest()
    return out


def test_cell_mix_and_metric_added_by_files(tmp_path):
    # a copy of the benchmark, then new files only and new entries
    shutil.copytree(os.path.join(ROOT, "asr_bench"), tmp_path / "asr_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    before = _digests(tmp_path / "asr_bench")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    mix = json.loads((tmp_path / "asr_bench/traffic/train_k4.json")
                     .read_text())
    mix["steps_per_dispatch"] = 2
    (tmp_path / "asr_bench/traffic/train_k2.json").write_text(
        json.dumps(mix))
    (tmp_path / "asr_bench/limits/aishell_vgg.train_k2.json").write_text(
        (tmp_path / "asr_bench/limits/aishell_vgg.train_k4.json")
        .read_text())
    (tmp_path / "asr_bench/metrics/steps_per_s.train.py").write_text(
        "def read(rec):\n    return rec['steps'] / rec['window_s']\n")
    b["workloads"].append({"name": "aishell_vgg.train_k2",
                           "config": "aishell_vgg", "traffic": "train_k2",
                           "chips": 1, "why": "two steps a dispatch"})
    b["per_layer"].append({"name": "steps_per_s.train", "unit": "1/s",
                           "better": "higher", "source": "host_clock",
                           "layer": "device", "moves": "train_utt_per_s",
                           "workloads": ["aishell_vgg.train_k2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = (
        "import sys; sys.path.insert(0, '.');"
        "from asr_bench import core; b = core.benchmark();"
        "c, cfg, tr, lim = core.cell_files('aishell_vgg.train_k2', b);"
        "assert tr['steps_per_dispatch'] == 2;"
        "ms = [m['name'] for m in core.metrics_of(b, c['name'], True)];"
        "assert ms == ['steps_per_s.train'], ms;"
        "print(core.reader(ms[0]).read({'steps': 8, 'window_s': 2.0}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "4.0"
    after = _digests(tmp_path / "asr_bench")
    assert all(after[k] == v for k, v in before.items())


def test_work_counts_reproduce_the_kernel_bounds():
    # the kernel table's bounds at the train shapes (B 12, F 161, T 800)
    v = work.vgg_block1(12, 161, 800)
    assert round(v["fwd_flop"] / 1e9, 1) == 115.0
    assert round(v["bwd_flop"] / 1e9, 1) == 230.8
    a = work.attention_bwd(12, 8, 200, 200, 64)
    assert round(a["bytes"] / 1e6, 1) == 21.7
    b = core.benchmark()
    cfg = json.load(open(os.path.join(ROOT, b["configs"][0]["file"])))
    step = work.train_step_flops(cfg, 4364, [(800, 21)] * 12)
    assert 0.9e12 < step < 1.3e12


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    refdir = os.path.join(ROOT, "asr_bench", "reference")
    for f in os.listdir(refdir):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(refdir,
                                                                   f))}
            assert not tops & {"jax", "jaxlib", "flax", "end2end_asr_tpu",
                               core.PROGRAM}, (f, tops)


def test_chip_path_loads_no_jax():
    # every module a run and the reference load, the program's included;
    # top-level names compared whole (the port's name starts with the
    # JAX package's)
    code = (
        "import sys; sys.path.insert(0, '.');"
        "import asr_bench.run, asr_bench.calibrate;"
        "from asr_bench.kinds import train;"
        "import end2end_asr_tpu_torch.training.steps,"
        " end2end_asr_tpu_torch.data.loader;"
        "from asr_bench import core;"
        "[core.reader(m['name']) for k in ('end_to_end', 'per_layer')"
        " for m in core.benchmark()[k]];"
        "print(core.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert core.forbidden_modules.__module__ == "asr_bench.core"
    assert {"end2end_asr_tpu_torch"} & set(core.FORBIDDEN) == set()


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "asr_bench/run.py", "--workload",
         "aishell_vgg.train_k4", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_no_card_no_result():
    # this machine has no CUDA device: the run fails, prints nothing
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_does_not_run(tmp_path):
    shutil.copytree(os.path.join(ROOT, "asr_bench"), tmp_path / "asr_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    out = _run(tmp_path, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
