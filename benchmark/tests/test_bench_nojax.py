"""Nothing the harness or the reference loads is JAX or the JAX package,
compared by whole top-level names; the reference loads nothing of the
program."""

import ast
import subprocess
import sys

from bench_helpers import ROOT

HARNESS = ["benchmark.run", "benchmark.check", "benchmark.control", "benchmark.data",
           "benchmark.prepare", "benchmark.trace", "benchmark.manifest", "benchmark.context",
           "benchmark.work.k7", "benchmark.work.k2", "benchmark.work.k9",
           "benchmark.work.peaks"]
REFERENCE = ["benchmark.reference.harmony", "benchmark.reference.draws",
             "benchmark.reference.ingest"]
# what a run imports from the port
PORT = ["harmony_tpu_torch", "harmony_tpu_torch.api", "harmony_tpu_torch.engine",
        "harmony_tpu_torch.driver", "harmony_tpu_torch.state", "harmony_tpu_torch.runtime",
        "harmony_tpu_torch.preprocess", "harmony_tpu_torch.config"]


def _loaded_tops(modules, extra=""):
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            + "".join(f"import {m}\n" for m in modules) + extra
            + "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_harness_and_port_load_no_jax():
    readers = ("from benchmark import manifest\n"
               "[manifest.metric_reader(p['name']) for p in manifest.load()['per_layer']]\n")
    tops = _loaded_tops(HARNESS + REFERENCE + PORT, readers)
    assert "harmony_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "harmony_tpu"}, tops


def test_reference_loads_nothing_of_the_program():
    tops = _loaded_tops(REFERENCE)
    assert not tops & {"jax", "jaxlib", "flax", "harmony_tpu", "harmony_tpu_torch"}, tops
    for f in (ROOT / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert all(n.split(".")[0] in ("torch", "numpy", "contextlib", "math",
                                           "typing", "__future__") for n in names), (f, names)


def test_forbidden_names_are_compared_whole():
    from benchmark.run import forbidden_modules

    mods = {"harmony_tpu_torch": 1, "harmony_tpu_torch.ops": 1, "jax_helper": 1,
            "jaxlib.xla": 1, "harmony_tpu.api": 1, "flaxen": 1}
    assert forbidden_modules(mods) == ["harmony_tpu", "jaxlib"]
    assert forbidden_modules({"harmony_tpu_torch": 1, "numpy": 1}) == []


def test_no_card_no_result(tmp_path):
    """Without a card the run exits non-zero and prints no result; so does
    a checkout that holds only BENCHMARK.json and the benchmark."""
    import shutil

    cmd = [sys.executable, "benchmark/run.py", "--workload", "hca-500k.rotate", "--seed",
           "3000000001", "--seconds", "1", "--trace", "0"]
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=str(ROOT),
                         env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
                         env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
