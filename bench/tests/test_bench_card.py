"""The harness refuses to measure without a card, and without the
program beside it: a non-zero exit and no result line."""
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _run(cwd: pathlib.Path, env=None):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "internlm2-allreduce-healthy", "--seed", "4294967311", "--seconds",
         "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def _no_result(proc):
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run(ROOT, env)
    _no_result(proc)
    assert "CUDA card" in proc.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(_run(tmp_path))
