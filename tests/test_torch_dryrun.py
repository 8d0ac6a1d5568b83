"""The port's dry-run (``python -m repro_torch.launch.dryrun``) on
``meta`` under a fake world of 256 or 512 ranks, each combo in its own
process (a process group is global to its process): the reference's
``COMBOS`` of ``tests/test_dryrun_smoke.py``, the skip marker, and the
refusal to run on the CPU by default."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")


def _dryrun(*args, tmp):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--out", str(tmp)], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=SRC,
                           CUDA_VISIBLE_DEVICES=""))
    return r


@pytest.mark.parametrize("arch,shape,multi_pod", [
    ("granite-moe-1b-a400m", "train_4k", False),
    ("smollm-360m", "decode_32k", True),
])
def test_dryrun_on_meta_writes_a_valid_report(arch, shape, multi_pod,
                                              tmp_path):
    args = ["--device", "meta", "--arch", arch, "--shape", shape]
    r = _dryrun(*args + (["--multi-pod"] if multi_pod else []),
                tmp=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    mesh = "pod2x16x16" if multi_pod else "pod16x16"
    res = json.loads((tmp_path / f"{arch}__{shape}__{mesh}.json").read_text())
    assert res["status"] == "ok" and res["mesh"] == mesh
    assert res["n_devices"] == (512 if multi_pod else 256)
    rf = res["roofline"]
    assert rf["flops_per_chip"] > 0 and rf["hbm_bytes_per_chip"] > 0
    assert rf["bottleneck"] in ("compute", "memory", "collective")
    assert 0 < res["useful_flops_ratio"] <= 1
    assert res["memory_analysis"]["argument_bytes"] > 0
    assert res["memory_analysis"]["peak_estimate_bytes"] is None
    assert res["collective_ops"] == rf["collective_op_count"] > 0
    if shape == "train_4k":
        assert res["microbatches"] == 2
    else:
        assert res["serve_tp_only"] is True
    assert f"[dryrun] {arch} x {shape} x {mesh}: OK" in r.stdout


def test_dryrun_writes_the_skip_marker(tmp_path):
    r = _dryrun("--device", "meta", "--arch", "whisper-medium", "--shape",
                "long_500k", tmp=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads((tmp_path / "whisper-medium__long_500k__pod16x16.json"
                      ).read_text())
    assert res["status"] == "skipped" and "encoder-decoder" in res["reason"]


def test_dryrun_without_a_card_or_device_is_an_error(tmp_path):
    r = _dryrun("--arch", "smollm-360m", "--shape", "decode_32k",
                tmp=tmp_path)
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr
    assert not list(tmp_path.glob("*.json"))
