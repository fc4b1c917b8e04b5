"""Source scan: nothing in the program needs or branches on a TPU."""

import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SOURCES = sorted(
    p for p in REPO.rglob("*.py")
    if not any(part.startswith(".") for part in p.relative_to(REPO).parts)
    and p.relative_to(REPO).parts[0] != "chiprun_out"
)


def _code(path: Path) -> str:
    return path.read_text(encoding="utf-8")


def test_sources_found():
    names = {p.relative_to(REPO).as_posix() for p in SOURCES}
    assert "chip_smoke.py" in names and "radio_mapper_tpu/models/pipeline.py" in names


def test_no_mosaic_tpu_imports():
    pat = re.compile(r"pallas(\.|\s+import\s+)tpu|pltpu|libtpu")
    hits = [p.name for p in SOURCES if p.name != Path(__file__).name and pat.search(_code(p))]
    assert hits == []


def test_no_platform_comparison_with_tpu():
    pat = re.compile(r"""(platform|default_backend\(\))\s*[!=]=\s*["']tpu["']|["']tpu["']\s*[!=]=""")
    hits = [p.name for p in SOURCES if p.name != Path(__file__).name and pat.search(_code(p))]
    assert hits == []


def test_no_interpret_mode_defaults():
    pat = re.compile(r"\binterpret\s*=")
    hits = [p.name for p in SOURCES if p.name != Path(__file__).name and pat.search(_code(p))]
    assert hits == []


@pytest.mark.parametrize(
    "module, gone",
    [
        ("radio_mapper_tpu.ops.split_complex", "set_gcc_fused"),
        ("radio_mapper_tpu.ops.split_complex", "gcc_phat_all_pairs_split_fused"),
        ("radio_mapper_tpu.ops.detect", "set_fused_detect"),
        ("radio_mapper_tpu.ops.detect", "detect_peaks_ct"),
        ("radio_mapper_tpu.ops.safe", "pair_select"),
        ("radio_mapper_tpu.utils.device", "force_fetch"),
    ],
)
def test_removed_routing_knobs_stay_removed(module, gone):
    import importlib

    assert not hasattr(importlib.import_module(module), gone)


def test_pallas_package_removed():
    assert not (REPO / "radio_mapper_tpu" / "ops" / "pallas").exists()
