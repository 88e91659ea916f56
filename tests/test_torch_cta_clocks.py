"""`tools/cta_clocks.py` on the CPU: its stamp tables read into phase cycles,
its libraries are built apart from the main path's, and the command needs a
card (the stamps themselves run only there)."""
import numpy as np
import pytest
import torch

from slamkit_tpu_torch.ops import _build
from slamkit_tpu_torch.ops.flash_attention import KERNEL_BWD, KERNEL_BWD_F32, KERNEL_F32
from slamkit_tpu_torch.tools import cta_clocks

torch.set_num_threads(1)


def test_summarize_reads_phases_from_the_stamps():
    # entry, listed, first tile, loop end, end; tiles visited
    rows = np.array([[100, 150, 400, 1400, 1500, 4],
                     [0, 0, 0, 0, 0, 0],               # a CTA of the grid that never ran
                     [10, 30, 100, 600, 620, 2],
                     [5, 25, 25, 25, 40, 0]])          # a CTA with no tile to visit
    s = cta_clocks.summarize(rows)
    assert s["ctas"] == 3
    assert s["list"] == {"median": 20.0, "mean": 30.0}
    assert s["first"]["median"] == 70.0 and s["loop"]["median"] == 500.0
    assert s["loop_per_tile"] == {"median": 250.0, "mean": 250.0}    # 1000 / 4, 500 / 2
    assert s["tail"]["median"] == 20.0 and s["total"]["median"] == 610.0
    assert s["tiles_per_cta"]["mean"] == 2.0


def test_stamped_libraries_are_apart_from_the_main_path():
    for name in (KERNEL_F32, KERNEL_BWD_F32, KERNEL_BWD):
        main = _build.library_path(name)
        stamped = _build.library_path(name, cta_clocks.DEFINES)
        assert main != stamped and main.parent != stamped.parent
        assert stamped.name == f"lib{name}_slamkit_cta_clocks.so"
        assert "SLAMKIT_CTA_CLOCKS" not in " ".join(_build.NVCC_FLAGS)
    text = (_build.CSRC / "hopper.cuh").read_text()
    assert "#ifdef SLAMKIT_CTA_CLOCKS" in text
    assert "#define CTA_STAMP(slot, mark) ((void)0)" in text    # compiled out by default


def test_the_command_needs_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cta_clocks.main([]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err


def test_d256_section_stamps_the_d256_backward():
    """The bf16 d = 256 dK / dV pass has a section of its own (pythia-1b's
    SIMS batch and the d256 row), on the stamped bf16 backward library, with
    a stamp slot for every CTA the launch can have (8 a kv group and key
    tile at most); the command refuses a section it does not know."""
    cases, backward, bf16 = cta_clocks.SECTIONS["backward_bf16_d256"]
    assert backward and bf16
    assert {name: shape for name, shape, _ in cases} == {
        "pythia1b_sims": (8, 8, 8, 2048, 256), "d256": (4, 8, 2, 1024, 256)}
    for name, shape, make_seg in cases:
        b, _, hkv, t, _ = shape
        assert make_seg(np.random.default_rng(5)).shape == (b, t)
        assert cta_clocks._grid_ctas(shape, True, bf16=True) == {"dkdv": 8 * hkv * b * t // 64}
    text = (_build.CSRC / "flash_bwd.cu").read_text()
    body = text[text.index("flash_bwd_dkdv256_kernel("):]
    for mark in ("kMarkEntry", "kMarkListed", "kMarkFirstTile", "kMarkLoopEnd", "kMarkEnd"):
        assert f"CTA_STAMP(0, {mark})" in body, mark
    with pytest.raises(SystemExit):
        cta_clocks.main(["--sections", "backward_bf16_d512"])
