"""`tools/cta_clocks.py` on the CPU: its stamp tables read into phase cycles,
its libraries are built apart from the main path's, and the command needs a
card (the stamps themselves run only there)."""
import numpy as np
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
