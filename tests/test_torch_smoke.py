"""The host-side helpers of ``chip_smoke.py`` that read a profile, on
synthetic device events, and the script's refusal to run without a card."""

import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

import chip_smoke


def _event(name, start, end, stream=7):
    """A device event as chip_smoke reads it from torch.profiler: times in
    microseconds."""
    return SimpleNamespace(name=name, device_resource_id=stream,
                           time_range=SimpleNamespace(start=start, end=end))


@pytest.mark.parametrize("spans,busy", [
    ([(0, 10), (20, 30)], 20),              # apart
    ([(0, 10), (10, 30)], 30),              # touching
    ([(0, 10), (5, 30)], 30),               # partly over each other
    ([(0, 100), (10, 20), (30, 40)], 100),  # inside a longer one
    ([(30, 40), (0, 10), (5, 35)], 40),     # out of order, chained
])
def test_busy_ms_is_the_union_of_spans(spans, busy):
    events = [_event(f"k{i}", s, e) for i, (s, e) in enumerate(spans)]
    assert chip_smoke.busy_ms(events) == pytest.approx(busy / 1e3)


def test_overlaps_name_the_overlapping_pairs():
    """The overlapped time, by (earlier, later) kernel, adds up to the sum
    of durations less the busy time where no three events meet."""
    events = [_event("a", 0, 10), _event("b", 8, 20, stream=9),
              _event("a", 30, 40), _event("b", 35, 50, stream=9),
              _event("c", 60, 70)]
    streams, pairs = chip_smoke.overlaps(events)
    assert streams == [7, 9]
    assert pairs == [(("a", "b"), [pytest.approx(7e-3), 2])]
    device_ms = sum(e.time_range.end - e.time_range.start
                    for e in events) / 1e3
    assert device_ms - chip_smoke.busy_ms(events) == pytest.approx(7e-3)


def test_refuses_without_a_card(tmp_path):
    """Alone in a directory and without CUDA, the script exits non-zero
    and prints no result line."""
    shutil.copy(chip_smoke.__file__, tmp_path / "chip_smoke.py")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
    assert "FAILED" in run.stderr


def test_tensor_core_check_counts_tf32_mmas(tmp_path):
    """The SASS check counts the tensor-core MMAs whose operands are TF32
    (mma.sync's HMMA and Hopper's warpgroup HGMMA), and nothing else: no
    half-precision MMA, no f32 FMA."""
    sass = ("        /*0a10*/  HGMMA.64x64x8.F32.TF32 R24, gdesc[UR4], R24 ;\n"
            "        /*0a20*/  HGMMA.64x64x8.F32.TF32 R24, gdesc[UR8], R24 ;\n"
            "        /*0b00*/  HMMA.1688.F32.TF32 R4, R8, R12, R4 ;\n"
            "        /*0c00*/  HMMA.16816.F32 R4, R8, R12, R4 ;\n"
            "        /*0d00*/  FFMA R1, R2, R3, R1 ;\n")
    tool = tmp_path / "cuobjdump"
    tool.write_text(f"#!/bin/sh\ncat <<'SASS'\n{sass}SASS\n")
    tool.chmod(0o755)
    assert chip_smoke.tensor_core_tf32_ops(str(tool), "lib.so") == {
        "HGMMA.64x64x8.F32.TF32": 2, "HMMA.1688.F32.TF32": 1}


@pytest.mark.parametrize("flops,nbytes,peak,ms,by", [
    (37.68e9, 20e6, chip_smoke.TF32X3_FLOPS, 0.22836, "operations"),
    (37.68e9, 20e6, chip_smoke.F32_FLOPS, 0.56239, "operations"),
    (1e6, 20e6, chip_smoke.TF32X3_FLOPS, 0.00597, "bytes"),
])
def test_bound_takes_the_rate_of_the_arithmetic(flops, nbytes, peak, ms, by):
    """The conv tile's rows are bound at a third of the TF32 rate (3xTF32),
    the other kernels at the f32 SIMT rate; bytes over HBM either way."""
    got_ms, got_by = chip_smoke.bound(flops, nbytes, peak=peak)
    assert got_ms == pytest.approx(ms, rel=1e-4)
    assert got_by == by


@pytest.mark.parametrize("row,tol,patience,want", [
    ([0.2, 0.05, 0.05, 0.2], 0.1, 2, 4),     # converges on the third
    ([0.2, 0.2, 0.2, 0.2], 0.1, 2, 5),       # never: every iteration
    ([0.05, 0.2, 0.05, 0.05], 0.1, 2, 5),    # a reset, then the fourth
    ([0.05, 0.2, 0.2, 0.2], 0.1, 1, 2),      # patience 1: the first
])
def test_exit_iters_follows_the_early_exit_rule(row, tol, patience, want):
    """iters_used from a plain run's update norms (iters = len(row) + 1):
    consec resets on a norm not below tol, used ticks while not done, done
    at patience, plus the final mask-computing iteration."""
    assert chip_smoke.exit_iters([row], tol, patience) == [want]
