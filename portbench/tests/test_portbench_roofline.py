"""The work counts against hand-worked values."""

import numpy as np
import pytest

from portbench import roofline

HBM, FP32 = 3.35e12, 67e12


def test_peaks_are_the_h100_sxm_data_sheets():
    assert roofline.HBM_BYTES_PER_S == HBM and roofline.FP32_FLOPS == FP32


def test_inside_voxels_of_simple_matrices():
    shape = (4, 5, 6)
    assert roofline.inside_voxels(shape, np.eye(4)) == 120
    shift = np.eye(4, dtype=np.float32)
    shift[2, 3] = 2.5           # x + 2.5 lies in [0, 5] for x <= 2
    assert roofline.inside_voxels(shape, shift) == 4 * 5 * 3
    # 'border' keeps points more than half a voxel inside: x + 2.5 < 5.5
    assert roofline.inside_voxels(shape, shift, mode="border") == 4 * 5 * 3
    shift[2, 3] = -0.25         # x - 0.25 >= 0 for x >= 1; > -0.5 for all
    assert roofline.inside_voxels(shape, shift) == 4 * 5 * 5
    assert roofline.inside_voxels(shape, shift, mode="border") == 120


@pytest.mark.parametrize("order,flops,bound", [(1, 52, "bytes"),
                                               (3, 231, "operations")])
def test_resample_launch(order, flops, bound):
    # 10^3 volume, 2 matrices: 600 and 1000 voxels inside
    ms, by = roofline.resample_launch_ms(order, (10,) * 3, (10,) * 3,
                                         [600, 1000])
    n_bytes = 4 * (1000 + 2 * 1000)
    ops = flops * 1600 + 18 * 400
    assert ms == pytest.approx(max(n_bytes / HBM, ops / FP32) * 1e3)
    assert by == bound
    assert roofline.FLOPS_INSIDE[order] == flops


def test_backproject_launch():
    # 41 projections of 512^2 into (256, 512, 512), row-gather
    ms, by = roofline.backproject_launch_ms(41, (256, 512, 512), (512, 512),
                                            True)
    assert by == "operations"
    assert ms == pytest.approx(4 * 41 * 256 * 512 * 512 / FP32 * 1e3)
    ms, by = roofline.backproject_launch_ms(1, (2, 2, 2), (2, 2), False)
    assert by == "bytes"
    assert ms == pytest.approx(4 * (8 + 4) / HBM * 1e3)
