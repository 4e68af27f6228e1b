"""bench.py's device peak table: known kinds only."""

import pytest

import bench


def test_h100_peaks_are_the_data_sheet_values():
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["hbm_gbps"] == 3350.0 and peaks["bf16_tflops"] == 989.0


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_unknown_device_kind_is_an_error(kind):
    with pytest.raises(KeyError):
        bench.device_peaks(kind)
